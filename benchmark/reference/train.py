"""The reference's training steps: the config's augmentation (random flips,
then a rot90 by k in {1, 2, 3}), the model in train mode (BatchNorm over
the batch), the published losses, and AdamW (lr from the config, betas
0.9 / 0.999, eps 1e-8, weight decay 0.01 on every parameter), all in
float32 with TF32 off.

The augmentation's decisions are drawn as the published trainer draws
them: a ``torch.Generator`` on the step's device seeded from
``SeedSequence([seed, step])``, two uniform rows for the flips, then the
rotations. The generator's stream is the only thing the reference shares
with the program's code; everything it draws is applied here again.
"""

from __future__ import annotations

import numpy as np
import torch

from . import judge

EPS = 1e-6


def power_jaccard(logits, target, mask=None):
    """``1 - Σpt / (Σp² + Σt² - Σpt + 1e-6)`` over the selected rows,
    ``p = sigmoid(logits)``."""
    p = torch.sigmoid(logits)
    t = target
    if mask is not None:
        m = mask.reshape(-1, 1, 1, 1)
        p, t = p * m, t * m
    inter = (p * t).sum()
    return 1.0 - inter / ((p * p).sum() + (t * t).sum() - inter + EPS)


def generator(seed: int, step: int, device) -> torch.Generator:
    state = np.random.SeedSequence([seed, step]).generate_state(2, np.uint32)
    g = torch.Generator(device=device)
    g.manual_seed(int(state[0]) << 32 | int(state[1]))
    return g


def augment(stack: torch.Tensor, seed: int, step: int, flip: bool, rotate: bool):
    """``stack`` (B, C, S, S) with step ``step``'s flips and rotations."""
    b = stack.shape[0]
    g = generator(seed, step, stack.device)
    x = stack
    if flip:
        hv = torch.rand((2, b), generator=g, device=stack.device) < 0.5
        for i in range(b):
            if hv[0, i]:
                x = torch.cat([x[:i], x[i:i + 1].flip(3), x[i + 1:]])
            if hv[1, i]:
                x = torch.cat([x[:i], x[i:i + 1].flip(2), x[i + 1:]])
    if rotate:
        k = torch.randint(1, 4, (b,), generator=g, device=stack.device)
        # counter-clockwise by k quarter turns in the (H, W) plane
        x = torch.stack([torch.rot90(x[i], int(k[i]), dims=(1, 2)) for i in range(b)])
    return x.contiguous()


def losses(regime: str, outputs, y_change, is_labeled, alpha: float):
    """The step's loss: the supervised criterion, or the semi-supervised
    ``has_lab · α(fusion + s1 + s2)/3 + has_unlab · (1-α) · cons`` with the
    consistency between stream 1's logits and stream 2's probabilities on
    the unlabeled rows."""
    if regime == "supervised":
        return power_jaccard(outputs, y_change)
    fusion, s1, s2 = outputs
    lab = is_labeled.float()
    unlab = 1.0 - lab
    sup = alpha * (power_jaccard(fusion, y_change, lab) + power_jaccard(s1, y_change, lab)
                   + power_jaccard(s2, y_change, lab)) / 3.0
    cons = (1.0 - alpha) * power_jaccard(s1, torch.sigmoid(s2), unlab)
    return lab.max() * sup + unlab.max() * cons


def run_steps(net, batches: list, is_labeled: list, cfg: dict, seed: int,
              first_step: int = 0) -> dict:
    """AdamW steps of ``net`` (on the device, in its dtype) over ``batches``
    (each (B, C, S, S) stacks in the published channel order) from global
    step ``first_step``. Returns each step's loss, the first step's
    gradient per parameter name, every step's gradient norms, the change
    of BatchNorm's running means in the first step, and the parameters
    after the last step."""
    n1, n2 = cfg["n_s1_bands"], cfg["n_s2_bands"]
    n_img = 2 * (n1 + n2)
    names = [n for n, _ in net.named_parameters()]
    opt = torch.optim.AdamW(net.parameters(), lr=cfg["lr"], betas=(0.9, 0.999),
                            eps=1e-8, weight_decay=0.01, foreach=False)
    out = {"loss": [], "grad": None, "grad_norms": [], "stats": None}
    start = {n: b.detach().clone() for n, b in net.named_buffers()}
    dtype = next(net.parameters()).dtype
    net.train()
    for i, (stack, lab) in enumerate(zip(batches, is_labeled)):
        x = augment(stack.to(dtype), seed, first_step + i, cfg["flip"], cfg["rotate"])
        x1 = torch.cat([x[:, :n1], x[:, 2 * n1:2 * n1 + n2]], dim=1)
        x2 = torch.cat([x[:, n1:2 * n1], x[:, 2 * n1 + n2:n_img]], dim=1)
        y = x[:, n_img + 2:n_img + 3]
        opt.zero_grad(set_to_none=True)
        loss = losses(cfg["regime"], net(x1, x2), y, lab.to(dtype), cfg["alpha"])
        loss.backward()
        for p in net.parameters():
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if i == 0:
            out["grad"] = {n: p.grad.detach().clone() for n, p in zip(names, net.parameters())}
        out["grad_norms"].append({n: float(p.grad.double().norm())
                                  for n, p in zip(names, net.parameters())})
        opt.step()
        out["loss"].append(float(loss.detach()))
        if i == 0:
            out["stats"] = judge.stats_change(net, start)
    out["params"] = {n: p.detach().clone() for n, p in zip(names, net.parameters())}
    return out
