"""The port's semi-supervised step against the benchmark's plain reference
(``benchmark/reference``: plain PyTorch written from the published
description, importing nothing of the port), on the CPU.

A tiny ``whatevernet`` (topology [8, 16], 2 S1 + 4 S2 bands, the
published ``siamese_mmcr_alpha0500_16batch`` settings otherwise) takes
three AdamW steps of :func:`train_lib.make_semisupervised_train_step` in
float32; the reference takes the same three steps in float64
(``run_steps(regime="semisupervised")``, as the benchmark's judge runs it)
from the same weights, batches and augmentation seed. Batches of 4 rows of
32² crops: mixed, all labeled and all unlabeled, the unlabeled rows' label
planes zero as the loader makes them. Compared, each against a tolerance
given at its constant:

* each step's loss;
* the first step's gradient, per leaf whose reference gradient counts
  (:func:`benchmark.reference.judge.moved_leaves`);
* BatchNorm's running means after the first step, per layer;
* every moved leaf after the third step.

The case with the consistency term left out of the port's loss must fail
the comparison on every batch that holds an unlabeled row.
"""

import numpy as np
import pytest
import torch

from benchmark.reference import judge, models
from benchmark.reference import train as ref_train
from multimodal_siamese_cd_tpu_torch import train_lib
from multimodal_siamese_cd_tpu_torch.config import load_cfg
from multimodal_siamese_cd_tpu_torch.models.factory import create_network

SPEC = {"type": "whatevernet", "topology": [8, 16], "in_channels": 6, "n_s1_bands": 2,
        "n_s2_bands": 4}
SEED = 2 ** 31 + 19
ROWS, SIDE, STEPS = 4, 32, 3
BATCHES = {"mixed": [[1, 0, 1, 1], [0, 1, 1, 0], [1, 1, 0, 1]],
           "labeled": [[1, 1, 1, 1]] * STEPS,
           "unlabeled": [[0, 0, 0, 0]] * STEPS}

# float32 sums over 4 x 32² pixels against float64 ones: 8e-8 to 7e-7 seen
LOSS_RTOL = 1e-5
# a leaf's gradient, the norm of the difference over the larger of its
# norm and the median leaf's: float32 backward through 8 BatchNorms of
# small batches against float64, 2e-6 to 7e-6 seen
GRAD_TOL = 1e-4
# a layer's running mean after step 1, the norm of the difference over the
# larger of its change and the median layer's: one float32 reduction,
# 1.3e-7 seen
STATS_TOL = 1e-5
# a moved leaf after step 3, the norm of the difference over the norm of
# its change: AdamW's first steps are ~lr a coordinate whatever the
# gradient's size, so a coordinate whose gradient is near 0 may step the
# other way in float32; 1e-3 to 3e-3 seen
PARAM_TOL = 2e-2


def _cfg():
    cfg = load_cfg("siamese_mmcr_alpha0500_16batch")
    cfg.merge_from_list(["MODEL.TOPOLOGY", [8, 16], "TRAINER.PRECISION", "fp32",
                         "TRAINER.BATCH_SIZE", ROWS, "SEED", SEED])
    return cfg


def _batches(kind: str) -> tuple:
    g = torch.Generator().manual_seed(7)
    stacks, labs = [], []
    for flags in BATCHES[kind]:
        lab = torch.tensor(flags, dtype=torch.float32)
        img = torch.rand((ROWS, 12, SIDE, SIDE), generator=g)
        change = (torch.rand((ROWS, 1, SIDE, SIDE), generator=g) > 0.7).float()
        labels = torch.cat([torch.zeros(ROWS, 2, SIDE, SIDE), change], 1)
        stacks.append(torch.cat([img, labels * lab.view(-1, 1, 1, 1)], 1))
        labs.append(lab)
    return stacks, labs


def _port_steps(cfg, stacks, labs):
    model = create_network(cfg, device="cpu", generator=torch.Generator().manual_seed(3))
    start = {k: v.detach().clone() for k, v in model.state_dict().items()}
    step = train_lib.make_train_step(model, train_lib.make_optimizer(model, cfg), cfg,
                                     "semisupervised")
    out = {"loss": []}
    for i, (stack, lab) in enumerate(zip(stacks, labs)):
        out["loss"].append(float(step(stack, lab, i)["loss"]))
        if i == 0:
            out["grad"] = {n: p.grad.detach().clone() for n, p in model.named_parameters()}
            out["stats"] = judge.stats_change(model, start)
    out["params"] = {n: p.detach().clone() for n, p in model.named_parameters()}
    return start, out


def _reference_steps(cfg, start, stacks, labs):
    net = models.build(SPEC).double()
    net.load_state_dict({k: v.double() if v.is_floating_point() else v
                         for k, v in start.items()})
    conf = {**SPEC, "regime": "semisupervised", "lr": cfg.TRAINER.LR, "flip": True,
            "rotate": True, "alpha": float(cfg.CONSISTENCY_TRAINER.LOSS_FACTOR)}
    return ref_train.run_steps(net, [s.double() for s in stacks], labs, conf, SEED)


def _relative(a: torch.Tensor, b: torch.Tensor, scale: float) -> float:
    return float((a.double() - b.double()).norm()) / max(scale, 1e-30)


def _compare(port: dict, ref: dict, start: dict) -> None:
    """Raises AssertionError where the port departs from the reference."""
    np.testing.assert_allclose(port["loss"], ref["loss"], rtol=LOSS_RTOL)
    moved = judge.moved_leaves(ref["grad_norms"])
    median = float(np.median([float(ref["grad"][k].norm()) for k in moved["first"]]))
    for k in moved["first"]:
        gap = _relative(port["grad"][k], ref["grad"][k],
                        max(float(ref["grad"][k].norm()), median))
        assert gap <= GRAD_TOL, (k, gap)
    changes = {k: float(v.norm()) for k, v in ref["stats"].items()}
    median = float(np.median(list(changes.values())))
    for k, change in ref["stats"].items():
        gap = _relative(port["stats"][k], change, max(changes[k], median))
        assert gap <= STATS_TOL, (k, gap)
    for k in moved["any"]:
        change = ref["params"][k] - start[k].double()
        gap = _relative(port["params"][k], ref["params"][k], float(change.norm()))
        assert gap <= PARAM_TOL, (k, gap)


@pytest.mark.parametrize("consistency", ["kept", "dropped"])
@pytest.mark.parametrize("kind", sorted(BATCHES))
def test_semisupervised_steps_match_the_plain_reference(kind, consistency, monkeypatch):
    if consistency == "dropped":
        make_step = train_lib._make_step

        def without_consistency(model, optimizer, cfg, losses_of):
            def losses(*args):
                metrics = losses_of(*args)
                return {**metrics, "loss": metrics["sup_loss"]}
            return make_step(model, optimizer, cfg, losses)

        monkeypatch.setattr(train_lib, "_make_step", without_consistency)
    torch.manual_seed(0)
    cfg = _cfg()
    stacks, labs = _batches(kind)
    start, port = _port_steps(cfg, stacks, labs)
    ref = _reference_steps(cfg, start, stacks, labs)
    if consistency == "dropped" and any(float(lab.min()) == 0 for lab in labs):
        with pytest.raises(AssertionError):
            _compare(port, ref, start)
    else:
        _compare(port, ref, start)
