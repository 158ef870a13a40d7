"""Segmented timing of the flagship training step (the JAX package's
``tools/ablate_step.py``).

    python -m multimodal_siamese_cd_tpu_torch.ablate_step [--batch-sizes 8,32]

For ``siameseunet`` (the base config: full width, 256^2 crops, bf16) at each
batch size, K steps (``--k``, 10) of four nested segments: the augmentation;
augmentation + forward; augmentation + forward + backward; the full step
with AdamW. Each segment's time is the best of 4 calls after a warm one,
each closed by a synchronisation, divided by K. Read the differences:
forward = (aug+fwd) - aug, backward = (aug+fwd+bwd) - (aug+fwd).

Every segment chains the augmentation, as the JAX tool does: iteration i
augments the output of iteration i - 1 (cast back to the wire's float32),
so no iteration repeats the last. The forward runs in train mode under
``torch.no_grad()``; the backward segment takes the loss's gradients (the
JAX tool also sums them, only so that XLA keeps them; eager PyTorch
computes them anyway). On the card the three segments run eagerly and the
full step runs as ``train_lib.make_scanned_train_step``'s CUDA graph of K
steps (the first call captures it), which the printed line says.
``--device cpu`` runs it on the CPU, for the tests; without it the module
needs the card and raises where there is none.
"""

from __future__ import annotations

import argparse
import itertools
import json
import sys
import time

import numpy as np
import torch

from . import losses, train_lib
from .bench import SEED
from .config import load_cfg
from .device import describe, resolve_device
from .models.factory import compute_dtype, create_network
from .trainers import sync


def timed(run, device: torch.device, n_calls: int = 4) -> float:
    """The best host seconds of ``n_calls`` calls of ``run()``, each closed
    by a synchronisation, after one warm call."""
    run()
    sync(device)
    best = np.inf
    for _ in range(n_calls):
        t0 = time.perf_counter()
        run()
        sync(device)
        best = min(best, time.perf_counter() - t0)
    return best


def segments(cfg, model, stack: torch.Tensor, k: int) -> dict:
    """The three chained segments of K iterations: ``{name: run}``."""
    device = stack.device
    dtype = compute_dtype(cfg) if device.type == "cuda" else torch.float32
    layout = train_lib.stack_layout(cfg)
    criterion = losses.get_criterion(cfg.MODEL.LOSS_TYPE)
    model.train()

    def augmented(s, i):
        generator = train_lib.augment_generator(cfg.SEED, i, device)
        a = train_lib.augment(s, cfg, layout, dtype, generator)
        return a, a.float()

    def run_aug():
        s = stack
        for i in range(k):
            _, s = augmented(s, i)
        return s

    def run_fwd():
        s, acc = stack, torch.zeros((), device=device)
        with torch.no_grad():
            for i in range(k):
                a, s = augmented(s, i)
                x1, x2, *_ = train_lib.split_stack(a, layout)
                with train_lib.autocast(dtype, device):
                    out = model(x1, x2)
                acc = acc + out.float().sum()
        return acc

    def run_grad():
        s, acc = stack, torch.zeros((), device=device)
        for i in range(k):
            a, s = augmented(s, i)
            x1, x2, y, *_ = train_lib.split_stack(a, layout)
            model.zero_grad(set_to_none=True)
            with train_lib.autocast(dtype, device):
                out = model(x1, x2)
            loss = criterion(out.float(), y)
            loss.backward()
            acc = acc + loss.detach()
        return acc

    return {"aug": run_aug, "aug+fwd": run_fwd, "aug+fwd+bwd": run_grad}


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--batch-sizes", default="8,32")
    p.add_argument("--k", type=int, default=10)
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card; 'cpu' for the "
                        "tests)")
    p.add_argument("opts", nargs="*", metavar="KEY VALUE", help="config overrides")
    return p


def main(argv=None) -> int:
    p = parser()
    args = p.parse_args(argv)
    if len(args.opts) % 2:
        p.error("overrides must come in KEY VALUE pairs")
    device = resolve_device(args.device)
    info = describe(device)
    k = args.k

    for bs in [int(b) for b in args.batch_sizes.split(",")]:
        cfg = load_cfg("base")
        cfg.MODEL.TYPE = "siameseunet"
        cfg.TRAINER.BATCH_SIZE = bs
        cfg.merge_from_list(args.opts)
        crop = cfg.AUGMENTATION.CROP_SIZE
        model = create_network(cfg, device=device,
                               generator=torch.Generator().manual_seed(SEED))
        host = np.random.default_rng(0)
        stack = torch.from_numpy(host.uniform(0, 1, (bs, 15, crop, crop))
                                 .astype(np.float32)).to(device)
        ms = {name: timed(run, device) / k * 1e3
              for name, run in segments(cfg, model, stack, k).items()}

        window = train_lib.make_scanned_train_step(
            model, train_lib.make_optimizer(model, cfg), cfg, "supervised")
        stacks = stack[None].expand(k, *stack.shape).contiguous()
        lab = torch.ones((k, bs), dtype=torch.float32, device=device)
        calls = itertools.count()
        ms["full"] = timed(lambda: window(stacks, lab, next(calls) * k), device) / k * 1e3
        print(f"batch {bs:3d}: aug={ms['aug']:6.2f}  aug+fwd={ms['aug+fwd']:6.2f}  "
              f"aug+fwd+bwd={ms['aug+fwd+bwd']:6.2f}  full={ms['full']:6.2f} ms/step  "
              f"({bs / ms['full'] * 1e3:6.1f} patches/s; segments eager, full "
              f"{window.mode})")
        print(json.dumps({"metric": "step_segments_ms", "batch": bs, "k": k,
                          "ms_per_step": ms, "patches_per_sec": bs / ms["full"] * 1e3,
                          "modes": {"segments": "eager", "full": window.mode},
                          "device": info}), flush=True)
        del model, window, stacks, stack
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
