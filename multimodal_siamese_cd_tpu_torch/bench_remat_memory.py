"""What ``MODEL.REMAT`` and ``TRAINER.GRAD_ACCUM`` save in device memory
(the JAX package's ``tools/bench_remat_memory.py``).

    python -m multimodal_siamese_cd_tpu_torch.bench_remat_memory [--crop 1024]

For each of plain, ``MODEL.REMAT``, ``TRAINER.GRAD_ACCUM --grad-accum`` and
both, at ``--crop`` (1024, where memory binds) and ``--batch`` (8), one
staged training step of the regime's headline model (the base config: full
width, bf16) on a float16 wire batch (the loader's production format) on
the card: the cached blocks are released (``torch.cuda.empty_cache()``) so
one mode's reserved pool does not count in the next, the peaks are reset,
the step runs and ends in a synchronisation. Where the JAX tool reads XLA's
compiled memory analysis, this module measures the peaks the step reached:
``torch.cuda.max_memory_allocated`` and ``max_memory_reserved``, in MiB,
beside the step's host milliseconds (its first step: AdamW's state is made
in it). A mode that runs out of memory is recorded as ``{"oom": true,
"error": ...}`` and the run moves on.

One JSON line per mode and a summary line of each mode's allocated peak over
the plain step's. ``--topology`` and ``--spatial-shards`` (the JAX tool's
compile against an unattached TPU mesh) have no meaning on one card and are
refused. ``--device cpu`` runs it on the CPU, for the tests, where the peaks
are not measured; without it the module needs the card and raises where
there is none.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import threading
import time

import numpy as np
import torch

from . import train_lib
from .bench import REGIME_MODELS, SEED, arm_watchdog
from .config import load_cfg
from .device import describe, resolve_device
from .models.factory import create_network
from .trainers import sync


def build_step(overrides: list, crop: int, batch: int, regime: str,
               device: torch.device) -> tuple:
    """``(model, step)`` of one mode."""
    cfg = load_cfg("base")
    cfg.MODEL.TYPE = REGIME_MODELS[regime]
    cfg.AUGMENTATION.CROP_SIZE = crop
    cfg.TRAINER.BATCH_SIZE = batch
    if regime == "semisupervised":
        cfg.DATALOADER.INCLUDE_UNLABELED = True
    cfg.merge_from_list([str(x) for x in overrides])
    model = create_network(cfg, device=device,
                           generator=torch.Generator().manual_seed(SEED))
    step = train_lib.make_train_step(model, train_lib.make_optimizer(model, cfg),
                                     cfg, regime)
    return model, step


def analyze(label: str, overrides: list, crop: int, batch: int, regime: str,
            device: torch.device) -> dict:
    """One staged step of one mode; prints and returns its record."""
    rec = {"label": label, "crop": crop, "batch": batch, "regime": regime,
           "device": describe(device)}
    cuda = device.type == "cuda"
    host = np.random.default_rng(0)
    stack = host.uniform(0, 1, (batch, 15, crop, crop)).astype(np.float16)
    stack[:, 12:] = (stack[:, 12:] > 0.8).astype(np.float16)
    model = step = staged = None
    try:
        model, step = build_step(overrides, crop, batch, regime, device)
        staged = torch.from_numpy(stack).to(device)
        lab = torch.ones((batch,), dtype=torch.float32, device=device)
        if cuda:
            torch.cuda.reset_peak_memory_stats(device)
        sync(device)
        t0 = time.perf_counter()
        metrics = step(staged, lab, 0)
        sync(device)
        rec["step_ms"] = (time.perf_counter() - t0) * 1e3
        rec["loss"] = float(metrics["loss"])
        if cuda:
            rec["max_allocated_mib"] = torch.cuda.max_memory_allocated(device) / 2**20
            rec["max_reserved_mib"] = torch.cuda.max_memory_reserved(device) / 2**20
        else:
            rec["max_allocated_mib"] = rec["max_reserved_mib"] = "not measured"
    except torch.cuda.OutOfMemoryError as e:
        # a mode the card cannot hold is the measurement: record it and go on
        rec.update(oom=True, error=" ".join(str(e).split())[:200])
    finally:
        del model, step, staged
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
    print(json.dumps(rec), flush=True)
    return rec


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--crop", type=int, default=1024,
                   help="oversized-input shape where memory binds")
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--grad-accum", type=int, default=4)
    p.add_argument("--regime", default="supervised", choices=list(REGIME_MODELS))
    p.add_argument("--topology", default=None, help=argparse.SUPPRESS)
    p.add_argument("--spatial-shards", type=int, default=1, help=argparse.SUPPRESS)
    p.add_argument("--wedge-timeout", type=float, default=600.0,
                   help="abort if the first mode has not finished within this "
                        "many seconds")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card; 'cpu' for the "
                        "tests)")
    p.add_argument("opts", nargs="*", metavar="KEY VALUE",
                   help="config overrides applied to every mode")
    return p


def main(argv=None) -> int:
    p = parser()
    args = p.parse_args(argv)
    if args.topology is not None or args.spatial_shards != 1:
        p.error("--topology and --spatial-shards compile against an unattached "
                "TPU mesh, which has no meaning on one card; the memory a rank "
                "holds when TRAINER.SPATIAL_SHARDS splits a 1024^2 crop is "
                "measured by chip_smoke.py phase 11b's grid run")
    if len(args.opts) % 2:
        p.error("overrides must come in KEY VALUE pairs")
    device = resolve_device(args.device)
    info = describe(device)
    print(f"# device={device} ({info['name']}, {info['power_limit']})",
          file=sys.stderr, flush=True)
    first = threading.Event()
    arm_watchdog(first, args.wedge_timeout, 2,
                 f"WEDGED: the first mode did not finish within "
                 f"{args.wedge_timeout:.0f}s; aborting",
                 {"metric": "remat_memory", "device": info})
    a = str(args.grad_accum)
    try:
        base = analyze("plain", args.opts, args.crop, args.batch, args.regime, device)
        first.set()
        others = [
            analyze("remat", args.opts + ["MODEL.REMAT", "True"],
                    args.crop, args.batch, args.regime, device),
            analyze(f"grad_accum_{a}", args.opts + ["TRAINER.GRAD_ACCUM", a],
                    args.crop, args.batch, args.regime, device),
            analyze(f"remat+grad_accum_{a}",
                    args.opts + ["MODEL.REMAT", "True", "TRAINER.GRAD_ACCUM", a],
                    args.crop, args.batch, args.regime, device),
        ]
    finally:
        first.set()

    summary = {"metric": "remat_memory", "crop": args.crop, "batch": args.batch,
               "regime": args.regime, "device": info}
    plain = base.get("max_allocated_mib")
    summary["plain_max_allocated_mib"] = "OOM" if base.get("oom") else plain
    for rec in others:
        key = f"{rec['label']}_max_allocated"
        if rec.get("oom"):
            summary[key + "_mib"] = "OOM"
        elif isinstance(plain, float):
            summary[key + "_ratio"] = rec["max_allocated_mib"] / plain
        else:
            summary[key + "_mib"] = rec["max_allocated_mib"]
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
