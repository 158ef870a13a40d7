"""Training throughput of the port in patches/s per card (the JAX package's
root ``bench.py``).

    python -m multimodal_siamese_cd_tpu_torch.bench [--regime R] [KEY VALUE ...]

Definition: the full training step (augmentation on the device, forward,
backward, AdamW) on 256^2 bitemporal S1+S2 pairs (6 channels per date) at
the config's batch size, bf16. The default run measures the three regimes
with their headline models (supervised ``siameseunet``, the primary number;
dual-task ``dtsiameseunet``; semi-supervised ``whatevernet``) and prints
them in one JSON line; ``--regime`` measures one.

Timing: K steps a call (``--steps-per-call``, default 20) run as
``train_lib.make_scanned_train_step``'s window, on the card one CUDA graph
of the step's augmentation, forward and backward replayed once per step
with AdamW after each replay (``train_lib.StepGraph``); at K = 1 the eager
step (``train_lib.make_train_step``, what the trainer runs at k = 1). The
first warm-up call runs the eager warm-up and the capture, so the timed
calls only replay; at least one warm-up call is kept for that. The timed
calls go back to back and one ``torch.cuda.synchronize()`` closes them: the
calls chain through the parameters, so the synchronisation implies every
step finished. The batches are made once (:func:`build_batches`), moved to
the device and reused by every call.

Prints a ``# regime=...`` line per regime on stderr, then one JSON line::

    {"metric": "train_patches_per_sec_per_chip", "value": N,
     "unit": "patches/sec/chip", "regimes": {"supervised": N, ...},
     "per_regime": {"supervised": {"step_ms", "loss", "mode", ...}, ...},
     "device": {"platform", "name", "count", "power_limit"}}

The bench runs in a world of one process on one card; it refuses a larger
world (a multi-card cell is still to come). ``--device cpu`` runs it on the
CPU, for the tests; without it the bench needs the card and raises where
there is none.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import threading
import time
import traceback
import warnings
from collections import Counter

import numpy as np
import torch

from . import train_lib
from .config import load_cfg
from .device import describe, resolve_device
from .models.factory import create_network
from .trainers import sync

# the regime -> headline model map of the JAX package's train_lib
REGIME_MODELS = {
    "supervised": "siameseunet",
    "dualtask": "dtsiameseunet",
    "semisupervised": "whatevernet",
}
METRIC, UNIT = "train_patches_per_sec_per_chip", "patches/sec/chip"
SEED = 0        # the weights' generator seed


def arm_watchdog(disarm: threading.Event, seconds: float, code: int,
                 message: str, line: dict) -> None:
    """Unless ``disarm`` is set within ``seconds``: print ``message`` to
    stderr and ``line`` (with ``message`` as its ``error``) as one JSON line
    on stdout, so a driver reads a failure and not a blank, and end the
    process with exit code ``code`` instead of hanging."""
    def watch():
        if not disarm.wait(seconds):
            print(message, file=sys.stderr, flush=True)
            print(json.dumps({**line, "error": message}), flush=True)
            os._exit(code)

    threading.Thread(target=watch, daemon=True).start()


def build_batches(k: int, batch_size: int, crop: int, rng: np.random.Generator):
    """Planar wire stacks ``(K, B, 15, S, S)``: 12 imagery channels (2x2 S1
    + 2x4 S2), 2 building planes and the change plane thresholded at 0.8;
    every row labeled. The JAX bench's batches, draw for draw."""
    stacks = rng.uniform(0, 1, size=(k, batch_size, 15, crop, crop)).astype(np.float32)
    stacks[..., 12:, :, :] = (stacks[..., 12:, :, :] > 0.8).astype(np.float32)
    is_labeled = np.ones((k, batch_size), np.float32)
    return stacks, is_labeled


def build_payload(results: dict, primary: str, device: dict) -> dict:
    """The JSON line: ``results`` maps regime -> {"value": patches/s/chip,
    ...}; ``primary`` is the headline regime (the first measured)."""
    return {
        "metric": METRIC,
        "value": results[primary]["value"],
        "unit": UNIT,
        "regimes": {r: v["value"] for r, v in results.items()},
        "per_regime": results,
        "device": device,
    }


def regime_cfg(args, regime: str, model_type: str):
    """The base config with the regime's model, crop, precision and batch
    (the config's unless ``--batch-size``), unlabeled rows included for the
    semi-supervised regime, then the ``KEY VALUE`` overrides."""
    cfg = load_cfg("base")
    cfg.MODEL.TYPE = model_type
    cfg.TRAINER.PRECISION = args.precision
    cfg.AUGMENTATION.CROP_SIZE = args.crop
    cfg.TRAINER.BATCH_SIZE = args.batch_size or cfg.TRAINER.BATCH_SIZE
    if regime == "semisupervised":
        cfg.DATALOADER.INCLUDE_UNLABELED = True
    cfg.merge_from_list(args.opts)
    return cfg


def setup(args, regime: str, model_type: str, device: torch.device) -> tuple:
    """``(cfg, model, optimizer)`` of one regime, the weights drawn from
    :data:`SEED`."""
    cfg = regime_cfg(args, regime, model_type)
    model = create_network(cfg, device=device,
                           generator=torch.Generator().manual_seed(SEED))
    return cfg, model, train_lib.make_optimizer(model, cfg)


def hidden_syncs(call, device: torch.device) -> Counter | None:
    """The synchronising CUDA calls ``call()`` makes
    (``torch.cuda.set_sync_debug_mode("warn")``), counted by the innermost
    Python frame of the caller outside torch's own package. One known
    synchronisation after the call, a scalar's ``.item()``, is the control,
    left out of the count; None (not measured) when the mode did not report
    it."""
    torch.cuda.synchronize()
    torch_dir = os.path.dirname(torch.__file__)
    probe = torch.zeros((), device=device)
    sites, control = Counter(), []

    def record(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" not in str(message):
            return
        frames = [f for f in traceback.extract_stack()[:-1]
                  if not f.filename.startswith(torch_dir)
                  and f.filename != warnings.__file__]
        if frames[-1].name == "hidden_syncs":
            control.append(frames[-1])
        else:
            sites[f"{os.path.relpath(frames[-1].filename)}:{frames[-1].lineno} "
                  f"({frames[-1].name})"] += 1

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        try:
            call()
            probe.item()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sites if control else None


def measure(args, regime: str, cfg, model, optimizer, device: torch.device,
            first_sync: threading.Event | None = None) -> dict:
    """Time one regime; returns {value (patches/s/chip), total, step_ms,
    chips, loss, mode} (with ``--sync-debug`` also ``syncs``, the
    synchronising calls of one more call after the timed ones)."""
    batch_size, k = cfg.TRAINER.BATCH_SIZE, args.steps_per_call
    stacks, is_labeled = build_batches(k, batch_size, cfg.AUGMENTATION.CROP_SIZE,
                                       np.random.default_rng(0))
    stacks = torch.from_numpy(stacks).to(device)
    is_labeled = torch.from_numpy(is_labeled).to(device)
    if k == 1:
        step = train_lib.make_train_step(model, optimizer, cfg, regime)
        mode = "eager"

        def call(global_step):
            return step(stacks[0], is_labeled[0], global_step)
    else:
        window = train_lib.make_scanned_train_step(model, optimizer, cfg, regime)
        mode = window.mode

        def call(global_step):
            return window(stacks, is_labeled, global_step)

    done = 0
    for _ in range(max(1, args.warmup_calls)):
        m = call(done)
        done += k
    sync(device)
    if first_sync is not None:
        first_sync.set()

    t0 = time.perf_counter()
    for _ in range(args.calls):
        m = call(done)
        done += k
    sync(device)
    dt = time.perf_counter() - t0
    loss = float(m["loss"])

    n_steps = args.calls * k
    patches_per_sec = batch_size * n_steps / dt
    print(f"# regime={regime} model={cfg.MODEL.TYPE} batch={batch_size} "
          f"crop={cfg.AUGMENTATION.CROP_SIZE} precision={cfg.TRAINER.PRECISION} "
          f"chips=1 device={device} mode={mode} steps={n_steps} ({k}/call) "
          f"total={patches_per_sec:.1f} patches/s step={dt / n_steps * 1e3:.2f} ms "
          f"loss={loss:.4f}", file=sys.stderr)
    out = {"value": patches_per_sec, "total": patches_per_sec,
           "step_ms": dt / n_steps * 1e3, "chips": 1, "loss": loss, "mode": mode}
    if args.sync_debug:
        syncs = (hidden_syncs(lambda: call(done), device) if device.type == "cuda"
                 else None)
        out["syncs"] = "not measured" if syncs is None else dict(syncs)
        for site, n in (syncs or Counter()).most_common():
            print(f"# sync regime={regime}: {n} in {k} steps at {site}",
                  file=sys.stderr)
    return out


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--model", default=None,
                   help="override the regime's headline model")
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--crop", type=int, default=256)
    # 20 steps a call x 5 calls = one synchronisation per 100 steps, the
    # production LOG_FREQ cadence the trainer logs at
    p.add_argument("--steps-per-call", type=int, default=20)
    p.add_argument("--calls", type=int, default=5)
    p.add_argument("--warmup-calls", type=int, default=2,
                   help="calls before the timed ones (at least 1: the first "
                        "runs the eager warm-up and the capture)")
    p.add_argument("--precision", default="bf16")
    p.add_argument("--regime", default=None, choices=list(REGIME_MODELS),
                   help="measure one regime only (default: all three)")
    p.add_argument("--wedge-timeout", type=float, default=1500.0,
                   help="abort if no warm-up call has completed within this "
                        "many seconds")
    p.add_argument("--deadline", type=float, default=3000.0,
                   help="abort if the whole run exceeds this many seconds")
    p.add_argument("--assert-min", type=float, default=None,
                   help="exit 1 if the primary patches/sec/chip falls below "
                        "this (a regression guard)")
    p.add_argument("--sync-debug", action="store_true",
                   help="after the timed calls, one more call under "
                        "torch.cuda.set_sync_debug_mode('warn'): its "
                        "synchronising call sites on stderr and in the line")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card; 'cpu' for the "
                        "tests)")
    p.add_argument("opts", nargs="*", metavar="KEY VALUE",
                   help="config overrides applied to every regime")
    return p


def parse_args(argv=None) -> argparse.Namespace:
    p = parser()
    args = p.parse_args(argv)
    if args.model and not args.regime:
        # a forced model rarely fits all three regimes (single-head models
        # cannot train the three-head regimes)
        p.error("--model requires --regime")
    if len(args.opts) % 2:
        p.error("overrides must come in KEY VALUE pairs")
    if args.steps_per_call < 1:
        p.error("--steps-per-call must be at least 1")
    return args


def main(argv=None) -> int:
    args = parse_args(argv)
    device = resolve_device(args.device)
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        raise SystemExit("the bench runs in a world of one process on one card; "
                         "a world of ranks waits for a multi-card cell")
    info = describe(device)
    regimes = [args.regime] if args.regime else list(REGIME_MODELS)
    failed = {"metric": METRIC, "value": 0.0, "unit": UNIT, "device": info}
    first_sync, finished = threading.Event(), threading.Event()
    arm_watchdog(first_sync, args.wedge_timeout, 2,
                 f"BENCH WEDGED: no completed warm-up call after "
                 f"{args.wedge_timeout:.0f}s; aborting instead of hanging", failed)
    arm_watchdog(finished, args.deadline, 3,
                 f"BENCH DEADLINE: run exceeded {args.deadline:.0f}s; aborting "
                 f"instead of hanging", failed)
    results = {}
    try:
        for regime in regimes:
            model_type = args.model or REGIME_MODELS[regime]
            cfg, model, optimizer = setup(args, regime, model_type, device)
            results[regime] = measure(args, regime, cfg, model, optimizer, device,
                                      first_sync)
            del model, optimizer
            if device.type == "cuda":
                torch.cuda.empty_cache()
    finally:
        first_sync.set()
        finished.set()

    payload = build_payload(results, regimes[0], info)
    print(json.dumps(payload), flush=True)
    if args.assert_min is not None and payload["value"] < args.assert_min:
        print(f"REGRESSION: {payload['value']:.1f} < --assert-min {args.assert_min}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
