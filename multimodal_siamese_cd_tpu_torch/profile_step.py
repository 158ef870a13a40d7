"""Where a training step's device time goes (the JAX package's
``tools/profile_step.py``).

    python -m multimodal_siamese_cd_tpu_torch.profile_step [BATCH] [--regime R]

Traces ``torch.profiler.profile(activities=[CPU, CUDA])`` over 2 windows of
K = 10 steps of the regime's headline model (the base config: full width,
256^2 crops, bf16) as ``train_lib.make_scanned_train_step`` runs them, on
the card a CUDA graph of the step replayed once per step with AdamW after
each replay; the first window (the eager warm-up and the capture) runs
before the trace. Then the same for 2 x K steps of the eager k = 1 step
(``train_lib.make_train_step``). For each it prints the device time a
step by category (:func:`categorize`), the device's busy share of the host
wall time, and the top ``--top`` kernels with their ms a step and launches;
for the eager steps also the top operators by the device time of the
kernels they launched, which checks the categories against the profiler's
op attribution (it attributes no operator to kernels replayed from a
graph). One JSON line names the card.

Device time is the sum of the kernels' durations; the profiler's user
annotations on the device's timeline (``Optimizer.step#AdamW.step`` spans
the optimizer's kernels) are left out, so no kernel counts twice.
``--device cpu`` runs it on the CPU, for the tests, where no device time is
measured; without it the module needs the card and raises where there is
none.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from collections import defaultdict

import numpy as np
import torch

from . import train_lib
from .bench import REGIME_MODELS, SEED
from .config import load_cfg
from .device import describe, resolve_device
from .models.factory import create_network
from .trainers import sync

K, WINDOWS = 10, 2        # steps a window, windows traced
WARM_LAUNCHES = 256       # kernels of the profiler's warm-up cycle (trace)

CATEGORIES = ("conv/gemm", "transpose", "bn_stats", "bn/elementwise", "reduction",
              "optimizer", "confusion", "memcpy/memset", "other")
_CONV = ("xmma", "cudnn", "cutlass", "gemm", "cublas", "convolve", "conv2d",
         "dgrad", "wgrad", "fprop", "splitk")
_ELEMENTWISE = ("elementwise", "batch_norm", "copy", "catarray", "index", "fill")


def categorize(kernel_name: str) -> str:
    """The category of a device kernel by its name: cuDNN/cuBLAS
    convolution and GEMM, cuDNN's NCHW<->NHWC transposes, the ``bn_stats``
    kernel, other BatchNorm and elementwise work (copies and casts
    included), reductions, the optimizer (multi-tensor apply), the
    confusion kernel, memcpy/memset, or other (pooling among it)."""
    n = kernel_name.lower()
    if n.startswith(("memcpy", "memset")):
        return "memcpy/memset"
    if "confusion" in n:
        return "confusion"
    if "bn_stats" in n:
        return "bn_stats"
    if "multi_tensor_apply" in n or "adam" in n:
        return "optimizer"
    if "nchwtonhwc" in n or "nhwctonchw" in n or "transpose" in n:
        return "transpose"
    if any(s in n for s in _CONV):
        return "conv/gemm"
    if "reduce" in n:
        return "reduction"
    if any(s in n for s in _ELEMENTWISE):
        return "bn/elementwise"
    return "other"


def trace(fn, device: torch.device) -> dict:
    """One profiled call of ``fn`` (closed by a synchronisation): the host
    wall microseconds, and per device kernel name its microseconds and
    launches (user annotations left out); ``prof`` is the profiler.

    The profiler's warm-up cycle runs ``WARM_LAUNCHES`` small kernels first
    and discards their records. Without it the first kernel records of a
    trace went missing on an H100 (the profiler counted them out of its
    window), more the longer the process had been tracing: none in its
    first trace, about one more every 10-15 s after, so that the first
    ``bn_stats`` of a step window was lost some minutes on. With it a
    trace still lost a window's first kernels now and then (4 of 66
    traces of two step windows), so a count read from a trace is a lower
    bound."""
    from torch.profiler import ProfilerActivity, profile, schedule

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    sync(device)
    with profile(activities=activities,
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        warm = torch.zeros(1, device=device)
        for _ in range(WARM_LAUNCHES):
            warm.add_(1)
        sync(device)
        prof.step()
        t0 = time.perf_counter()
        fn()
        sync(device)
        wall_us = (time.perf_counter() - t0) * 1e6
        prof.step()
    kernels = defaultdict(lambda: [0.0, 0])
    for e in prof.events():
        if (e.device_type != torch.autograd.DeviceType.CUDA
                or getattr(e, "is_user_annotation", False)):
            continue
        kernels[e.name][0] += e.time_range.elapsed_us()
        kernels[e.name][1] += 1
    return {"wall_us": wall_us, "kernels": dict(kernels), "prof": prof}


def summarize(traced: dict, steps: int, top: int) -> dict:
    """Per step: the device ms of each category and in all, the launches of
    each category, the host wall ms, the busy share (None where the trace
    holds no device time: not measured), and the ``top`` kernels."""
    ms, launches = defaultdict(float), defaultdict(int)
    for name, (us, n) in traced["kernels"].items():
        ms[categorize(name)] += us / 1e3 / steps
        launches[categorize(name)] += n
    busy_us = sum(us for us, _ in traced["kernels"].values())
    ranked = sorted(traced["kernels"].items(), key=lambda kv: -kv[1][0])[:top]
    return {
        "categories_ms_per_step": {c: ms[c] for c in CATEGORIES if c in ms},
        "launches": {c: launches[c] for c in CATEGORIES if c in launches},
        "device_ms_per_step": busy_us / 1e3 / steps,
        "wall_ms_per_step": traced["wall_us"] / 1e3 / steps,
        "busy_share": busy_us / traced["wall_us"] if busy_us > 0 else None,
        "top": [{"kernel": name, "ms_per_step": us / 1e3 / steps,
                 "launches": n} for name, (us, n) in ranked],
    }


def print_summary(label: str, s: dict, steps: int) -> None:
    print(f"\n{label}: per-category device time over {steps} steps (ms/step):")
    if s["busy_share"] is None:
        print("  device time: not measured (the trace holds no device kernel)")
        return
    for cat, t in sorted(s["categories_ms_per_step"].items(), key=lambda kv: -kv[1]):
        print(f"{t:9.3f} ms/step  {t / s['device_ms_per_step'] * 100:5.1f}%  "
              f"{cat} ({s['launches'][cat]} launches)")
    print(f"{s['device_ms_per_step']:9.3f} ms/step  TOTAL device, host wall "
          f"{s['wall_ms_per_step']:.3f} ms/step: busy {s['busy_share'] * 100:.1f}%")
    print("top kernels (ms/step, launches):")
    for k in s["top"]:
        print(f"{k['ms_per_step']:8.3f} ms x{k['launches']:<5d} "
              f"[{categorize(k['kernel'])}] {k['kernel'][:100]}")


def top_ops(prof, top: int, steps: int) -> list:
    """The operators whose kernels took the most device time (the
    profiler's op attribution), ms a step."""
    ops = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CPU
           and e.self_device_time_total > 0]
    ops.sort(key=lambda e: -e.self_device_time_total)
    return [{"op": e.key, "ms_per_step": e.self_device_time_total / 1e3 / steps}
            for e in ops[:top]]


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("batch", nargs="?", type=int, default=8)
    p.add_argument("--regime", default="supervised", choices=list(REGIME_MODELS))
    p.add_argument("--model", default=None,
                   help="default: the regime's headline model")
    p.add_argument("--top", type=int, default=40)
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card; 'cpu' for the "
                        "tests)")
    p.add_argument("opts", nargs="*", metavar="KEY VALUE", help="config overrides")
    return p


def main(argv=None) -> int:
    p = parser()
    a = p.parse_args(argv)
    if len(a.opts) % 2:
        p.error("overrides must come in KEY VALUE pairs")
    device = resolve_device(a.device)
    info = describe(device)
    cfg = load_cfg("base")
    cfg.MODEL.TYPE = a.model or REGIME_MODELS[a.regime]
    cfg.TRAINER.BATCH_SIZE = a.batch
    if a.regime == "semisupervised":
        cfg.DATALOADER.INCLUDE_UNLABELED = True
    cfg.merge_from_list(a.opts)
    crop = cfg.AUGMENTATION.CROP_SIZE
    host = np.random.default_rng(0)
    stacks = torch.from_numpy(host.uniform(0, 1, (K, a.batch, 15, crop, crop))
                              .astype(np.float32)).to(device)
    lab = torch.ones((K, a.batch), dtype=torch.float32, device=device)
    steps = WINDOWS * K

    def fresh():
        model = create_network(cfg, device=device,
                               generator=torch.Generator().manual_seed(SEED))
        return model, train_lib.make_optimizer(model, cfg)

    window = train_lib.make_scanned_train_step(*fresh(), cfg, a.regime)
    window(stacks, lab, 0)                     # eager warm-up and capture

    def windows():
        for w in range(1, WINDOWS + 1):
            window(stacks, lab, w * K)
            sync(device)                       # the JAX tool fetches each call

    graph = summarize(trace(windows, device), steps, a.top)
    print_summary(f"{cfg.MODEL.TYPE} {a.regime} batch {a.batch}, "
                  f"{WINDOWS} windows of {K} steps ({window.mode})", graph, steps)
    graph = {"mode": window.mode, **graph}
    del window

    step = train_lib.make_train_step(*fresh(), cfg, a.regime)
    step(stacks[0], lab[0], 0)                 # warm: cuDNN's choices, AdamW's state

    def eager_steps():
        for i in range(steps):
            step(stacks[i % K], lab[i % K], 1 + i)

    traced = trace(eager_steps, device)
    eager = summarize(traced, steps, a.top)
    eager["top_ops"] = top_ops(traced["prof"], a.top, steps)
    print_summary(f"the same, {steps} eager k = 1 steps", eager, steps)
    if eager["busy_share"] is not None:
        print("top operators by their kernels' device time (ms/step):")
        for op in eager["top_ops"]:
            print(f"{op['ms_per_step']:8.3f} ms  {op['op']}")
    print(json.dumps({"metric": "step_profile", "regime": a.regime,
                      "model": cfg.MODEL.TYPE, "batch": a.batch, "k": K,
                      "windows": WINDOWS, "graph": graph, "eager": eager,
                      "device": info}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
