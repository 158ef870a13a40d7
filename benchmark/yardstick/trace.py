"""Spans around the calls into each layer, and one profiled stretch of a
run read into device time.

``Spans`` times named stretches of the harness on the host clock; while a
trace runs each span is also a profiler annotation, so the device's idle
gaps can be attributed to what the host was doing. ``trace`` runs a
function under ``torch.profiler`` with the warm-up cycle of the port's
``profile_step.trace`` (a few hundred tiny kernels whose records are
discarded: without it the first kernel records of a trace go missing) and
returns the device's operations and the spans in one time base.
``categorize`` is a copy of ``profile_step.categorize``.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import torch

WARM_LAUNCHES = 256
WINDOW = "traced_window"

_CONV = ("xmma", "cudnn", "cutlass", "gemm", "cublas", "convolve", "conv2d",
         "dgrad", "wgrad", "fprop", "splitk")
_ELEMENTWISE = ("elementwise", "batch_norm", "copy", "catarray", "index", "fill")


def categorize(kernel_name: str) -> str:
    """cuDNN/cuBLAS convolution and GEMM, cuDNN's layout transposes, the
    ``bn_stats`` kernel, other BatchNorm and elementwise work, reductions,
    the optimizer, the confusion kernel, memcpy/memset, or other."""
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


class Spans:
    """Named host-clock stretches; ``annotate`` makes each a profiler
    annotation as well."""

    def __init__(self):
        self.records = []          # (name, start s, end s)
        self.annotate = False

    @contextlib.contextmanager
    def __call__(self, name: str):
        ctx = (torch.profiler.record_function(name) if self.annotate
               else contextlib.nullcontext())
        t0 = time.perf_counter()
        with ctx:
            yield
        self.records.append((name, t0, time.perf_counter()))

    def total(self, name: str) -> float:
        return sum(t1 - t0 for n, t0, t1 in self.records if n == name)

    def count(self, name: str) -> int:
        return sum(1 for n, *_ in self.records if n == name)


def trace(fn, spans: Spans, device: torch.device) -> dict:
    """Profile one call of ``fn`` (closed by a synchronisation). Returns the
    device operations ``ops`` as ``(name, start us, end us)``, the spans
    ``annotations`` as ``(name, start us, end us)`` in the same time base,
    and the traced ``window`` ``(start us, end us)``."""
    from torch.profiler import ProfilerActivity, profile, schedule

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    sync()
    with profile(activities=activities,
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        warm = torch.zeros(1, device=device)
        for _ in range(WARM_LAUNCHES):
            warm.add_(1)
        sync()
        prof.step()
        spans.annotate = True
        try:
            with torch.profiler.record_function(WINDOW):
                fn()
                sync()
        finally:
            spans.annotate = False
        prof.step()
    ops, annotations, window = [], [], None
    names = {n for n, *_ in spans.records}
    for e in prof.events():
        start, end = e.time_range.start, e.time_range.end
        if e.device_type == torch.autograd.DeviceType.CUDA:
            if not getattr(e, "is_user_annotation", False):
                ops.append((e.name, start, end))
        elif e.name == WINDOW:
            window = (start, end)
        elif e.name in names:
            annotations.append((e.name, start, end))
    if window is None:
        raise RuntimeError("the profiler recorded no traced window")
    ops = [o for o in ops if o[2] > window[0] and o[1] < window[1]]
    return {"ops": ops, "annotations": annotations, "window": window}


def merged(ops: list, window: tuple) -> list:
    """The union of the operations' intervals, clipped to ``window``."""
    out = []
    for _, s, e in sorted(ops, key=lambda o: o[1]):
        s, e = max(s, window[0]), min(e, window[1])
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def summarize(traced: dict) -> dict:
    """Seconds of the window, of device busy time (the union of every
    operation's interval) and per kernel name; the idle gaps (us)."""
    w0, w1 = traced["window"]
    busy = merged(traced["ops"], traced["window"])
    per_kernel = defaultdict(float)
    for name, s, e in traced["ops"]:
        per_kernel[name] += (e - s) / 1e6
    gaps, cursor = [], w0
    for s, e in busy + [[w1, w1]]:
        if s > cursor:
            gaps.append((cursor, s))
        cursor = max(cursor, e)
    return {
        "window_s": (w1 - w0) / 1e6,
        "busy_s": sum(e - s for s, e in busy) / 1e6,
        "kernel_s": dict(per_kernel),
        "gaps": gaps,
        "annotations": traced["annotations"],
    }


def category_seconds(summary: dict, category: str) -> float:
    return sum(s for n, s in summary["kernel_s"].items() if categorize(n) == category)


def breakdown(summary: dict, top: int = 10) -> dict:
    """The device operations that took most time (named ``category:
    kernel``) and the longest idle gaps, each named by the innermost span
    around its middle."""
    ops = sorted(summary["kernel_s"].items(), key=lambda kv: -kv[1])[:top]
    gaps = []
    for s, e in sorted(summary["gaps"], key=lambda g: g[0] - g[1])[:top]:
        mid = (s + e) / 2
        inner = [a for a in summary["annotations"] if a[1] <= mid <= a[2]]
        label = min(inner, key=lambda a: a[2] - a[1])[0] if inner else "outside spans"
        gaps.append([label, (e - s) / 1e6])
    return {"device_ops": [[f"{categorize(n)}: {n[:160]}", s] for n, s in ops],
            "idle_gaps": gaps}
