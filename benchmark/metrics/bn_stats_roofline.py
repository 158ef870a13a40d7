"""The train-mode BatchNorm statistics kernels' share of their roofline:
the bytes the statistics need per step (forward reads the input, backward
the output gradient and the input, in bf16) over the card's bandwidth,
over the device time of the traced ``bn_stats`` kernels."""

from benchmark.yardstick.readers import peak
from benchmark.yardstick.trace import category_seconds


def read(ctx):
    p = peak(ctx)
    if p is None:
        return None
    seconds = category_seconds(ctx["summary"], "bn_stats")
    if seconds <= 0:
        return None
    least = ctx["bn_stats_bytes_per_step"] * ctx["steps"] / p["hbm_bytes_per_s"]
    return 100.0 * least / seconds
