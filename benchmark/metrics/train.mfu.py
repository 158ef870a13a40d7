"""The training step's share of the card's dense bf16 peak: three times
the forward's convolution FLOPs (forward, and the backward's two products)
a patch, times the patches, over the traced window's seconds."""

from benchmark.yardstick.readers import peak


def read(ctx):
    p = peak(ctx)
    if p is None:
        return None
    flops = 3 * ctx["forward_flops_per_patch"] * ctx["patches"]
    return 100.0 * flops / ctx["summary"]["window_s"] / p["bf16_flops_per_s"]
