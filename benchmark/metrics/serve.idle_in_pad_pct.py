"""Share of the device's idle time in the traced serving calls that falls
inside the program's ``serve.pad`` spans (the host making and filling its
padded buffers while the device waits)."""

from benchmark.yardstick import program
from benchmark.yardstick.readers import device_seconds


def read(ctx):
    if device_seconds(ctx) is None:
        return None
    recs = program.of(ctx, "serve.pad")
    gaps = ctx["summary"]["gaps"]
    idle = sum(e - s for s, e in gaps)
    if recs is None or idle <= 0:
        return None
    return 100.0 * program.idle_inside_us(gaps, recs, "serve.pad") / idle
