"""Device milliseconds a training step: every traced device operation's
time over the traced steps."""

from benchmark.yardstick.readers import device_seconds


def read(ctx):
    total = device_seconds(ctx)
    return None if total is None else total * 1e3 / ctx["steps"]
