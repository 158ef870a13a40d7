"""Host milliseconds a training window waited on the feed, per window: the
program's ``feed.wait`` spans (the step thread blocked until a staged
batch arrives) over the traced windows."""

from benchmark.yardstick import program


def read(ctx):
    recs = program.of(ctx, "feed.wait")
    if recs is None or not ctx["windows"]:
        return None
    return program.total_ms(recs, "feed.wait") / ctx["windows"]
