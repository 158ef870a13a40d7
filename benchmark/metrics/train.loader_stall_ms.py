"""Host milliseconds the staging thread waited on the loader's workers for
its batches, per window: the program's ``loader.wait`` spans over the
traced stretch, over its windows."""

from benchmark.yardstick import program


def read(ctx):
    recs = program.of(ctx, "loader.wait")
    if recs is None or not ctx["windows"]:
        return None
    return program.total_ms(recs, "loader.wait") / ctx["windows"]
