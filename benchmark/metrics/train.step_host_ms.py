"""Host milliseconds a replayed training step spends around its graph: the
draws and the copies into the static inputs (``step.prepare``), the metric
clones and AdamW's launches (``step.update``), per step."""

from benchmark.yardstick import program


def read(ctx):
    recs = program.of(ctx, "step.prepare", "step.update")
    if recs is None:
        return None
    total = program.total_ms(recs, "step.prepare") + program.total_ms(recs, "step.update")
    return total / program.count(recs, "step.prepare")
