"""Host milliseconds from an epoch's start (its worker pool made, the first
batches submitted) to its first batch: the mean ``loader.epoch_start``
span of the traced stretch (None where no epoch started in it)."""

from benchmark.yardstick import program


def read(ctx):
    recs = program.of(ctx, "loader.epoch_start")
    return None if recs is None else program.mean_ms(recs, "loader.epoch_start")
