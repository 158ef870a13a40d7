"""Host milliseconds a loader worker takes to assemble one batch (its
crops read out of the scene cache, augmented and collated): the mean
``loader.assemble`` span."""

from benchmark.yardstick import program


def read(ctx):
    recs = program.of(ctx, "loader.assemble")
    return None if recs is None else program.mean_ms(recs, "loader.assemble")
