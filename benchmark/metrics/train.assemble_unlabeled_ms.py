"""Host milliseconds a loader worker takes to assemble one unlabeled item
of a batch (its timestamps, a uniform crop read out of the scene cache,
zero label planes): the mean ``loader.assemble_unlabeled`` span, a child
of ``loader.assemble``."""

from benchmark.yardstick import program


def read(ctx):
    recs = program.of(ctx, "loader.assemble_unlabeled")
    return None if recs is None else program.mean_ms(recs, "loader.assemble_unlabeled")
