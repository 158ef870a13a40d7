"""Host milliseconds a served request spends copying its padded scenes to
the device: the mean ``serve.copy_in`` span."""

from benchmark.yardstick import program


def read(ctx):
    recs = program.of(ctx, "serve.copy_in")
    return None if recs is None else program.mean_ms(recs, "serve.copy_in")
