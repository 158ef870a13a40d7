"""Host milliseconds a served request spends making its zeroed host
buffers and copying the scenes into them: the mean ``serve.pad`` span."""

from benchmark.yardstick import program


def read(ctx):
    recs = program.of(ctx, "serve.pad")
    return None if recs is None else program.mean_ms(recs, "serve.pad")
