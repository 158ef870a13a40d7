"""Share of the traced serving calls in which no device operation ran."""

from benchmark.yardstick.readers import idle_pct


def read(ctx):
    return idle_pct(ctx)
