"""Host milliseconds the staging thread takes a window to stack the
window's batches into its super-batch (``loader.group``) and to pin it and
start its copy to the card (``feed.stage``): the two means, each once a
window."""

from benchmark.yardstick import program


def read(ctx):
    recs = program.of(ctx, "loader.group", "feed.stage")
    if recs is None:
        return None
    return program.mean_ms(recs, "loader.group") + program.mean_ms(recs, "feed.stage")
