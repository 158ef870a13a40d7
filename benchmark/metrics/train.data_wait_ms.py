"""Host milliseconds a training window waited on the feed (the loader,
the dataset, the scene cache and the staging copy), per window: the
harness's span around ``next()`` of ``prefetch_to_device``."""


def read(ctx):
    if not ctx["windows"]:
        return None
    return ctx["spans"].total("data_wait") * 1e3 / ctx["windows"]
