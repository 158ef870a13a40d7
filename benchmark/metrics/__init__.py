"""One reader file per per-layer metric, named as the metric: each defines
``read(ctx) -> float | None`` (None: nothing to read in this run)."""
