"""What the per-layer readers share: whether the trace holds device time,
and the card's peaks."""

from __future__ import annotations

from . import costs


def device_seconds(ctx: dict) -> float | None:
    """Summed seconds of the traced device operations; None where the run
    traced no device (a CPU rehearsal) or the trace holds none."""
    if ctx.get("device_name") is None:
        return None
    total = sum(ctx["summary"]["kernel_s"].values())
    return total if total > 0 else None


def peak(ctx: dict) -> dict | None:
    if device_seconds(ctx) is None:
        return None
    return costs.peak(ctx["device_name"])


def idle_pct(ctx: dict) -> float | None:
    if device_seconds(ctx) is None:
        return None
    s = ctx["summary"]
    return 100.0 * (1.0 - s["busy_s"] / s["window_s"])
