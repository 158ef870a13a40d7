"""The program's own host spans (``multimodal_siamese_cd_tpu_torch.tracing``),
where the checkout has them, read on the traced run's clock.

The program records its spans on ``time.perf_counter()``, the clock of the
harness's :class:`.trace.Spans`; the profiler's events are in microseconds
of its own time base. The harness's spans are on both: their records and
their annotations, paired in order and by name, give the offset between
the two (the median difference of their starts). The program's records
then map onto the trace, clipped to the traced window, beside the device's
idle gaps.

Each reader returns None where a span it reads is absent: a checkout whose
program has no ``tracing``, a run that traced nothing, a path without the
span (the CPU has no staging thread and no graph replays).
"""

from __future__ import annotations

import importlib
import statistics

TRACING = "multimodal_siamese_cd_tpu_torch.tracing"


def _pairs(records: list, annotations: list) -> list:
    """``(record, annotation)`` of one name in order; where the counts
    differ, the shorter list laid on the longer where their durations agree
    best."""
    records = sorted(records, key=lambda r: r[1])
    annotations = sorted(annotations, key=lambda a: a[1])
    rec_s = [r[2] - r[1] for r in records]
    ann_s = [(a[2] - a[1]) / 1e6 for a in annotations]
    flip = len(records) > len(annotations)
    short, long_ = (ann_s, rec_s) if flip else (rec_s, ann_s)
    shift = min(range(len(long_) - len(short) + 1),
                key=lambda k: sum(abs(x - y) for x, y in zip(short, long_[k:])))
    if flip:
        return list(zip(records[shift:], annotations))
    return list(zip(records, annotations[shift:]))


def offset_us(records: list, annotations: list) -> float | None:
    """Trace microseconds less ``perf_counter`` microseconds: the median,
    over the harness's spans ``records`` ``(name, start s, end s)`` paired
    with their ``annotations`` ``(name, start us, end us)``, of the
    difference of their starts; None where no span pairs."""
    diffs = []
    for name in {a[0] for a in annotations}:
        mine = [r for r in records if r[0] == name]
        theirs = [a for a in annotations if a[0] == name]
        if mine:
            diffs += [a[1] - r[1] * 1e6 for r, a in _pairs(mine, theirs)]
    return statistics.median(diffs) if diffs else None


def spans(ctx: dict) -> list | None:
    """The program's span records ``(name, id, parent, thread, start us,
    end us)`` on the trace's clock, clipped to the traced window; None where
    the program has no tracing or recorded nothing there."""
    try:
        tracing = importlib.import_module(TRACING)
    except ImportError:
        return None
    offset = offset_us(ctx["spans"].records, ctx["traced"]["annotations"])
    if offset is None:
        return None
    w0, w1 = ctx["traced"]["window"]
    out = []
    for name, id_, parent, thread, t0, t1 in tracing.records():
        s, e = t0 * 1e6 + offset, t1 * 1e6 + offset
        if s < w1 and e > w0:
            out.append((name, id_, parent, thread, max(s, w0), min(e, w1)))
    return out or None


def of(ctx: dict, *names: str) -> list | None:
    """:func:`spans`, or None where any of ``names`` has no span there."""
    recs = spans(ctx)
    if recs is None or any(count(recs, n) == 0 for n in names):
        return None
    return recs


def count(recs: list, name: str) -> int:
    return sum(1 for r in recs if r[0] == name)


def total_ms(recs: list, name: str) -> float:
    return sum(r[5] - r[4] for r in recs if r[0] == name) / 1e3


def mean_ms(recs: list, name: str) -> float:
    return total_ms(recs, name) / count(recs, name)


def union(intervals: list) -> list:
    """The union of ``(start, end)`` intervals, sorted."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def idle_inside_us(gaps: list, recs: list, name: str) -> float:
    """Microseconds of the device's idle ``gaps`` that fall inside the
    spans called ``name`` (the union of their intervals)."""
    inside = 0.0
    for s, e in union([(r[4], r[5]) for r in recs if r[0] == name]):
        for g0, g1 in gaps:
            inside += max(0.0, min(e, g1) - max(s, g0))
    return inside
