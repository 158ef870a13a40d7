"""The per-layer metrics that read the program's own spans
(``yardstick/program.py`` and its readers): the clock offset fitted on the
harness's paired spans, device-idle time inside a span, every reader's
None where the program has no ``tracing``, and the tiny CPU traced
rehearsal of both cells."""

from __future__ import annotations

import importlib.util
import json
import sys

import pytest

from benchmark import run
from benchmark.yardstick import program
from benchmark.yardstick.trace import Spans

from .conftest import REPO

PER_LAYER = json.loads((REPO / "BENCHMARK.json").read_text())["per_layer"]
PROGRAM_METRICS = ["train.feed_wait_ms", "train.loader_stall_ms", "train.epoch_start_ms",
                   "train.assemble_ms", "train.stage_ms", "train.step_host_ms",
                   "serve.pad_ms", "serve.copy_in_ms", "serve.idle_in_pad_pct"]
DEVICE_METRICS = {m["name"] for m in PER_LAYER if m["source"] == "device_trace"}
OFFSET_US = 123456.5


def _reader(name: str):
    spec = importlib.util.spec_from_file_location(
        f"test_metric_{name}", REPO / "benchmark" / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _harness_spans(starts_s: list) -> tuple:
    """Harness span records (perf_counter s) and their annotations (trace
    us, ``OFFSET_US`` later, with a microsecond's jitter)."""
    spans = Spans()
    annotations = []
    for i, t in enumerate(starts_s):
        name = "window" if i % 2 else "data_wait"
        spans.records.append((name, t, t + 0.01 + 0.001 * i))
        jitter = (-1) ** i * 0.9
        annotations.append((name, t * 1e6 + OFFSET_US + jitter,
                            (t + 0.01 + 0.001 * i) * 1e6 + OFFSET_US + jitter))
    return spans, annotations


def test_offset_is_the_median_of_paired_starts():
    spans, annotations = _harness_spans([10.0 + 0.05 * i for i in range(9)])
    assert program.offset_us(spans.records, annotations) == pytest.approx(OFFSET_US, abs=1.0)


def test_offset_pairs_by_duration_where_a_record_was_not_traced():
    """A span recorded before the trace (no annotation) is laid aside by
    the durations, not paired with the first annotation."""
    spans, annotations = _harness_spans([10.0 + 0.05 * i for i in range(8)])
    spans.records.insert(0, ("data_wait", 9.0, 9.5))
    annotations.reverse()
    assert program.offset_us(spans.records, annotations) == pytest.approx(OFFSET_US, abs=1.0)
    assert program.offset_us(spans.records, []) is None


def test_idle_inside_a_span_is_the_overlap_with_the_gaps():
    gaps = [(0.0, 10.0), (20.0, 30.0), (50.0, 60.0)]
    recs = [("serve.pad", 1, None, "t", 5.0, 25.0),
            ("serve.pad", 2, None, "t", 8.0, 12.0),      # overlaps the first: counted once
            ("serve.copy_in", 1, None, "t", 40.0, 55.0)]
    assert program.idle_inside_us(gaps, recs, "serve.pad") == pytest.approx(10.0)
    assert program.idle_inside_us(gaps, recs, "serve.copy_in") == pytest.approx(5.0)
    assert program.idle_inside_us(gaps, recs, "serve.fetch") == 0.0


def _ctx_with_program_spans(monkeypatch):
    """A traced run's context on the card's terms (its device time and
    gaps) whose program recorded every span a reader reads, on the
    harness's clock."""
    from multimodal_siamese_cd_tpu_torch import tracing

    spans, annotations = _harness_spans([10.0 + 0.05 * i for i in range(8)])
    w0, w1 = 10.0 * 1e6 + OFFSET_US, 10.5 * 1e6 + OFFSET_US
    names = ["feed.wait", "loader.wait", "loader.epoch_start", "loader.assemble",
             "loader.group", "feed.stage", "step.prepare", "step.update",
             "serve.pad", "serve.copy_in"]
    recs = [(n, 0, None, "t", 10.1 + 0.01 * i, 10.105 + 0.01 * i)
            for i, n in enumerate(names)]
    recs.append(("feed.wait", 1, None, "t", 9.0, 9.1))       # before the window
    monkeypatch.setattr(tracing, "records", lambda: recs)
    return {"spans": spans, "traced": {"annotations": annotations, "window": (w0, w1)},
            "summary": {"gaps": [(w0, w1)], "kernel_s": {"k": 1.0}},
            "device_name": "NVIDIA H100 80GB HBM3", "windows": 2, "steps": 4}


@pytest.mark.parametrize("name", PROGRAM_METRICS)
def test_reader_reads_the_spans_and_none_without_tracing(name, monkeypatch):
    read = _reader(name)
    ctx = _ctx_with_program_spans(monkeypatch)
    value = read(ctx)
    assert value is not None and value > 0
    monkeypatch.setitem(sys.modules, program.TRACING, None)
    assert read(ctx) is None


def test_span_outside_the_window_is_left_out(monkeypatch):
    ctx = _ctx_with_program_spans(monkeypatch)
    recs = program.spans(ctx)
    assert program.count(recs, "feed.wait") == 1
    assert program.total_ms(recs, "feed.wait") == pytest.approx(5.0, abs=1e-3)


# the spans a CPU path records: no staging thread, no graph replays
CPU_PROGRAM_METRICS = {"siameseunet.train": {"train.feed_wait_ms", "train.loader_stall_ms",
                                             "train.assemble_ms"},
                       "siameseunet.serve": {"serve.pad_ms", "serve.copy_in_ms"}}


@pytest.mark.parametrize("name", sorted(CPU_PROGRAM_METRICS))
def test_traced_rehearsal_reports_the_program_spans_it_has(tiny_cell, name):
    line = run.run_cell(tiny_cell(name, trace=True))
    assert line["correct"], line["checks"]
    got = set(line["metrics"]) & set(PROGRAM_METRICS)
    assert CPU_PROGRAM_METRICS[name] <= got
    assert not got & ({"train.stage_ms", "train.step_host_ms"} | DEVICE_METRICS)
    assert all(line["metrics"][m]["value"] > 0 for m in got)
    if name == "siameseunet.train":
        # the program's wait inside the harness's
        wait = line["metrics"]["train.data_wait_ms"]["value"]
        assert 0 < line["metrics"]["train.feed_wait_ms"]["value"] <= wait
