"""The harness at tiny size on the CPU: each traffic kind as a rehearsal,
the result line, the faults that ``correct`` must catch, the imports."""

from __future__ import annotations

import json
import subprocess
import sys

import numpy as np
import pytest
import torch

from benchmark import run
from benchmark.yardstick import trace as trace_mod

from .conftest import REPO

CELLS = ["siameseunet.train", "siameseunet.serve"]
DEVICE_METRICS = {m["name"] for m in json.loads((REPO / "BENCHMARK.json").read_text())["per_layer"]
                  if m["source"] == "device_trace"}


@pytest.mark.parametrize("name", CELLS)
def test_rehearsal_is_correct_and_reports_its_metrics(tiny_cell, name):
    cell = tiny_cell(name)
    line = run.run_cell(cell)
    assert line["correct"], line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    assert set(line["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert "setup_s" in line["metrics"]
    assert all(v["value"] > 0 for v in line["metrics"].values())
    assert line["device"]["platform"] == "cpu"


@pytest.mark.parametrize("name", CELLS)
def test_traced_rehearsal_reports_no_device_metric(tiny_cell, name):
    line = run.run_cell(tiny_cell(name, trace=True))
    assert line["correct"], line["checks"]
    assert not set(line["metrics"]) & DEVICE_METRICS
    assert line["device"]["busy_s"] == 0.0 and line["device"]["window_s"] > 0
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}


def test_last_line_keys_and_checks_last(tiny_cell):
    line = run.run_cell(tiny_cell("siameseunet.serve"))
    keys = list(line)
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(keys)
    assert keys[-1] == "checks"
    assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    for name, c in line["checks"].items():
        assert set(c) == {"value", "limit"}, name
    json.dumps(line)


def test_state_left_unchanged_is_not_correct(tiny_cell, monkeypatch):
    """The program's optimizer updates nothing: every leaf's change reads
    1."""
    from multimodal_siamese_cd_tpu_torch import train_lib

    real = train_lib.make_optimizer

    def idle(*args, **kwargs):
        opt = real(*args, **kwargs)
        opt.step = lambda closure=None: None
        return opt

    monkeypatch.setattr(train_lib, "make_optimizer", idle)
    line = run.run_cell(tiny_cell("siameseunet.train"))
    assert not line["correct"]
    assert line["checks"]["change_gap"]["value"] > line["checks"]["change_gap"]["limit"]


def test_half_batch_left_out_is_not_correct(tiny_cell, monkeypatch):
    """Each step sees half of its rows, its loss the mean over those."""
    from multimodal_siamese_cd_tpu_torch import train_lib

    real = train_lib.make_scanned_train_step

    def halved(*args, **kwargs):
        window = real(*args, **kwargs)

        def half(stacks, labs, step):
            b = stacks.shape[1] // 2
            return window(stacks[:, :b], labs[:, :b], step)
        return half

    monkeypatch.setattr(train_lib, "make_scanned_train_step", halved)
    line = run.run_cell(tiny_cell("siameseunet.train", seed=5))
    assert not line["correct"], line["checks"]


def test_altered_served_map_is_not_correct(tiny_cell, monkeypatch):
    """A served map comes back with a tenth of its rows set to 1."""
    from multimodal_siamese_cd_tpu_torch import serving

    real = serving.ServingModel.predict

    def altered(self, x1, x2):
        p = real(self, x1, x2).copy()
        p[::10] = 1.0
        return p

    monkeypatch.setattr(serving.ServingModel, "predict", altered)
    line = run.run_cell(tiny_cell("siameseunet.serve"))
    assert not line["correct"], line["checks"]


def test_run_refuses_without_a_card(monkeypatch, capsys):
    monkeypatch.chdir(REPO)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run.main(["--workload", "siameseunet.train", "--seed", "1", "--seconds", "1"]) != 0
    assert capsys.readouterr().out == ""


def test_run_refuses_without_the_program(tmp_path):
    """In a directory with BENCHMARK.json and the benchmark alone."""
    import shutil

    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(REPO / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns(".data", "__pycache__"))
    p = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload",
                        "siameseunet.train", "--seed", "1", "--seconds", "1"],
                       cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout == ""


_PROBE = """
import importlib, json, sys
for m in {mods}:
    importlib.import_module(m)
print(json.dumps(sorted({{n.split('.')[0] for n in sys.modules}})))
"""


def _top_level_modules(mods: list) -> set:
    p = subprocess.run([sys.executable, "-c", _PROBE.format(mods=mods)], cwd=REPO,
                       capture_output=True, text=True, timeout=300, check=True)
    return set(json.loads(p.stdout.splitlines()[-1]))


def test_harness_loads_no_jax_and_no_jax_package():
    mods = ["benchmark.run", "benchmark.cell", "benchmark.calibrate", "benchmark.traffic.train",
            "benchmark.traffic.serve", "multimodal_siamese_cd_tpu_torch.train_lib",
            "multimodal_siamese_cd_tpu_torch.serving"]
    loaded = _top_level_modules(mods)
    assert not loaded & {"jax", "jaxlib", "flax", "multimodal_siamese_cd_tpu"}
    assert "multimodal_siamese_cd_tpu_torch" in loaded


def test_reference_imports_nothing_of_the_program():
    loaded = _top_level_modules(["benchmark.reference.models", "benchmark.reference.train",
                                 "benchmark.reference.data", "benchmark.reference.judge",
                                 "benchmark.yardstick.costs"])
    assert not loaded & {"jax", "jaxlib", "flax", "multimodal_siamese_cd_tpu",
                         "multimodal_siamese_cd_tpu_torch"}


def test_forbidden_modules_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "multimodal_siamese_cd_tpu_torch_x", sys)
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "multimodal_siamese_cd_tpu.ops", sys)
    assert run.forbidden_modules() == ["multimodal_siamese_cd_tpu"]


def test_trace_summary_takes_the_union_and_names_gaps():
    traced = {"ops": [("k1", 10, 20), ("k2", 15, 30), ("k3", 50, 60)],
              "annotations": [("data_wait", 28, 52), ("window", 0, 100)],
              "window": (0, 100)}
    s = trace_mod.summarize(traced)
    assert s["busy_s"] == pytest.approx(30e-6)
    assert s["window_s"] == pytest.approx(100e-6)
    b = trace_mod.breakdown(s)
    assert b["idle_gaps"][0] == ["window", pytest.approx(40e-6)]
    assert b["idle_gaps"][1] == ["data_wait", pytest.approx(20e-6)]
    assert [n.split(": ")[1] for n, _ in b["device_ops"]] == ["k2", "k1", "k3"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct_on_the_card(card, name):
    """The float8 control at the cell's own size, one seed, against the
    cell's limits: at least one number beyond its limit."""
    import os

    from benchmark import calibrate
    from benchmark.cell import Cell
    from benchmark.reference import judge

    os.chdir(REPO)
    cell = Cell(name, 424242, 0.0, False, card, 0.0)
    rows = calibrate.READINGS[cell.traffic["kind"]](cell, True)
    control = next(r for r in rows if r["kind"] == "control_fp8")
    checks = judge.check({k: control.get(k, 0.0) for k in cell.limits}, cell.limits)
    assert not all(ok for *_, ok in checks), checks
    np.testing.assert_equal(rows[0]["kind"], "program")
