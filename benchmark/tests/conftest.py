"""The benchmark's CPU tests: a tiny fixture and cells cut to CPU size.

    python -m pytest benchmark/tests -q

Tests marked ``cuda`` need the card and skip inside the test without one."""

from __future__ import annotations

import os
import time
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[2]

TINY_FIXTURE = {"seed": 11, "scene_size": [56, 56], "n_timestamps": 2,
                "labeled": ["A0", "A1", "A2", "A3"], "unlabeled": ["U0", "U1"]}

TINY = {"config": {"settings": {"MODEL.TOPOLOGY": [8, 16], "AUGMENTATION.CROP_SIZE": 32,
                                "TRAINER.PRECISION": "fp32",
                                "DATALOADER.TRAINING_MULTIPLIER": 10,
                                "TRAINER.BATCH_SIZE": 4}},
        "traffic": {"settings": {"TRAINER.STEPS_PER_EXECUTION": 5}, "trace_windows": 2,
                    "sides": [[56, 48], [48, 56], [40, 52]], "buckets": [[128, 128]],
                    "rounds": 4, "scene_pairs": 2, "sample_from": 6, "sample": 2,
                    "warm_calls": 1, "trace_requests": 3}}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card; skips inside the test without one")


@pytest.fixture(scope="session")
def data_dir(tmp_path_factory):
    return tmp_path_factory.mktemp("bench_data")


@pytest.fixture
def tiny_cell(data_dir, monkeypatch):
    """``make(name, trace=False, seconds=0.5, seed=...)`` -> a CPU cell at
    tiny size, run from the repository root."""
    from benchmark.cell import Cell

    monkeypatch.chdir(REPO)
    torch.set_num_threads(min(4, os.cpu_count() or 1))

    def make(name, trace=False, seconds=0.5, seed=2 ** 31 + 77):
        return Cell(name, seed, seconds, trace, torch.device("cpu"), time.perf_counter(),
                    patch=TINY, fixture_params=TINY_FIXTURE, data_dir=data_dir)

    return make


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
