"""The port's host spans (``tracing.py``) on the CPU: nothing recorded
and no profiler annotation while tracing is off; under a profiler, the
serving call's spans nested in ``serve.predict`` and on the profiler's
timeline; after ``enable()``, the loader's spans from its worker threads,
an unlabeled item's span inside its batch's; the ring; a profiler's
warm-up. The card's spans
(``feed.stage`` on the staging thread, ``step.prepare`` / ``step.update``
around graph replays) are held by the ``cuda``-marked test, which skips
here.

This file imports no JAX: on the card run it as ``python -m pytest
--noconftest -q tests/test_torch_port_tracing.py``.
"""

import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, schedule

from multimodal_siamese_cd_tpu_torch import serving, tracing, train_lib
from multimodal_siamese_cd_tpu_torch.config import load_cfg
from multimodal_siamese_cd_tpu_torch.data.loader import (TrainLoader, group_batches,
                                                         prefetch_to_device)
from multimodal_siamese_cd_tpu_torch.models.factory import create_network

torch.set_num_threads(1)

SERVE_SPANS = ("serve.pad", "serve.copy_in", "serve.forward", "serve.fetch")


@pytest.fixture(autouse=True)
def fresh():
    tracing.disable()
    tracing.clear()
    yield
    tracing.disable()
    tracing.clear()


class _Items:
    """A training dataset stand-in: ``stack_spec`` and ``get`` as the
    loader calls them, each sample filled with its index."""

    def __init__(self, n: int):
        self.n = n

    def __len__(self):
        return self.n

    def stack_spec(self):
        return (3, 4, 4), np.float32

    def get(self, i, rng, out):
        out[...] = i + rng.random()
        return {"index": i, "is_labeled": True}


class _Mixed(_Items):
    """:class:`_Items` with the training dataset's ``labeled`` flags: every
    third item unlabeled."""

    def __init__(self, n: int):
        super().__init__(n)
        self.labeled = [i % 3 != 1 for i in range(n)]

    def get(self, i, rng, out):
        return {**super().get(i, rng, out), "is_labeled": self.labeled[i]}


def _cfg():
    cfg = load_cfg("base")
    cfg.MODEL.TYPE = "siameseunet"
    cfg.MODEL.TOPOLOGY = [8, 16]
    cfg.TRAINER.PRECISION = "fp32"
    cfg.TRAINER.BATCH_SIZE = 2
    return cfg


@pytest.fixture(scope="module")
def server(tmp_path_factory):
    cfg = _cfg()
    model = create_network(cfg, device="cpu", generator=torch.Generator().manual_seed(1))
    path = serving.export_serving_bundle(model.eval(), cfg,
                                         tmp_path_factory.mktemp("tracing") / "b.zip",
                                         buckets=((64, 64), (128, 128)), platforms="cpu",
                                         batch_sizes=(1, 2))
    return serving.load_serving_bundle(path, device="cpu")


def _pair(seed=0, h=60, w=52):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=(h, w, 6)).astype(np.float32) for _ in range(2))


def _window(cfg, device="cpu", seed=0):
    """A k-step window of ``cfg``'s model on ``device`` and a random
    super-batch for it."""
    model = create_network(cfg, device=device, generator=torch.Generator().manual_seed(seed))
    window = train_lib.make_scanned_train_step(model, train_lib.make_optimizer(model, cfg),
                                               cfg, "supervised")
    layout = train_lib.stack_layout(cfg)
    g = torch.Generator().manual_seed(seed)
    k, b, s = 2, cfg.TRAINER.BATCH_SIZE, 32
    img = torch.randn(k, b, layout["n_img"], s, s, generator=g)
    labels = (torch.rand(k, b, 3, s, s, generator=g) > 0.5).float()
    stacks = torch.cat([img, labels], 2).to(device)
    labs = torch.ones(k, b, device=device)
    return window, stacks, labs


def _by_name(recs, name):
    return [r for r in recs if r[0] == name]


@pytest.mark.parametrize("path", ["predict", "predict_batch", "window", "feed"])
def test_off_records_nothing_and_makes_no_annotation(path, server, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a span made a record_function with tracing off")

    if path == "window":
        window, stacks, labs = _window(_cfg())
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    if path == "predict":
        server.predict(*_pair())
    elif path == "predict_batch":
        server.predict_batch([_pair(1), _pair(2, 40, 30), _pair(3)])
    elif path == "window":
        window(stacks, labs, 0)
    else:
        loader = TrainLoader(_Items(8), batch_size=2, num_workers=2, seed=1)
        assert len(list(prefetch_to_device(group_batches(loader, 2), "cpu"))) == 2
    assert tracing.records() == []


def test_predict_spans_under_the_profiler(server):
    x1, x2 = _pair(4, 120, 100)
    server.predict(x1, x2)           # the artifact loads outside the profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        probs = server.predict(x1, x2)
        server.predict_batch([(x1, x2)])
    assert probs.shape == x1.shape[:2]
    recs = tracing.records()
    root, batch = _by_name(recs, "serve.predict")
    name, rid, parent, thread, t0, t1 = root
    assert parent is None and batch[1] == rid + 1     # each call its own id
    covered = 0.0
    for child in SERVE_SPANS:
        (c,) = [r for r in _by_name(recs, child) if r[1] == rid]
        assert c[2] == "serve.predict" and c[3] == thread
        assert t0 <= c[4] <= c[5] <= t1
        covered += c[5] - c[4]
    assert covered >= 0.95 * (t1 - t0), (covered, t1 - t0)
    names = {e.name for e in prof.events()}
    assert {"serve.predict", *SERVE_SPANS} <= names
    # the profiler gone, the next call turns tracing back off
    tracing.clear()
    server.predict(x1, x2)
    assert tracing.records() == []


def test_loader_spans_from_worker_threads():
    tracing.enable()
    loader = TrainLoader(_Items(12), batch_size=2, num_workers=2, seed=1)
    epochs, k = 2, 3
    for _ in range(epochs):
        assert len(list(group_batches(loader, k))) == len(loader) // k
    recs = tracing.records()
    main = threading.current_thread().name
    assemble = _by_name(recs, "loader.assemble")
    assert sorted(r[1] for r in assemble) == [(e, b) for e in range(epochs)
                                             for b in range(len(loader))]
    assert {r[3] for r in assemble} and main not in {r[3] for r in assemble}
    waits = _by_name(recs, "loader.wait")
    assert sorted(r[1] for r in waits) == sorted(r[1] for r in assemble)
    assert all(r[3] == main for r in waits)
    starts = _by_name(recs, "loader.epoch_start")
    assert [r[1] for r in starts] == [(e, 0) for e in range(epochs)]
    # each epoch's start holds the wait for its first batch, and no other
    for e, start in enumerate(starts):
        inside = [w for w in waits if start[4] <= w[4] and w[5] <= start[5]]
        assert [w[1] for w in inside] == [(e, 0)]
        assert all(w[2] == "loader.epoch_start" for w in inside)
    groups = _by_name(recs, "loader.group")
    assert [r[1] for r in groups] == list(range(len(loader) // k)) * epochs


def test_unlabeled_item_span_inside_its_batch():
    tracing.enable()
    dataset = _Mixed(12)
    loader = TrainLoader(dataset, batch_size=4, num_workers=2, seed=2)
    batches = list(loader)
    recs = tracing.records()
    assemble = {r[1]: r for r in _by_name(recs, "loader.assemble")}
    inner = _by_name(recs, "loader.assemble_unlabeled")
    # once per unlabeled item delivered
    assert len(inner) == sum(int((b["is_labeled"] == 0).sum()) for b in batches) == 4
    for r in inner:
        outer = assemble[r[1]]
        assert r[2] == "loader.assemble" and r[3] == outer[3]
        assert outer[4] <= r[4] <= r[5] <= outer[5]
    # a batch's unlabeled spans are its unlabeled rows
    for epoch, b in assemble:
        assert sum(1 for r in inner if r[1] == (epoch, b)) == \
            int((batches[b]["is_labeled"] == 0).sum())


def test_feed_pull_on_the_cpu_holds_the_loader():
    tracing.enable()
    loader = TrainLoader(_Items(8), batch_size=2, num_workers=2, seed=1)
    batches = list(prefetch_to_device(group_batches(loader, 2), "cpu"))
    assert [b["stack"].shape for b in batches] == [(2, 2, 3, 4, 4)] * 2
    recs = tracing.records()
    waits = _by_name(recs, "feed.wait")
    assert [r[1] for r in waits] == [0, 1, 2]       # the last pull finds the end
    assert all(r[2] == "feed.wait" for r in _by_name(recs, "loader.group"))


def test_window_span_on_the_cpu():
    window, stacks, labs = _window(_cfg())
    tracing.enable()
    metrics = window(stacks, labs, 40)
    assert np.isfinite(float(metrics["loss"]))
    (root,) = _by_name(tracing.records(), "train.window")
    assert root[1] == 40 and root[2] is None
    # the eager path of the CPU has no graph: no prepare or update spans
    assert not _by_name(tracing.records(), "step.prepare")


def test_ring_keeps_only_the_newest_records():
    tracing.enable()
    for i in range(tracing.RING + 5):
        with tracing.span("s", i):
            pass
    recs = tracing.records()
    assert len(recs) == tracing.RING
    assert recs[0][1] == 5 and recs[-1][1] == tracing.RING + 4


def test_profiler_warmup_turns_nothing_on(server):
    x1, x2 = _pair(6)
    server.predict(x1, x2)
    with profile(activities=[ProfilerActivity.CPU],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        server.predict(x1, x2)
        assert tracing.records() == []
        prof.step()
        server.predict(x1, x2)
        assert len(_by_name(tracing.records(), "serve.predict")) == 1
        prof.step()


def test_parents_ids_and_threads():
    tracing.enable()
    seen = {}

    def other():
        with tracing.span("worker"):
            seen["thread"] = threading.current_thread().name

    with tracing.span("root", 7):
        with tracing.span("child"):
            with tracing.span("leaf", 9):
                pass
        t = threading.Thread(target=other, name="other-thread")
        t.start()
        t.join()
    recs = {r[0]: r for r in tracing.records()}
    assert recs["child"][1:3] == (7, "root")
    assert recs["leaf"][1:3] == (9, "child")
    assert recs["root"][1:3] == (7, None)
    # another thread's spans have their own parents
    assert recs["worker"][1:4] == (None, None, "other-thread")
    tracing.disable()
    assert tracing.span("x") is tracing.span("y")      # the shared no-op


@pytest.mark.cuda
def test_card_spans_staging_and_replays():
    """On the card: ``feed.stage`` on the staging thread; on a replayed
    window ``step.prepare`` and ``step.update`` once per step inside
    ``train.window``, with its id."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    tracing.enable()
    loader = TrainLoader(_Items(8), batch_size=2, num_workers=2, seed=1)
    staged = list(prefetch_to_device(group_batches(loader, 2), "cuda"))
    assert len(staged) == 2 and staged[0]["stack"].device.type == "cuda"
    recs = tracing.records()
    main = threading.current_thread().name
    stage = _by_name(recs, "feed.stage")
    assert [r[1] for r in stage] == [0, 1] and all(r[3] != main for r in stage)
    assert all(r[3] != main for r in _by_name(recs, "loader.group"))
    assert [r[1] for r in _by_name(recs, "feed.wait")] == [0, 1, 2]

    window, stacks, labs = _window(_cfg(), device="cuda")
    assert window.mode == "graph"
    window(stacks, labs, 0)                  # eager steps, then the capture
    tracing.clear()
    window(stacks, labs, 2)                  # replays
    torch.cuda.synchronize()
    recs = tracing.records()
    (root,) = _by_name(recs, "train.window")
    for name in ("step.prepare", "step.update"):
        spans = _by_name(recs, name)
        assert len(spans) == len(stacks)
        assert all(r[1] == 2 and r[2] == "train.window" for r in spans)
        assert all(root[4] <= r[4] <= r[5] <= root[5] for r in spans)
