"""Multi-step execution (``TRAINER.STEPS_PER_EXECUTION``), its dispatch probe
and ``TRAINER.WEDGE_TIMEOUT`` watchdog, and the hard synthetic fixture: the
port against the JAX package, on the CPU and the synthetic fixture
(``fixture_dataset``).

JAX side at ``TRAINER.PRECISION fp32`` and ``MODEL.PACKED_FULLRES False``,
topology [8, 16], 32 px crops, batch 2, flips and rotations off; the port
runs fp32 on the CPU (its windows run eagerly there; the CUDA graph of the
step is held against the eager steps on the card by ``chip_smoke.py``
phase 12).
Weights and BatchNorm running statistics are drawn with numpy and moved
with ``weights.state_dict_from_jax``; both AdamWs resume from one
mid-training state (``test_torch_port_semisup._resumed_optimizers``'
state).
Tolerances, each stated at its test:

* the execution plan's k, ``auto``'s k and the printed lines: exact;
* grouped batches and the hard fixture's files: identical bytes;
* a k = 2 window against the JAX package's scanned K = 2 step: window
  metrics atol 1e-5, parameters atol 5e-6, BN running statistics atol 1e-6
  (``test_torch_port_train.py``'s);
* a k = 2 CLI run against a k = 1 run, and resumes across k: window losses
  atol 1e-6, steps and keys exact; their checkpoints bit for bit;
* the step's parts as a graph replay runs them: bit for bit.
"""

import contextlib
import filecmp
import io
import json
import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_siamese_cd_tpu import train_lib as jax_train_lib
from multimodal_siamese_cd_tpu import trainers as jax_trainers
from multimodal_siamese_cd_tpu.config import load_cfg as jax_load_cfg
from multimodal_siamese_cd_tpu.data import loader as jax_loader
from multimodal_siamese_cd_tpu.data import synthetic as jax_synthetic
from multimodal_siamese_cd_tpu.data.dataset import MultimodalCDDataset as JaxDataset
from multimodal_siamese_cd_tpu.data.synthetic import fixture_cfg_overrides
from multimodal_siamese_cd_tpu.models import create_network as jax_create_network
from multimodal_siamese_cd_tpu.parallel import data_mesh
from multimodal_siamese_cd_tpu_torch import train_lib, train_supervised, trainers
from multimodal_siamese_cd_tpu_torch.config import load_cfg
from multimodal_siamese_cd_tpu_torch.data import loader
from multimodal_siamese_cd_tpu_torch.data import synthetic
from multimodal_siamese_cd_tpu_torch.models.factory import create_network
from multimodal_siamese_cd_tpu_torch.models.networks import DropoutDraws
from test_torch_port_semisup import _ADAM_NU, _ADAM_STEP, _both
from test_torch_port_train import _sd

torch.set_num_threads(1)

_FLIPS_OFF = ("AUGMENTATION.RANDOM_FLIP", "False", "AUGMENTATION.RANDOM_ROTATE", "False")


# --- the execution plan -----------------------------------------------------------

@pytest.mark.parametrize("log_freq,steps_per_epoch,dispatch_ms", [
    (100, 4000, 0.01), (100, 4000, 2.7), (100, 4875, 2.7), (12, 4000, 2.7),
    (7, 9, 2.7), (100, 4000, 0.5), (40, 400, 0.51), (25, 100, 9.0),
    (1, 1, 3.0), (48, 24, 1.0),
])
def test_auto_steps_per_execution_matches_jax(log_freq, steps_per_epoch, dispatch_ms):
    """The JAX package's table (tests/test_train_lib.py) and more: exact."""
    want = jax_trainers.auto_steps_per_execution(log_freq, steps_per_epoch, dispatch_ms)
    assert trainers.auto_steps_per_execution(log_freq, steps_per_epoch,
                                             dispatch_ms) == want


class _Sized:
    """A loader stand-in: the plan reads only its length."""

    def __len__(self):
        return 4


@pytest.mark.parametrize("raw,debug,start_step", [
    ("auto", True, 0), ("auto", False, 0), (2, False, 0), (4, False, 8),
    (3, False, 0), (2, True, 0), (2, False, 3),
], ids=["auto-debug", "auto-probe", "k2", "k4-resume8", "k3-nondividing",
        "k2-debug", "k2-misaligned-resume"])
def test_execution_plan_matches_jax(fixture_dataset, capsys, raw, debug, start_step):
    """Four steps per epoch, LOG_FREQ 4: the port's k and printed lines equal
    the JAX package's (on the CPU ``auto`` probes a local backend and picks
    1, as the JAX probe does there)."""
    jcfg, tcfg = _cfgs_pair(fixture_dataset)
    for cfg in (jcfg, tcfg):
        cfg.DEBUG = debug
        cfg.LOG_FREQ = 4
        cfg.TRAINER.STEPS_PER_EXECUTION = raw
    capsys.readouterr()
    k_jax, _, _ = jax_trainers._execution_plan(
        jcfg, jax_create_network(jcfg), "supervised", data_mesh(jax.devices()[:1]),
        _Sized(), start_step)
    printed_jax = capsys.readouterr().out
    model = create_network(tcfg, device="cpu")
    k, step_fn = trainers._execution_plan(
        tcfg, model, train_lib.make_optimizer(model, tcfg), "supervised",
        _Sized(), start_step, device="cpu")
    assert capsys.readouterr().out == printed_jax
    assert k == k_jax
    assert getattr(step_fn, "mode", None) == ("eager" if k > 1 else None)
    assert (k, bool(printed_jax)) == {
        "auto": (1, False), 2: (1, True) if debug or start_step else (2, False),
        4: (4, False), 3: (1, True)}[raw]


def test_auto_plan_takes_rank_zeros_probe(fixture_dataset, monkeypatch, capsys):
    """In a world of several ranks ``auto`` derives k from rank 0's probe,
    as the JAX package broadcasts process 0's: here the world is faked (two
    ranks, a broadcast that writes rank 0's 2.7 ms), and the plan picks the
    k of 2.7 ms, 4 at LOG_FREQ 4 and four steps an epoch, printing the JAX
    package's line."""
    _, tcfg = _cfgs_pair(fixture_dataset)
    tcfg.DEBUG, tcfg.LOG_FREQ = False, 4
    sent = []

    def broadcast_(tensors, src=0):
        sent.append(float(tensors[0]))
        tensors[0].fill_(2.7)

    monkeypatch.setattr(trainers.group, "world_size", lambda: 2)
    monkeypatch.setattr(trainers.group, "broadcast_", broadcast_)
    model = create_network(tcfg, device="cpu")
    k, step_fn = trainers._execution_plan(
        tcfg, model, train_lib.make_optimizer(model, tcfg), "supervised",
        _Sized(), 0, device="cpu")
    assert len(sent) == 1 and sent[0] < 0.5          # this rank's own probe
    assert k == 4 == trainers.auto_steps_per_execution(4, 4, 2.7)
    assert capsys.readouterr().out == (
        "dispatch latency 2.70 ms/step -> STEPS_PER_EXECUTION=4 (scan-fused)\n")
    assert step_fn.mode == "eager"


def _cfgs_pair(root, name="siamese", overrides=()):
    out = []
    for load in (jax_load_cfg, load_cfg):
        cfg = load(name)
        cfg.merge_from_list(fixture_cfg_overrides() + list(overrides))
        cfg.PATHS.DATASET = str(root)
        cfg.MODEL.TOPOLOGY = [8, 16]
        cfg.TRAINER.PRECISION = "fp32"
        cfg.TRAINER.BATCH_SIZE = 2
        cfg.MODEL.PACKED_FULLRES = False
        out.append(cfg)
    return out


@pytest.mark.parametrize("k", [1, 2, 3])
def test_group_batches_matches_jax(k):
    """Seven numpy batches: array keys stacked on a new leading axis,
    metadata keys as lists, the trailing partial group dropped; identical
    to the JAX package's."""
    rng = np.random.default_rng(k)
    batches = [{"stack": rng.normal(size=(2, 3, 4, 4)).astype(np.float32),
                "is_labeled": rng.integers(0, 2, 2).astype(np.float32),
                "aoi": [f"a{i}", f"b{i}"]} for i in range(7)]
    want = list(jax_loader.group_batches(iter(batches), k))
    got = list(loader.group_batches(iter(batches), k))
    assert len(got) == len(want) == 7 // k
    for g, w in zip(got, want):
        assert list(g) == list(w)
        for key in ("stack", "is_labeled"):
            assert g[key].shape == (k,) + batches[0][key].shape
            np.testing.assert_array_equal(g[key], w[key])
        assert g["aoi"] == w["aoi"]


def test_dispatch_probe_watchdog(monkeypatch, capsys):
    """A first fetch that stalls past ``WEDGE_TIMEOUT``: the watchdog prints
    ``TRAINER WEDGED`` to stderr and calls ``os._exit(2)`` (patched here to
    record the code and release the stall); a healthy probe arms and
    disarms it and returns a small non-negative latency."""
    release, codes = threading.Event(), []
    calls = []

    def stalled(x):
        calls.append(1)
        if len(calls) == 1:
            assert release.wait(30), "the watchdog never fired"
        return x + 1.0

    def fake_exit(code):
        codes.append(code)
        release.set()

    monkeypatch.setattr(trainers, "_probe_op", stalled)
    monkeypatch.setattr(os, "_exit", fake_exit)
    ms = trainers.measure_dispatch_latency_ms(0.05, device="cpu")
    assert codes == [2]
    err = capsys.readouterr().err
    assert err.startswith("TRAINER WEDGED: no completed device fetch after 0s")
    assert ms >= 0.0
    monkeypatch.undo()
    monkeypatch.setattr(os, "_exit", fake_exit)
    assert 0.0 <= trainers.measure_dispatch_latency_ms(60.0, device="cpu") < 0.5
    assert codes == [2]


# --- a window of two steps against the JAX package's scanned step -------------------

def _resumed(s):
    """``test_torch_port_semisup._resumed_optimizers``' state (AdamW at step
    100, zero first moments, second moments 1e-9), with the JAX train state
    built from ``s.variables`` directly rather than from a fresh init."""
    params = s.variables["params"]
    tx = jax_train_lib.make_optimizer(s.jcfg)
    adam, *rest = tx.init(params)
    adam = adam._replace(
        count=jnp.asarray(_ADAM_STEP, adam.count.dtype),
        nu=jax.tree_util.tree_map(lambda p: jnp.full(p.shape, _ADAM_NU, p.dtype),
                                  params))
    state = jax_train_lib.TrainState.create(
        apply_fn=s.jmodel.apply, params=params,
        batch_stats=s.variables["batch_stats"], tx=tx).replace(opt_state=(adam, *rest))
    optimizer = train_lib.make_optimizer(s.tmodel, s.tcfg)
    for p in s.tmodel.parameters():
        optimizer.state[p] = {"step": torch.tensor(float(_ADAM_STEP)),
                              "exp_avg": torch.zeros_like(p),
                              "exp_avg_sq": torch.full_like(p, _ADAM_NU)}
    return state, optimizer


def _labeled_with_change(jcfg, n):
    jds = JaxDataset(jcfg, "training", return_stack=True, crop_only=True)
    items = [jds.get(i, np.random.default_rng([seed, i]))
             for seed in (5, 6, 7) for i in range(len(jds))]
    lab = [it for it in items if it["is_labeled"] and it["stack"][-1].any()]
    unl = [it for it in items if not it["is_labeled"]]
    return lab[:n], unl[:n]


def _window_batches(jcfg, semisup: bool):
    """Two batches of two crops: both labeled (with change pixels), or for
    the semi-supervised regime one labeled and one unlabeled."""
    lab, unl = _labeled_with_change(jcfg, 4)
    pairs = [lab[:2], unl[:2]] if semisup else [lab[:2], lab[2:4]]
    stacks = np.stack([np.stack([it["stack"] for it in p]) for p in pairs])
    labs = np.stack([np.asarray([it["is_labeled"] for it in p], np.float32)
                     for p in pairs])
    return stacks, labs


@pytest.mark.parametrize("name,regime", [
    ("siamese", "supervised"), ("dtsiamese", "dualtask"),
    ("siamese_mmcr_alpha0500", "semisupervised"),
])
def test_window_matches_jax_scanned_step(fixture_dataset, name, regime):
    """One window of k = 2 (the port's ``make_scanned_train_step``, eager on
    the CPU) against the JAX package's ``make_scanned_train_step`` with
    K = 2, from one set of weights and one resumed AdamW state: every
    window metric atol 1e-5 (the semi-supervised presence weights
    ``n_lab_steps`` and ``n_notlab_steps`` exactly 1 and 1), every BN
    running statistic atol 1e-6, every parameter atol 5e-6 (the steps move
    them far past it). Resumed AdamW moves a pre-BN bias, whose gradient is
    roundoff in both packages, by ~0.1 of that roundoff, so the running
    means need no bias-drift correction here."""
    s = _both(fixture_dataset, name, _FLIPS_OFF)
    stacks, labs = _window_batches(s.jcfg, regime == "semisupervised")
    state, optimizer = _resumed(s)
    jwindow = jax_train_lib.make_scanned_train_step(s.jmodel, s.jcfg, regime)
    state, aux = jwindow(state, jnp.asarray(stacks), jnp.asarray(labs),
                         jax.random.PRNGKey(0))
    window = train_lib.make_scanned_train_step(s.tmodel, optimizer, s.tcfg, regime)
    assert window.mode == "eager"
    out = window(torch.from_numpy(stacks), torch.from_numpy(labs), 100)
    assert set(out) == set(aux)
    for key in out:
        np.testing.assert_allclose(float(out[key]), float(aux[key]), atol=1e-5,
                                   err_msg=key)
    if regime == "semisupervised":
        assert (float(out["n_lab_steps"]), float(out["n_notlab_steps"])) == (1.0, 1.0)
        assert float(out["sup_loss"]) > 0 and float(out["cons_loss"]) > 0
    ours = s.tmodel.state_dict()
    for name_, want in _sd(state.batch_stats, "batch_stats").items():
        np.testing.assert_allclose(ours[name_].numpy(), want, atol=1e-6, rtol=0,
                                   err_msg=name_)
    init = _sd(s.variables["params"], "params")
    moved = 0.0
    for name_, want in _sd(state.params, "params").items():
        np.testing.assert_allclose(ours[name_].numpy(), want, atol=5e-6,
                                   err_msg=name_)
        moved = max(moved, float(np.abs(want - init[name_]).max()))
    assert moved > 10 * 5e-6


# --- the captured step's draws, on the CPU -------------------------------------------

@pytest.mark.parametrize("accum", [1, 2])
def test_step_parts_with_dropout_draws_equal_the_step(fixture_dataset, accum):
    """siamunet_diff, flips and rotations on, two steps from one state, the
    way a :class:`.train_lib.StepGraph` runs them: the first as
    ``step.grads`` with its generator's draws recorded by a
    :class:`DropoutDraws`, then ``step.update``; then the capture (here
    ``step.grads`` on a copy of the model, which takes the rewound draws in
    call order and checks their shapes); then the second as ``step.grads``
    on copies of ``step.draw``'s decisions with the draws refilled from the
    step's generator (a replay), then ``step.update``. Metrics, parameters
    and buffers equal the plain steps' bit for bit; with GRAD_ACCUM 2 both
    micro-batches' masks come from the one record and refill."""
    _, tcfg = _cfgs_pair(fixture_dataset, "siamese", ("MODEL.TYPE", "siamunet_diff",
                                                      "TRAINER.GRAD_ACCUM", str(accum)))
    lab, _ = _labeled_with_change(_cfgs_pair(fixture_dataset)[0], 2)
    stack = torch.from_numpy(np.stack([it["stack"] for it in lab]))

    def fresh():
        model = create_network(tcfg, device="cpu",
                               generator=torch.Generator().manual_seed(1))
        return model, train_lib.make_train_step(
            model, train_lib.make_optimizer(model, tcfg), tcfg, "supervised")

    model, step = fresh()
    eager = [step(stack, None, 4), step(stack, None, 5)]
    want = {k: v.clone() for k, v in model.state_dict().items()}

    model, step = fresh()
    draws = DropoutDraws()
    generator, decisions = step.draw(2, 4)
    draws.record(generator)
    replayed = [step.grads(stack, None, decisions, draws)]
    step.update()
    draws.rewind()
    assert len(draws.buffers) == 29 * accum     # 20 encoder units + 9 decoder
    _, capture_step = fresh()
    capture_step.grads(stack, None, decisions, draws)     # takes every buffer
    generator, decisions = step.draw(2, 5)
    static = {k: None if v is None else v.clone() for k, v in decisions.items()}
    draws.refill(generator)
    replayed.append(step.grads(stack, None, static, draws))
    step.update()

    for a, b in zip(eager, replayed):
        assert {k: float(v) for k, v in a.items()} == {k: float(v) for k, v in b.items()}
    for key, value in model.state_dict().items():
        assert torch.equal(value, want[key]), key
    with pytest.raises(RuntimeError, match="dropout draw"):   # another batch
        capture_step.grads(torch.cat([stack, stack]), None, step.draw(4, 6)[1], draws)


# --- the CLI: windows, checkpoints and resumes across k --------------------------------

def _train(root, out, k, epochs, resume=False):
    opts = fixture_cfg_overrides() + [
        "MODEL.TOPOLOGY", "[8, 16]", "TRAINER.BATCH_SIZE", "2",
        "TRAINER.PRECISION", "fp32", "TRAINER.EPOCHS", str(epochs),
        "DATALOADER.TRAINING_MULTIPLIER", "4", "SAVE_CHECKPOINTS", "[1]",
        "LOG_FREQ", "2", "TRAINER.STEPS_PER_EXECUTION", str(k)]
    if resume:
        opts += ["TRAINER.RESUME_CHECKPOINT", "latest"]
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        train_supervised.main(["-c", "siamese", "-p", "proj", "-o", str(out), "-d",
                               str(root), "--device", "cpu"] + opts)
    records = [json.loads(line) for line in
               (out / "logs" / "siamese.jsonl").read_text().splitlines()]
    return [r for r in records if "train_time" in r], printed.getvalue()


def _same_windows(got, want):
    assert [sorted(r) for r in got] == [sorted(r) for r in want]
    assert [(r["step"], r["epoch"]) for r in got] == [(r["step"], r["epoch"]) for r in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g["loss"], w["loss"], atol=1e-6)


@pytest.fixture(scope="module")
def cli_runs(fixture_dataset, tmp_path_factory):
    """Two-epoch CLI runs (four steps an epoch, LOG_FREQ 2, a checkpoint
    after epoch 1) with k = 1 and k = 2: ``{k: (out dir, windows,
    stdout)}``."""
    runs = {}
    for k in (1, 2):
        out = tmp_path_factory.mktemp(f"steps_k{k}")
        runs[k] = (out, *_train(fixture_dataset, out, k, 2))
    return runs


def test_cli_windows_match_across_k(cli_runs):
    """``STEPS_PER_EXECUTION 2`` logs the windows of a k = 1 run (steps 2,
    4, 6, 8; losses atol 1e-6: a window's loss is the mean of its windows'
    means) and says how its windows run."""
    (_, w1, _), (_, w2, printed) = cli_runs[1], cli_runs[2]
    assert [r["step"] for r in w1] == [2, 4, 6, 8]
    _same_windows(w2, w1)
    assert ("STEPS_PER_EXECUTION=2: 2 steps per window, the steps in turn, "
            "eagerly") in printed


def test_cli_checkpoints_match_across_k(cli_runs):
    """The epoch-1 checkpoints of the k = 1 and k = 2 runs hold the same
    step, weights, buffers and AdamW state bit for bit (AdamW is the k = 1
    step's in every window: not capturable, counters on the host)."""
    files = [torch.load(cli_runs[k][0] / "networks" / "siamese_checkpoint1.pt",
                        map_location="cpu", weights_only=True) for k in (1, 2)]
    assert files[0]["step"] == files[1]["step"] == 4
    for key, value in files[0]["network"].items():
        assert torch.equal(value, files[1]["network"][key]), key
    opt1, opt2 = (f["optimizer"] for f in files)
    assert opt1["param_groups"] == opt2["param_groups"]
    assert not opt1["param_groups"][0]["capturable"]
    for i, state in opt1["state"].items():
        for key, value in state.items():
            assert value.device.type == "cpu" or key != "step"
            assert torch.equal(value, opt2["state"][i][key]), (i, key)


@pytest.mark.parametrize("k_from,k_to", [(1, 2), (2, 1)])
def test_cli_resumes_across_k(fixture_dataset, tmp_path, cli_runs, k_from, k_to):
    """The epoch-1 checkpoint of one run, resumed under the other k with
    ``RESUME_CHECKPOINT latest``, logs the unbroken runs' epoch-2 windows."""
    out = tmp_path / "out" / "networks"
    out.mkdir(parents=True)
    ckpt = cli_runs[k_from][0] / "networks" / "siamese_checkpoint1.pt"
    (out / ckpt.name).write_bytes(ckpt.read_bytes())
    resumed, printed = _train(fixture_dataset, tmp_path / "out", k_to, 2, resume=True)
    assert "resumed from checkpoint epoch 1 (step 4)" in printed
    _same_windows(resumed, cli_runs[1][1][2:])


# --- the hard fixture ------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 7])
def test_hard_dataset_matches_jax(tmp_path, seed):
    """``generate_hard_dataset`` at a 64^2 scene writes byte-identical trees
    and returns the same metadata in both packages."""
    kw = dict(seed=seed, scene_size=(64, 64))
    want = jax_synthetic.generate_hard_dataset(tmp_path / "jax", **kw)
    got = synthetic.generate_hard_dataset(tmp_path / "port", **kw)
    assert got == want
    files = sorted(p.relative_to(tmp_path / "jax")
                   for p in (tmp_path / "jax").rglob("*") if p.is_file())
    assert len(files) == 1 + 5 * 4 * 2 + 4 * 4     # metadata, s1+s2, labels
    assert files == sorted(p.relative_to(tmp_path / "port")
                           for p in (tmp_path / "port").rglob("*") if p.is_file())
    match, mismatch, errors = filecmp.cmpfiles(tmp_path / "jax", tmp_path / "port",
                                               [str(f) for f in files], shallow=False)
    assert not mismatch and not errors and len(match) == len(files)
