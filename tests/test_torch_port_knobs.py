"""The port's single-device training knobs against the JAX package (or, for
the loader, against the port's own thread path), on the CPU and the
synthetic fixture: ``TRAINER.GRAD_ACCUM``, ``MODEL.REMAT``,
``DATALOADER.WORKER_TYPE process``, ``TRAINER.PROFILE_DIR`` and the rule
that every extension key works, raises or is declared a no-op.

JAX side at ``TRAINER.PRECISION fp32`` and ``MODEL.PACKED_FULLRES False``,
un-jitted steps, topology [8, 16], 32 px crops, flips and rotations off;
the port runs fp32 on the CPU with the plain ``bn_stats``. Weights are drawn
with numpy and moved with ``weights.state_dict_from_jax``; both packages
resume from one AdamW state (``test_torch_port_semisup._resumed_optimizers``).
Tolerances, each stated at its test:

* accumulated and REMAT steps against the JAX package: metrics atol 1e-5,
  BN running statistics atol 1e-6, parameters atol 1e-6;
* the port's REMAT step against its plain step, ``GRAD_ACCUM 1`` against
  the plain step's code, process batches against thread batches, window
  means against the JAX package's: exact.
"""

import copy
import json

import jax
import numpy as np
import pytest
import torch

from multimodal_siamese_cd_tpu import trainers as jax_trainers
from multimodal_siamese_cd_tpu.data.dataset import MultimodalCDDataset as JaxDataset
from multimodal_siamese_cd_tpu.data.synthetic import fixture_cfg_overrides
from multimodal_siamese_cd_tpu_torch import config, train_lib, train_supervised, trainers
from multimodal_siamese_cd_tpu_torch.data.dataset import MultimodalCDDataset
from multimodal_siamese_cd_tpu_torch.data.loader import TrainLoader
from multimodal_siamese_cd_tpu_torch.models import batchnorm
from multimodal_siamese_cd_tpu_torch.models.factory import create_network
from multimodal_siamese_cd_tpu_torch.ops.bn_stats import bn_stats
from test_torch_port_semisup import _FLIPS_OFF, _both, _steps_match
from test_torch_port_train import _cfgs

torch.set_num_threads(1)


def _crops(jcfg, labeled: int, unlabeled: int) -> dict:
    """One batch of distinct training crops of the JAX package's dataset:
    ``labeled`` labeled crops holding change pixels (on a crop without any,
    PowerJaccard's gradient is exactly zero), then ``unlabeled`` unlabeled
    ones."""
    jds = JaxDataset(jcfg, "training", return_stack=True, crop_only=True)
    items = [jds.get(i, np.random.default_rng([seed, i]))
             for seed in (5, 6, 7) for i in range(len(jds))]
    lab = [it for it in items if it["is_labeled"] and it["stack"][-1].any()]
    unl = [it for it in items if not it["is_labeled"]]
    pick = lab[:labeled] + unl[:unlabeled]
    assert len(pick) == labeled + unlabeled
    return {"stack": np.stack([it["stack"] for it in pick]),
            "is_labeled": np.asarray([it["is_labeled"] for it in pick], np.float32)}


def _with(overrides=(), name="siamese"):
    return _FLIPS_OFF + tuple(overrides), name


# --- TRAINER.GRAD_ACCUM ------------------------------------------------------------

def test_grad_accum_matches_jax(fixture_dataset):
    """GRAD_ACCUM 2 on a batch of 4 distinct crops: the loss, every BN
    running statistic after the step and every parameter equal the JAX
    package's accumulated step (tolerances in the module docstring)."""
    overrides, name = _with(("TRAINER.GRAD_ACCUM", "2", "TRAINER.BATCH_SIZE", "4"))
    s = _both(fixture_dataset, name, overrides)
    calls = _steps_match(s, "supervised", [_crops(s.jcfg, 4, 0)], param_atol=1e-6)
    # each micro-batch runs every BatchNorm: twice a step in the decoder,
    # four times in the Siamese stem and encoder (one call per date)
    assert calls and all(n == (2 if bn.startswith("decoder.") else 4)
                         for bn, n in calls.items())


def test_grad_accum_semisupervised_metrics_match_jax(fixture_dataset):
    """A mixed batch whose micro-batches hold one partition each (two
    labeled crops, then two unlabeled): the accumulated metrics equal the
    JAX package's ``_reduce_window_metrics`` of its micro-batches, with
    summed counts and presence weights, and the step equals its step."""
    overrides, name = _with(("TRAINER.GRAD_ACCUM", "2", "TRAINER.BATCH_SIZE", "4"),
                            "siamese_mmcr_alpha0500")
    s = _both(fixture_dataset, name, overrides)

    def check(i, out):
        assert float(out["n_labeled"]) == float(out["n_notlabeled"]) == 2.0
        assert float(out["n_lab_steps"]) == float(out["n_notlab_steps"]) == 1.0
        # each loss term is the one micro-batch that had its partition
        assert float(out["sup_loss"]) > 0 and float(out["cons_loss"]) > 0
        assert float(out["loss"]) == pytest.approx(
            (float(out["sup_loss"]) + float(out["cons_loss"])) / 2, abs=1e-6)

    _steps_match(s, "semisupervised", [_crops(s.jcfg, 2, 2)], check, param_atol=1e-6)


def test_grad_accum_duplicated_halves_equal_the_plain_step(fixture_dataset):
    """The JAX package's test_train_lib.py:293-325 on the port: GRAD_ACCUM 2
    on a batch made of two identical halves gives the plain step's loss and
    parameters on one half (the micro-batch gradients are equal, so their
    average is too): loss rel 1e-6, parameters atol 1e-6."""
    overrides, name = _with()
    s = _both(fixture_dataset, name, overrides)
    half = _crops(s.jcfg, 2, 0)
    models = []
    for accum, stack, lab in ((1, half["stack"], half["is_labeled"]),
                              (2, np.concatenate([half["stack"]] * 2),
                               np.concatenate([half["is_labeled"]] * 2))):
        cfg = copy.deepcopy(s.tcfg)
        cfg.TRAINER.GRAD_ACCUM = accum
        model = copy.deepcopy(s.tmodel)
        step = train_lib.make_supervised_train_step(
            model, train_lib.make_optimizer(model, cfg), cfg)
        out = step(torch.from_numpy(stack), torch.from_numpy(lab), 0)
        models.append((float(out["loss"]), model))
    (l1, m1), (l2, m2) = models
    assert l1 == pytest.approx(l2, rel=1e-6)
    for (name, p), q in zip(m1.named_parameters(), m2.parameters()):
        np.testing.assert_allclose(p.detach().numpy(), q.detach().numpy(),
                                   atol=1e-6, err_msg=name)


def test_grad_accum_must_divide_the_batch(fixture_dataset):
    _, tcfg = _cfgs(fixture_dataset)
    tcfg.TRAINER.GRAD_ACCUM = 2
    model = create_network(tcfg, device="cpu")
    step = train_lib.make_supervised_train_step(
        model, train_lib.make_optimizer(model, tcfg), tcfg)
    stack = torch.zeros((3,) + MultimodalCDDataset(tcfg, "training").stack_spec()[0])
    with pytest.raises(ValueError, match="GRAD_ACCUM=2 must divide the batch size 3"):
        step(stack, torch.ones(3), 0)


def _parent_step(model, optimizer, cfg):
    """The supervised step as it was before micro-batches existed: one
    forward and backward of the whole batch, zero gradients for unreached
    parameters, one AdamW step."""
    from multimodal_siamese_cd_tpu_torch import losses

    criterion = losses.get_criterion(cfg.MODEL.LOSS_TYPE)
    layout = train_lib.stack_layout(cfg)

    def step(stack, is_labeled, global_step):
        model.train()
        generator = train_lib.augment_generator(cfg.SEED, global_step, torch.device("cpu"))
        stack_aug = train_lib.augment(stack, cfg, layout, torch.float32, generator)
        x_t1, x_t2, y_change, _, _ = train_lib.split_stack(stack_aug, layout)
        loss = criterion(model(x_t1, x_t2).float(), y_change)
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        for p in model.parameters():
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        optimizer.step()
        return {"loss": loss.detach()}

    return step


def test_grad_accum_one_is_the_plain_step_bit_for_bit(fixture_dataset):
    """``GRAD_ACCUM 1`` (and the key unset) steps exactly as the
    pre-accumulation step did, augmentation on: losses, parameters and
    buffers bit-equal after three steps."""
    _, tcfg = _cfgs(fixture_dataset)
    batch = next(iter(TrainLoader(MultimodalCDDataset(tcfg, "training"), 2,
                                  num_workers=0, seed=1)))
    stack, lab = torch.from_numpy(batch["stack"]), torch.from_numpy(batch["is_labeled"])
    base = create_network(tcfg, device="cpu", generator=torch.Generator().manual_seed(0))
    runs = []
    for accum in (None, 1, "parent"):
        cfg = copy.deepcopy(tcfg)
        if accum == 1:
            cfg.TRAINER.GRAD_ACCUM = 1
        model = copy.deepcopy(base)
        optimizer = train_lib.make_optimizer(model, cfg)
        make = _parent_step if accum == "parent" else train_lib.make_supervised_train_step
        step = make(model, optimizer, cfg)
        losses = [float(step(stack, lab, i)["loss"]) for i in range(3)]
        runs.append((losses, model.state_dict()))
    for losses, state in runs[1:]:
        assert losses == runs[0][0]
        for key, val in state.items():
            assert torch.equal(val, runs[0][1][key]), key


def test_semisup_window_means_with_weight_columns_match_jax():
    """Rows of (n_labeled, n_notlabeled, w_lab, w_unl), as accumulated
    steps give them, mixed with plain 2-column rows: equal to the JAX
    package's reduction, exactly."""
    rng = np.random.default_rng(11)
    keys = ("fusion_loss", "stream1_loss", "stream2_loss", "loss", "sup_loss",
            "cons_loss")
    sets = {k: [float(v) for v in rng.uniform(0, 1, 6)] for k in keys}
    rows = [(2.0, 2.0, 1.0, 1.0), (4.0, 0.0, 2.0, 0.0), (1.0, 3.0),
            (0.0, 4.0, 0.0, 2.0), (3.0, 1.0, 2.0, 1.0), (0.0, 2.0)]
    ours = trainers._semisup_window_means(sets, rows)
    assert ours == jax_trainers._semisup_window_means(sets, rows)
    # the weights matter: 0/1 presence would give another supervised mean
    assert ours != trainers._semisup_window_means(sets, [r[:2] for r in rows])


# --- MODEL.REMAT -----------------------------------------------------------------

REMAT_CASES = [("siamese", "supervised", "siameseunet"),
               ("dtsiamese", "dualtask", "dtsiameseunet"),
               ("siamese_mmcr_alpha0500", "semisupervised", "whatevernet")]


@pytest.mark.parametrize("name,regime,model_type", REMAT_CASES,
                         ids=[c[2] for c in REMAT_CASES])
def test_remat_step_equals_the_plain_step(fixture_dataset, name, regime, model_type,
                                          monkeypatch):
    """The JAX package's test_train_lib.py:241-290 models: with REMAT every
    stem, Down and Up stage is checkpointed, and one step's gradients,
    parameters, running statistics and ``num_batches_tracked`` are
    bit-equal to the plain step's: the recompute leaves the buffers
    alone, so each BatchNorm counts its calls once."""
    tcfg = config.load_cfg(name)
    tcfg.merge_from_list(fixture_cfg_overrides() + list(_FLIPS_OFF))
    tcfg.PATHS.DATASET = str(fixture_dataset)
    tcfg.MODEL.TOPOLOGY = [8, 16]
    tcfg.TRAINER.PRECISION = "fp32"
    tcfg.TRAINER.BATCH_SIZE = 2
    assert tcfg.MODEL.TYPE == model_type
    batch = next(iter(TrainLoader(MultimodalCDDataset(tcfg, "training"), 2,
                                  num_workers=0, seed=2)))
    base = create_network(tcfg, device="cpu", generator=torch.Generator().manual_seed(0))
    launches = []

    def counted(a, b):
        launches[-1] += 1
        return bn_stats(a, b)

    monkeypatch.setattr(batchnorm, "bn_stats", counted)
    out = []
    for remat in (False, True):
        launches.append(0)
        cfg = copy.deepcopy(tcfg)
        cfg.MODEL.REMAT = remat
        model = create_network(cfg, device="cpu")
        model.load_state_dict(base.state_dict())
        stages = [m for m in model.modules() if hasattr(m, "remat")]
        assert stages and all(m.remat == remat for m in stages)
        step = train_lib.make_train_step(model, train_lib.make_optimizer(model, cfg),
                                         cfg, regime)
        metrics = step(torch.from_numpy(batch["stack"]),
                       torch.from_numpy(batch["is_labeled"]), 0)
        grads = {n: p.grad.clone() for n, p in model.named_parameters()}
        out.append((metrics, grads, model.state_dict()))
    (m0, g0, s0), (m1, g1, s1) = out
    # the recompute ran every BatchNorm's forward again: 3 sums per
    # BatchNorm call instead of 2 (forward, backward)
    assert launches[0] > 0 and 2 * launches[1] == 3 * launches[0]
    assert {k: float(v) for k, v in m0.items()} == {k: float(v) for k, v in m1.items()}
    for key in g0:
        assert torch.equal(g0[key], g1[key]), key
    for key in s0:
        assert torch.equal(s0[key], s1[key]), key
    # one count per call: a Siamese stem or encoder (or the semantic
    # decoder) runs twice a step, every other BatchNorm once
    tracked = {int(v) for k, v in s1.items() if k.endswith("num_batches_tracked")}
    assert tracked == {1, 2}


@pytest.mark.parametrize("name,regime,model_type", REMAT_CASES,
                         ids=[c[2] for c in REMAT_CASES])
def test_remat_step_matches_jax(fixture_dataset, name, regime, model_type):
    """``MODEL.REMAT True`` in both packages: the port's checkpointed step
    equals the JAX package's ``jax.checkpoint`` step (tolerances in the
    module docstring), on a mixed batch for the semi-supervised model."""
    overrides, _ = _with(("MODEL.REMAT", "True"))
    s = _both(fixture_dataset, name, overrides)
    assert s.tcfg.MODEL.TYPE == model_type
    assert all(m.remat for m in s.tmodel.modules() if hasattr(m, "remat"))
    batch = _crops(s.jcfg, 1, 1) if regime == "semisupervised" else _crops(s.jcfg, 2, 0)
    _steps_match(s, regime, [batch], param_atol=1e-6)


# --- DATALOADER.WORKER_TYPE process ------------------------------------------------

def test_process_workers_build_the_thread_batches(fixture_dataset):
    """Two process workers (``forkserver``) and two threads give the same
    batches, byte for byte, over two epochs; ``close`` stops the pool."""
    _, tcfg = _cfgs(fixture_dataset, ("DATALOADER.INCLUDE_UNLABELED", "True"))
    ds = MultimodalCDDataset(tcfg, "training")
    threads = TrainLoader(ds, batch_size=2, num_workers=2, seed=3)
    procs = TrainLoader(ds, batch_size=2, num_workers=2, seed=3, worker_type="process")
    try:
        for _ in range(2):
            n = 0
            for tb, pb in zip(threads, procs):
                assert pb["stack"].dtype == tb["stack"].dtype
                assert pb["stack"].tobytes() == tb["stack"].tobytes()
                np.testing.assert_array_equal(pb["is_labeled"], tb["is_labeled"])
                assert pb["aoi_id"] == tb["aoi_id"]
                n += 1
            assert n == len(threads) > 0
        workers = list(procs._processes._processes.values())
        assert len(workers) == 2
        assert procs._processes._mp_context.get_start_method() == "forkserver"
    finally:
        procs.close()
    assert procs._processes is None
    for w in workers:
        w.join(timeout=30)
        assert not w.is_alive()


# --- TRAINER.PROFILE_DIR and the trainer's knob rule --------------------------------

def _cli_opts(out, fixture_dataset, extra=()):
    base = ["-c", "siamese", "-p", "proj", "-o", str(out), "-d",
            str(fixture_dataset), "--device", "cpu"]
    return base + fixture_cfg_overrides() + [
        "MODEL.TOPOLOGY", "[8, 16]", "TRAINER.BATCH_SIZE", "2",
        "TRAINER.PRECISION", "fp32"] + list(extra)


def test_profile_dir_writes_a_trace(fixture_dataset, tmp_path, capsys):
    """A 12-step CPU run with PROFILE_DIR: the profiler starts after step
    10 and, the run ending inside its window, the trainer closes it and
    writes a Chrome trace of steps [10, 12) into the directory."""
    out, prof = tmp_path / "out", tmp_path / "prof"
    out.mkdir()
    train_supervised.main(_cli_opts(out, fixture_dataset, [
        "DATALOADER.TRAINING_MULTIPLIER", "12", "TRAINER.EPOCHS", "1",
        "LOG_FREQ", "100", "SAVE_CHECKPOINTS", "[]",
        "TRAINER.PROFILE_DIR", str(prof)]))
    printed = capsys.readouterr().out
    assert "epoch float 1.0 (step 12) - epoch 1" in printed
    traces = list(prof.glob("*.json"))
    assert [t.name for t in traces] == ["steps_10-12.pt.trace.json"]
    events = json.loads(traces[0].read_text())["traceEvents"]
    assert any("conv" in str(e.get("name", "")) for e in events)


def test_resume_seam_relogs_the_unbroken_windows(fixture_dataset, tmp_path):
    """An unbroken 2-epoch run against a 1-epoch run plus a ``latest``
    resume: their epoch-2 window lines in ``{OUTPUT}/logs/{NAME}.jsonl``
    are identical but for the wall-clock fields (``time``, ``train_time``
    and the line's timestamp ``_t``)."""
    opts = ["LOG_FREQ", "1", "SAVE_CHECKPOINTS", "[1]"]
    unbroken, resumed = tmp_path / "unbroken", tmp_path / "resumed"
    for d in (unbroken, resumed):
        d.mkdir()
    train_supervised.main(_cli_opts(unbroken, fixture_dataset,
                                    opts + ["TRAINER.EPOCHS", "2"]))
    train_supervised.main(_cli_opts(resumed, fixture_dataset,
                                    opts + ["TRAINER.EPOCHS", "1"]))
    train_supervised.main(_cli_opts(resumed, fixture_dataset, opts + [
        "TRAINER.EPOCHS", "2", "TRAINER.RESUME_CHECKPOINT", "latest"]))

    def epoch2_windows(out):
        lines = [json.loads(l) for l in (out / "logs" / "siamese.jsonl")
                 .read_text().splitlines()]
        return [{k: v for k, v in r.items() if k not in ("time", "train_time", "_t")}
                for r in lines if "train_time" in r and r["epoch"] > 1]

    want = epoch2_windows(unbroken)
    assert len(want) == 2 and [r["step"] for r in want] == [3, 4]
    assert epoch2_windows(resumed) == want


def _set(cfg, key, value):
    section, name = key.split(".")
    cfg[section][name] = value


# each extension key the port reads, and the module that reads it
WORKING_KEYS = {
    "TRAINER.PRECISION": "models/factory.py",
    "TRAINER.GRAD_ACCUM": "train_lib.py",
    "TRAINER.EVAL_PAD_MULTIPLE": "evaluation.py",
    "TRAINER.PROFILE_DIR": "trainers.py",
    "TRAINER.RESUME_CHECKPOINT": "trainers.py",
    "TRAINER.SPATIAL_SHARDS": "parallel/group.py",
    "TRAINER.STEPS_PER_EXECUTION": "trainers.py",
    "TRAINER.WEDGE_TIMEOUT": "trainers.py",
    "MODEL.REMAT": "models/factory.py",
    "DATALOADER.WORKER_TYPE": "trainers.py",
    "DATALOADER.SCENE_CACHE": "data/cache.py",
    "DATALOADER.CACHE_DIR": "data/cache.py",
    "DATALOADER.CACHE_DTYPE": "data/cache.py",
}
# the values that make a key a declared no-op, and the line the trainer prints
DECLARED = {
    "MODEL.BN_AXIS_NAME": ("batch", "BN_AXIS_NAME=batch: no-op"),
    "MODEL.SYNC_BN": (False, "SYNC_BN=False: no-op on one device"),
    "MODEL.PACKED_FULLRES": (True, "PACKED_FULLRES=True: no-op"),
}


@pytest.mark.parametrize("key", sorted(config.EXTENSION_KEYS))
def test_every_extension_key_works_raises_or_is_declared(key, fixture_dataset, capsys):
    """No extension key is accepted silently: the port reads it, or the
    trainer prints it as a declared no-op when it starts."""
    assert set(WORKING_KEYS) | set(DECLARED) == set(config.EXTENSION_KEYS)
    assert not set(WORKING_KEYS) & set(DECLARED)
    _, cfg = _cfgs(fixture_dataset)
    for section in ("MODEL", "TRAINER"):
        for name in list(cfg[section]):
            if f"{section}.{name}" in DECLARED:
                del cfg[section][name]
    trainers.declare_knobs(cfg)
    assert capsys.readouterr().out == ""
    if key in WORKING_KEYS:
        from pathlib import Path

        src = Path(trainers.__file__).parent / WORKING_KEYS[key]
        assert f"'{key.split('.')[1]}'" in src.read_text().replace('"', "'"), key
        return
    value, line = DECLARED[key]
    _set(cfg, key, value)
    trainers.declare_knobs(cfg)
    assert line in capsys.readouterr().out


@pytest.mark.parametrize("n_space,crop", [(3, 32), (4, 30)])
def test_refused_spatial_grid_warns_like_jax_and_runs_data_parallel(
        fixture_dataset, capsys, n_space, crop):
    """A ``TRAINER.SPATIAL_SHARDS`` grid the world refuses (here a world of
    one rank; the JAX package's 8-device CPU mesh refuses the same keys, 8
    devices % 3 and crop 30 % 4) prints the JAX package's warning word for
    word (its ``_training_mesh``, trainers.py:64-66) and trains
    data-parallel: the grid is one space shard, and three steps equal the
    steps without the key bit for bit."""
    jcfg, tcfg = _cfgs(fixture_dataset)
    for cfg in (jcfg, tcfg):
        cfg.TRAINER.BATCH_SIZE = 4
        cfg.AUGMENTATION.CROP_SIZE = crop
        cfg.TRAINER.SPATIAL_SHARDS = n_space
    mesh = jax_trainers._training_mesh(jcfg)
    assert mesh.axis_names == ("data",)
    want = capsys.readouterr().out.splitlines()[0]
    assert want == (f"warning: device count / batch 4 / crop {crop} incompatible "
                    f"with SPATIAL_SHARDS={n_space}; falling back to data-parallel")
    trainers.declare_knobs(tcfg)
    assert want in capsys.readouterr().out.splitlines()
    grid = trainers.training_grid(tcfg)
    assert (grid.space_size, grid.data_size) == (1, 1)

    batch = next(iter(TrainLoader(MultimodalCDDataset(tcfg, "training"), 4,
                                  num_workers=0, seed=1)))
    stack, lab = torch.from_numpy(batch["stack"]), torch.from_numpy(batch["is_labeled"])
    base = create_network(tcfg, device="cpu",
                          generator=torch.Generator().manual_seed(0))
    runs = []
    for cfg in (tcfg, copy.deepcopy(tcfg)):
        if cfg is not tcfg:
            del cfg.TRAINER["SPATIAL_SHARDS"]
        model = copy.deepcopy(base)
        step = train_lib.make_supervised_train_step(model, train_lib.make_optimizer(
            model, cfg), cfg)
        runs.append(([float(step(stack, lab, i)["loss"]) for i in range(3)],
                     model.state_dict()))
    assert runs[0][0] == runs[1][0]
    for key, val in runs[0][1].items():
        assert torch.equal(val, runs[1][1][key]), key


def test_remat_on_siamunet_diff_is_declared(fixture_dataset, capsys):
    _, cfg = _cfgs(fixture_dataset)
    cfg.MODEL.TYPE = "siamunet_diff"
    cfg.MODEL.REMAT = True
    model = create_network(cfg, device="cpu")
    assert not any(getattr(m, "remat", False) for m in model.modules())
    trainers.declare_knobs(cfg)
    assert "REMAT=True: no-op for MODEL.TYPE siamunet_diff" in capsys.readouterr().out


def test_grad_accum_trains_through_run_training(fixture_dataset, tmp_path):
    """GRAD_ACCUM 2 and process workers through the CLI: a whole epoch of 3
    steps of 4 (2 labeled and 1 unlabeled AOI, 4 crops each) in one window,
    whose losses are finite and whose labeled share is the split's, 2/3:
    the trainer weighs the accumulated entries by the counts they carry."""
    out = tmp_path / "out"
    out.mkdir()
    argv = ["-c", "siamese_mmcr_alpha0500", "-p", "proj", "-o", str(out), "-d",
            str(fixture_dataset), "--device", "cpu"] + fixture_cfg_overrides() + [
        "MODEL.TOPOLOGY", "[8, 16]", "TRAINER.BATCH_SIZE", "4",
        "TRAINER.PRECISION", "fp32", "TRAINER.EPOCHS", "1", "LOG_FREQ", "3",
        "DATALOADER.TRAINING_MULTIPLIER", "4",
        "SAVE_CHECKPOINTS", "[]", "TRAINER.GRAD_ACCUM", "2",
        "DATALOADER.WORKER_TYPE", "process", "DATALOADER.NUM_WORKER", "2"]
    from multimodal_siamese_cd_tpu_torch import train_semisupervised

    train_semisupervised.main(argv)
    lines = [json.loads(l) for l in (out / "logs" / "siamese_mmcr_alpha0500.jsonl")
             .read_text().splitlines()]
    windows = [r for r in lines if "train_time" in r]
    assert len(windows) == 1 and windows[0]["step"] == 3
    keys = ("loss", "sup_loss", "cons_loss", "fusion_loss", "stream1_loss",
            "stream2_loss")
    assert all(np.isfinite(windows[0][k]) for k in keys)
    assert windows[0]["labeled_percentage"] == pytest.approx(200 / 3, abs=1e-9)
