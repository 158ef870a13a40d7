"""The port's semi-supervised path (``whatevernet`` and the rest of the
reference factory) against the JAX package's, on the CPU and the synthetic
fixture (``fixture_dataset``, with its unlabeled AOI), from one set of
weights.

JAX side at ``TRAINER.PRECISION fp32`` and ``MODEL.PACKED_FULLRES False``,
un-jitted steps, topology [8, 16], 32 px crops, batch 2; the port runs fp32
on the CPU with the plain ``bn_stats`` and the plain confusion counts.
Weights and BatchNorm running statistics are drawn with numpy and moved with
``weights.state_dict_from_jax``. Tolerances, each stated at its test:

* forward of ``whatevernet``, ``whatevernet2``, ``unet``,
  ``dualstreamunet``, train and eval mode: probabilities atol 1e-5;
* three semi-supervised steps (mixed, all-labeled, all-unlabeled batches):
  every metric atol 1e-5, every BN running statistic atol 1e-6 after every
  step (running means corrected for the pre-BN bias drift, as in the
  supervised test), every parameter atol 5e-6 after the third; one
  supervised step of ``unet`` and ``dualstreamunet`` the same way;
* window means, unlabeled crops, evaluation F1 and counts: exact;
* the CLI's checkpoint: the JAX package's reader restores the port's
  weights exactly.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_siamese_cd_tpu import evaluation as jax_eval
from multimodal_siamese_cd_tpu import torch_port
from multimodal_siamese_cd_tpu import train_lib as jax_train_lib
from multimodal_siamese_cd_tpu import trainers as jax_trainers
from multimodal_siamese_cd_tpu.config import load_cfg as jax_load_cfg
from multimodal_siamese_cd_tpu.data.dataset import MultimodalCDDataset as JaxDataset
from multimodal_siamese_cd_tpu.data.synthetic import fixture_cfg_overrides
from multimodal_siamese_cd_tpu.models import create_network as jax_create_network
from multimodal_siamese_cd_tpu.models import init_variables
from multimodal_siamese_cd_tpu_torch import (checkpoints, evaluation, train_lib,
                                             train_semisupervised, trainers,
                                             wandb_compat)
from multimodal_siamese_cd_tpu_torch.config import load_cfg
from multimodal_siamese_cd_tpu_torch.data.dataset import MultimodalCDDataset
from multimodal_siamese_cd_tpu_torch.models.factory import create_network
from multimodal_siamese_cd_tpu_torch.weights import state_dict_from_jax
from test_torch_port_train import _PRE_BN_BIAS, _bias_of, _random_variables, _sd

torch.set_num_threads(1)

TOPOLOGY = [8, 16]
SPLIT = "training"
# a shipped config of each new model type
CONFIGS = {"whatevernet": "siamese_mmcr_alpha0500",
           "whatevernet2": "unet_mmcr_alpha0500",
           "unet": "unet",
           "dualstreamunet": "baseline_dualstream"}
SEMISUP_KEYS = {"loss", "sup_loss", "cons_loss", "fusion_loss", "stream1_loss",
                "stream2_loss", "n_labeled", "n_notlabeled"}


def _cfgs(root, name, overrides=()):
    out = []
    for loader in (jax_load_cfg, load_cfg):
        cfg = loader(name)
        cfg.merge_from_list(fixture_cfg_overrides() + list(overrides))
        cfg.PATHS.DATASET = str(root)
        cfg.MODEL.TOPOLOGY = TOPOLOGY
        cfg.TRAINER.PRECISION = "fp32"
        cfg.TRAINER.BATCH_SIZE = 2
        cfg.MODEL.PACKED_FULLRES = False
        out.append(cfg)
    return out


def _both(root, name, overrides=(), seed=3):
    """JAX model, random variables and the port's model loaded with them."""
    jcfg, tcfg = _cfgs(root, name, overrides)
    jmodel = jax_create_network(jcfg)
    variables = _random_variables(jmodel, jcfg, seed=seed)
    tmodel = create_network(tcfg, device="cpu")
    tmodel.load_state_dict(state_dict_from_jax(variables), strict=True)
    return types.SimpleNamespace(jcfg=jcfg, tcfg=tcfg, jmodel=jmodel,
                                 variables=variables, tmodel=tmodel)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


# --- the models -----------------------------------------------------------------

@pytest.mark.parametrize("model_type", sorted(CONFIGS))
def test_converter_keys_load_strictly(fixture_dataset, model_type):
    """``state_dict_from_jax`` gives the JAX package's own exporter's keys
    and values for every new model, with the flax top-level names, and the
    port loads them with ``strict=True``."""
    s = _both(fixture_dataset, CONFIGS[model_type])
    assert s.tcfg.MODEL.TYPE == model_type
    ours = state_dict_from_jax(s.variables, step=4)
    ref = torch_port.export_reference_state_dict(s.variables, step=4)
    assert set(ours) == set(ref) == set(s.tmodel.state_dict())
    for key, val in ref.items():
        np.testing.assert_array_equal(ours[key].numpy(), val, err_msg=key)
    streams = {f"{part}_stream{i}" for part in ("inc", "encoder", "decoder")
               for i in (1, 2)}
    want = {"unet": {"inc", "encoder", "decoder", "outc"},
            "dualstreamunet": streams | {"outc"},
            "whatevernet": streams | {"outc_stream1", "outc_stream2", "outc_fusion"}}
    want["whatevernet2"] = want["whatevernet"]
    assert {k.split(".")[0] for k in ours} == want[model_type]
    # stem widths: S1 (2 bands) and S2 (4 bands) per date, doubled where a
    # stream stacks both dates; the fusion head reads both decoders
    inc = {k: tuple(v.shape) for k, v in ours.items() if k.endswith("conv.conv.0.weight")
           and k.startswith("inc")}
    want_in = {"unet": {"inc": 12}, "dualstreamunet": {"inc_stream1": 4, "inc_stream2": 8},
               "whatevernet": {"inc_stream1": 2, "inc_stream2": 4},
               "whatevernet2": {"inc_stream1": 4, "inc_stream2": 8}}[model_type]
    assert {k.split(".")[0]: v[1] for k, v in inc.items()} == want_in
    head = "outc" if model_type in ("unet", "dualstreamunet") else "outc_fusion"
    assert ours[f"{head}.conv.weight"].shape[1] == (8 if model_type == "unet" else 16)


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("model_type", sorted(CONFIGS))
def test_forward_matches_jax(fixture_dataset, model_type, train):
    """Train mode (batch statistics; whatevernet* return fusion, stream 1,
    stream 2) and eval mode (fusion alone) at an odd size, 37 x 45:
    probabilities atol 1e-5; in train mode the updated running statistics
    atol 1e-6."""
    s = _both(fixture_dataset, CONFIGS[model_type])
    rng = np.random.default_rng(37 + train)
    x1 = rng.uniform(0, 1, (2, 37, 45, 6)).astype(np.float32)
    x2 = rng.uniform(0, 1, (2, 37, 45, 6)).astype(np.float32)
    if train:
        want, updates = s.jmodel.apply(s.variables, x1, x2, train=True,
                                       mutable=["batch_stats"])
        s.tmodel.train()
        with torch.no_grad():
            got = s.tmodel(_nchw(x1), _nchw(x2))
        got = tuple(map(torch.sigmoid, got if isinstance(got, tuple) else (got,)))
    else:
        want = s.jmodel.apply(s.variables, x1, x2, train=False)
        got = (train_lib.eval_forward(s.tmodel, _nchw(x1), _nchw(x2)),)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want) == (3 if train and "whatevernet" in model_type else 1)
    for i, (g, w) in enumerate(zip(got, want)):
        w = np.asarray(jax.nn.sigmoid(w))
        assert g.shape == (2, 1, 37, 45) and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy()[:, 0], w[..., 0], atol=1e-5,
                                   err_msg=f"head {i}")
        assert w.std() > 0.01     # not vacuous
    if train:
        ours = s.tmodel.state_dict()
        for name, val in _sd(updates["batch_stats"], "batch_stats").items():
            np.testing.assert_allclose(ours[name].numpy(), val, atol=1e-6, rtol=0,
                                       err_msg=name)


# --- three semi-supervised steps ------------------------------------------------

def _batches(jcfg, kinds=("mixed", "labeled", "unlabeled")):
    """Batches of two crops from the JAX package's training dataset
    (crop-only stacks), in the order of ``kinds``: a mixed, an all-labeled
    and an all-unlabeled one. The labeled crops hold change pixels: on a
    crop without any, PowerJaccard's gradient is exactly zero, and AdamW's
    first step would turn the consistency term's tiny gradients into whole
    steps of either sign."""
    jds = JaxDataset(jcfg, "training", return_stack=True, crop_only=True)
    items = [jds.get(i, np.random.default_rng([seed, i]))
             for seed in (5, 6) for i in range(len(jds))]
    lab = [it for it in items if it["is_labeled"] and it["stack"][-1].any()]
    unl = [it for it in items if not it["is_labeled"]]
    pairs = {"mixed": lambda: (lab[0], unl[0]), "labeled": lambda: (lab[1], lab[2]),
             "unlabeled": lambda: (unl[-1], unl[-2])}
    out = []
    for kind in kinds:
        pair = pairs[kind]()
        out.append({"stack": np.stack([it["stack"] for it in pair]),
                    "is_labeled": np.asarray([it["is_labeled"] for it in pair],
                                             np.float32)})
    return out


# the AdamW state both packages resume from: step count, second moments
_ADAM_STEP, _ADAM_NU = 100, 1e-9


def _resumed_optimizers(s):
    """The JAX train state and the port's AdamW, both resuming from one
    mid-training AdamW state: step 100, zero first moments, every second
    moment 1e-9. From a fresh state, AdamW's first step moves every
    parameter by lr·g/|g|, so where a gradient entry is near zero its
    float32 roundoff in either package decides a move of up to lr = 1e-4
    (the supervised test's pre-BN biases); on a model with two modality
    streams such entries are common. Resumed, a step moves a parameter by
    about lr·g/1e-3: the comparison still sees moves far above its
    tolerance, and roundoff stays roundoff."""
    state = jax_train_lib.create_train_state(s.jcfg, jax.random.PRNGKey(0))[1]
    params = s.variables["params"]
    adam, *rest = state.tx.init(params)
    adam = adam._replace(
        count=jnp.asarray(_ADAM_STEP, adam.count.dtype),
        nu=jax.tree_util.tree_map(lambda p: jnp.full(p.shape, _ADAM_NU, p.dtype),
                                  params))
    state = state.replace(params=params, batch_stats=s.variables["batch_stats"],
                          opt_state=(adam, *rest))
    optimizer = train_lib.make_optimizer(s.tmodel, s.tcfg)
    for p in s.tmodel.parameters():
        optimizer.state[p] = {"step": torch.tensor(float(_ADAM_STEP)),
                              "exp_avg": torch.zeros_like(p),
                              "exp_avg_sq": torch.full_like(p, _ADAM_NU)}
    return state, optimizer


def _steps_match(s, regime, batches, check=None, param_atol=5e-6):
    """Run ``batches`` through the JAX step and the port's step from the same
    weights and AdamW state (:func:`_resumed_optimizers`); hold every
    metric (atol 1e-5) and BN running statistic (atol 1e-6, running means
    corrected for the pre-BN bias drift as in the supervised test: each
    update of a BN moves its offset to 0.9·offset + 0.1·d, with d the
    difference of the bias in front of it) after every step, and every
    parameter after the last (atol 5e-6). ``check(i, out)`` sees each
    step's port metrics; ``param_atol`` replaces the parameters'
    tolerance. Returns the BN calls per step of each BatchNorm."""
    state, optimizer = _resumed_optimizers(s)
    jstep = jax_train_lib.make_train_step(s.jmodel, s.jcfg, regime, jit=False)
    model = s.tmodel
    tstep = train_lib.make_train_step(model, optimizer, s.tcfg, regime)

    offset, calls = {}, {}
    for i, batch in enumerate(batches):
        ours = model.state_dict()
        dbias = {name: ours[name].double().numpy() - want
                 for name, want in _sd(state.params, "params").items()
                 if _PRE_BN_BIAS.search(name)}
        tracked = {k: int(v) for k, v in ours.items() if k.endswith("num_batches_tracked")}
        state, aux = jstep(state, jnp.asarray(batch["stack"]),
                           jnp.asarray(batch["is_labeled"]), jax.random.PRNGKey(0))
        out = tstep(torch.from_numpy(batch["stack"]),
                    torch.from_numpy(batch["is_labeled"]), i)
        assert set(out) == set(aux)
        for key in out:
            np.testing.assert_allclose(float(out[key]), float(aux[key]), atol=1e-5,
                                       err_msg=f"step {i} {key}")
        if check is not None:
            check(i, out)
        ours = model.state_dict()
        for name, want in _sd(state.batch_stats, "batch_stats").items():
            bn, stat = name.rsplit(".", 1)
            calls[bn] = int(ours[f"{bn}.num_batches_tracked"]) - tracked[
                f"{bn}.num_batches_tracked"]
            got = ours[name].double().numpy()
            if stat == "running_mean":
                for _ in range(calls[bn]):
                    offset[bn] = 0.9 * offset.get(bn, 0.0) + 0.1 * dbias[_bias_of(bn)]
                got = got - offset[bn]
            np.testing.assert_allclose(got, want, atol=1e-6, rtol=0,
                                       err_msg=f"step {i} {name}")

    ours = model.state_dict()
    init = _sd(s.variables["params"], "params")
    moved = 0.0
    for name, want in _sd(state.params, "params").items():
        np.testing.assert_allclose(ours[name].numpy(), want, atol=param_atol,
                                   err_msg=name)
        moved = max(moved, float(np.abs(want - init[name]).max()))
    assert moved > 10 * param_atol     # the steps moved parameters far past it
    return calls


_FLIPS_OFF = ("AUGMENTATION.RANDOM_FLIP", "False", "AUGMENTATION.RANDOM_ROTATE", "False")


@pytest.mark.parametrize("name,overrides", [
    ("siamese_mmcr_alpha0500", ()),
    ("siamese_mmcr_alpha0500", ("CONSISTENCY_TRAINER.LOSS_TYPE", "L2")),
    ("siamese_mmcr_alpha0500", ("CONSISTENCY_TRAINER.LOSS_FACTOR", "0.0")),
    ("siamese_mmcr_alpha0500", ("CONSISTENCY_TRAINER.LOSS_TYPE", "L2",
                                "CONSISTENCY_TRAINER.LOSS_FACTOR", "0.0")),
    ("dtsiamese_ssl", ()),
], ids=["whatevernet-pj-a0.5", "whatevernet-l2-a0.5", "whatevernet-pj-a0",
        "whatevernet-l2-a0", "dtsiameseunet-pj-a0.1"])
def test_semisupervised_steps_match_jax(fixture_dataset, name, overrides):
    """Mixed, all-labeled and all-unlabeled batches, flips and rotations
    off: the port's step equals the JAX package's (tolerances at
    :func:`_steps_match`). On the all-labeled batch ``cons_loss`` is 0 and
    ``loss == sup_loss``; on the all-unlabeled one the converse. The
    Siamese stems and encoders update their running statistics twice a
    step (one call per date), each decoder once."""
    s = _both(fixture_dataset, name, _FLIPS_OFF + overrides)
    batches = _batches(s.jcfg)
    lab_counts = [(2.0, 0.0) if i == 1 else (0.0, 2.0) if i == 2 else (1.0, 1.0)
                  for i in range(3)]

    def check(i, out):
        assert set(out) == SEMISUP_KEYS
        assert (float(out["n_labeled"]), float(out["n_notlabeled"])) == lab_counts[i]
        if i == 1:
            assert float(out["cons_loss"]) == 0.0
            assert float(out["loss"]) == float(out["sup_loss"])
        if i == 2:
            for key in ("sup_loss", "fusion_loss", "stream1_loss", "stream2_loss"):
                assert float(out[key]) == 0.0, key
            assert float(out["loss"]) == float(out["cons_loss"]) > 0
        if i in (0, 1) and s.tcfg.CONSISTENCY_TRAINER.LOSS_FACTOR > 0:
            assert float(out["sup_loss"]) > 0

    calls = _steps_match(s, "semisupervised", batches, check)
    for bn, n in calls.items():
        assert n == (1 if bn.startswith(("decoder_stream", "decoder_change")) else 2), bn


@pytest.mark.parametrize("model_type", ["unet", "dualstreamunet"])
def test_supervised_step_matches_jax(fixture_dataset, model_type):
    """One supervised step of each early-fusion model (tolerances at
    :func:`_steps_match`): every BatchNorm runs once a step."""
    s = _both(fixture_dataset, CONFIGS[model_type], _FLIPS_OFF)
    calls = _steps_match(s, "supervised", _batches(s.jcfg, ("labeled",)))
    assert calls and set(calls.values()) == {1}


def test_whatevernet2_step_matches_jax(fixture_dataset):
    """One mixed semi-supervised step of the early-fusion streams
    (tolerances at :func:`_steps_match`)."""
    s = _both(fixture_dataset, CONFIGS["whatevernet2"], _FLIPS_OFF)
    calls = _steps_match(s, "semisupervised", _batches(s.jcfg, ("mixed",)))
    assert calls and set(calls.values()) == {1}


# --- the trainer's window means ---------------------------------------------------

def test_semisup_window_means_review_case():
    """The JAX package's own case (tests/test_review_fixes.py): component
    means ignore the batches that lack their partition."""
    sets = {"fusion_loss": [0.8, 0.0], "stream1_loss": [0.6, 0.0],
            "stream2_loss": [0.4, 0.0], "sup_loss": [0.5, 0.0],
            "cons_loss": [0.0, 0.3], "loss": [0.5, 0.3]}
    label_counts = [(2.0, 0.0), (0.0, 2.0)]
    ours = trainers._semisup_window_means(sets, label_counts)
    assert ours == jax_trainers._semisup_window_means(sets, label_counts)
    assert ours["fusion_loss"] == pytest.approx(0.8)
    assert ours["cons_loss"] == pytest.approx(0.3)
    assert ours["loss"] == pytest.approx(0.4)
    assert ours["labeled_percentage"] == pytest.approx(50.0)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_semisup_window_means_match_jax(seed):
    """Random windows of 1-12 batches of 4, with all-labeled, all-unlabeled
    and mixed batches, as the step writes them (0 for an absent
    partition): equal to the JAX package's reduction; the trainer's
    one-fetch summary of device scalars gives the same."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 13))
    n_lab = rng.integers(0, 5, n).astype(np.float64)
    if seed == 0:
        n_lab[:] = 4.0                  # no unlabeled batch in the window
    label_counts = [(float(a), 4.0 - float(a)) for a in n_lab]
    sets = {k: [] for k in trainers._REGIMES["semisupervised"]["keys"]}
    for a, b in label_counts:
        sup = rng.uniform(0.1, 1) * (a > 0)
        cons = rng.uniform(0.1, 1) * (b > 0)
        for key in ("fusion_loss", "stream1_loss", "stream2_loss"):
            sets[key].append(rng.uniform(0.1, 1) * (a > 0))
        sets["sup_loss"].append(sup)
        sets["cons_loss"].append(cons)
        sets["loss"].append(sup + cons)
    ours = trainers._semisup_window_means(sets, label_counts)
    want = jax_trainers._semisup_window_means(sets, label_counts)
    assert ours == want
    f32 = {k: [np.float32(v) for v in vals] for k, vals in sets.items()}
    fetched = trainers._window_summary(
        {k: [torch.tensor(v) for v in vals] for k, vals in f32.items()},
        [(torch.tensor(a, dtype=torch.float32), torch.tensor(b, dtype=torch.float32))
         for a, b in label_counts], True)
    assert fetched == jax_trainers._semisup_window_means(f32, label_counts)


# --- unlabeled training crops -------------------------------------------------------

@pytest.mark.parametrize("name", ["siamese_mmcr_alpha0500", "dtsiamese_ssl"])
def test_unlabeled_crops_match_jax(fixture_dataset, name):
    """For the same numpy generator, every training item of a config with
    unlabeled AOIs (dtsiamese_ssl also takes the validation AOIs as
    unlabeled, and building planes) is byte for byte the JAX package's
    ``crop_only=True, return_stack=True`` item, ``is_labeled`` included;
    unlabeled items have zero label planes."""
    jcfg, tcfg = _cfgs(fixture_dataset, name)
    jds = JaxDataset(jcfg, "training", crop_only=True, return_stack=True)
    tds = MultimodalCDDataset(tcfg, "training")
    assert len(tds) == len(jds) and tds.labeled == list(jds.labeled)
    n_unl = 0
    for i in range(len(tds)):
        ji = jds.get(i, np.random.default_rng([9, i]))
        ti = tds.get(i, np.random.default_rng([9, i]))
        assert ti["stack"].dtype == ji["stack"].dtype
        assert ti["stack"].tobytes() == ji["stack"].tobytes()
        for key in ("aoi_id", "year_t1", "month_t1", "year_t2", "month_t2",
                    "is_labeled"):
            assert ti[key] == ji[key], key
        if not ti["is_labeled"]:
            n_unl += 1
            assert not ti["stack"][-3:].any()
            assert ti["stack"][:-3].any()
    assert n_unl == (2 if name == "siamese_mmcr_alpha0500" else 4)


# --- the trainer and the CLI -----------------------------------------------------------

def _records(path):
    import json
    return [r for r in map(json.loads, path.read_text().splitlines())
            if "_event" not in r]


def test_run_training_semisupervised(fixture_dataset, tmp_path, capsys):
    """``run_training(cfg, 'semisupervised', device='cpu')``: each LOG_FREQ
    window logs the JAX package's window keys; over the whole epoch the
    labeled share is the split's, 4 of 6 samples. A DEBUG run takes one
    step, runs no test evaluation before the epoch's end, and still writes
    its checkpoint."""
    _, tcfg = _cfgs(fixture_dataset, "siamese_mmcr_alpha0500")
    tcfg.TRAINER.EPOCHS = 1
    tcfg.SAVE_CHECKPOINTS = [1]
    tcfg.LOG_FREQ = 1
    window_keys = set(jax_trainers._semisup_window_means(
        {k: [0.5] for k in trainers._REGIMES["semisupervised"]["keys"]},
        [(1.0, 1.0)])) | {"time", "train_time", "step", "epoch"}
    for debug in (False, True):
        out = tmp_path / f"debug{debug}"
        out.mkdir()
        cfg = tcfg.clone()
        cfg.PATHS.OUTPUT = str(out)
        cfg.DEBUG = debug
        wandb_compat.init(name=cfg.NAME, config=cfg, mode="jsonl", out_dir=out)
        try:
            trainers.run_training(cfg, "semisupervised", device="cpu")
        finally:
            wandb_compat.finish()
        records = _records(out / "logs" / f"{cfg.NAME}.jsonl")
        windows = [r for r in records if "train_time" in r]
        printed = capsys.readouterr().out
        assert checkpoints.checkpoint_file(cfg, 1).is_file()
        if debug:
            assert "epoch float 0.3333333333333333 (step 1) - epoch 1" in printed
            assert not windows
            assert [r["step"] for r in records if "test F1" in r] == [1]
            continue
        assert len(windows) == 3
        for r in windows:
            assert set(r) - {"_t"} == window_keys, r      # _t: the log's clock
            assert all(np.isfinite(r[k]) for k in window_keys)
        share = np.mean([r["labeled_percentage"] for r in windows])
        assert share == pytest.approx(100 * 4 / 6, abs=1e-9)
        assert any(r["cons_loss"] > 0 for r in windows)
        assert any(r["sup_loss"] > 0 for r in windows)


def test_cli_checkpoint_round_trip(fixture_dataset, tmp_path):
    """``train_semisupervised --device cpu`` trains one epoch and writes a
    checkpoint that the JAX package's ``torch_port.load_reference_checkpoint``
    reads into flax ``whatevernet`` variables, weight for weight; without
    ``--device``, on a host with no card, it raises instead of training on
    the CPU."""
    opts = fixture_cfg_overrides() + [
        "MODEL.TOPOLOGY", "[8, 16]", "TRAINER.BATCH_SIZE", "2",
        "TRAINER.PRECISION", "fp32", "TRAINER.EPOCHS", "1",
        "SAVE_CHECKPOINTS", "[1]", "LOG_FREQ", "3"]
    out = tmp_path / "out"
    out.mkdir()
    base = ["-c", "siamese_mmcr_alpha0500", "-p", "proj", "-o", str(out), "-d",
            str(fixture_dataset)]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            train_semisupervised.main(base + opts)
        assert not (out / "networks").exists()
    train_semisupervised.main(base + ["--device", "cpu"] + opts)
    log = (out / "logs" / "siamese_mmcr_alpha0500.jsonl").read_text()
    for key in ('"cons_loss"', '"sup_loss"', '"fusion_loss"', '"labeled_percentage"',
                '"test F1"'):
        assert key in log, key

    ckpt = out / "networks" / "siamese_mmcr_alpha0500_checkpoint1.pt"
    jcfg, tcfg = _cfgs(fixture_dataset, "siamese_mmcr_alpha0500")
    jmodel = jax_create_network(jcfg)
    variables = jax.eval_shape(lambda: init_variables(jmodel, jcfg, jax.random.PRNGKey(0)))
    variables = jax.tree_util.tree_map(lambda a: np.zeros(a.shape, a.dtype), variables)
    ported, step = torch_port.load_reference_checkpoint(ckpt, variables)
    assert step == 3
    assert set(ported["params"]) == {"inc_stream1", "inc_stream2", "encoder_stream1",
                                     "encoder_stream2", "decoder_stream1",
                                     "decoder_stream2", "outc_stream1",
                                     "outc_stream2", "outc_fusion"}
    tcfg.PATHS.OUTPUT = str(out)
    model, _, step = checkpoints.load_checkpoint(1, tcfg, device="cpu")
    assert step == 3 and type(model).__name__ == "WhateverNet"
    back = state_dict_from_jax(jax.device_get(ported))
    for name, val in model.state_dict().items():
        if not name.endswith("num_batches_tracked"):
            np.testing.assert_array_equal(back[name].numpy(), val.numpy(), err_msg=name)


# --- in-training evaluation ------------------------------------------------------------

def test_model_evaluation_matches_jax(fixture_dataset):
    """``model_evaluation`` of ``whatevernet`` (its fusion head) gives the
    JAX package's F1, and the measurer's counts equal the JAX package's,
    exactly. The fusion head's bias is centred on its median logit over the
    first scene, so about half the pixels are predicted positive."""
    s = _both(fixture_dataset, "siamese_mmcr_alpha0500", seed=17)
    kw = dict(no_augmentations=True, dataset_mode="first_last",
              disable_multiplier=True, disable_unlabeled=True)
    jds = JaxDataset(s.jcfg, SPLIT, **kw)
    item = jds[0]
    logits = s.jmodel.apply(s.variables, item["x_t1"][None], item["x_t2"][None],
                            train=False)
    bias = s.variables["params"]["outc_fusion"]["conv"]["bias"]
    s.variables["params"]["outc_fusion"]["conv"]["bias"] = \
        bias - np.float32(np.median(np.asarray(logits)))
    s.tmodel.load_state_dict(state_dict_from_jax(s.variables), strict=True)
    state = types.SimpleNamespace(params=s.variables["params"],
                                  batch_stats=s.variables["batch_stats"])

    f1 = evaluation.model_evaluation(s.tmodel, s.tcfg, SPLIT, 0.0, 0, device="cpu")
    assert f1 == jax_eval.model_evaluation(s.jmodel, state, s.jcfg, SPLIT, 0.0, 0)
    assert 0.0 < f1 < 1.0
    tds = MultimodalCDDataset(s.tcfg, SPLIT, **kw)
    thr = np.linspace(0.5, 1, 1)
    ours = evaluation.run_measurer(s.tmodel, tds, thr, device="cpu")
    want = jax_eval.run_measurer(s.jmodel, state, jds, thr)
    for name in ("TP", "TN", "FP", "FN"):
        np.testing.assert_array_equal(getattr(ours, name),
                                      np.asarray(getattr(want, name)), err_msg=name)
