"""The port's dual-task path (``dtsiameseunet``) against the JAX package's, on
the CPU and the synthetic fixture (``fixture_dataset``), from one set of
weights.

JAX side at ``TRAINER.PRECISION fp32`` and ``MODEL.PACKED_FULLRES False``,
topology [8, 16], 32 px crops, batch 2; the port runs fp32 on the CPU with
the plain ``bn_stats`` and the plain strict counts. Weights and BatchNorm
running statistics are drawn with numpy and moved with
``weights.state_dict_from_jax``. Tolerances, each stated at its test:

* forward: the four heads' probabilities atol 1e-5;
* strict counts, pooled dual-task counts, F1: exact;
* three dual-task steps: losses atol 1e-5, every BN running statistic atol
  1e-6 after every step, every parameter atol 5e-6 after the third, and
  the change of the auxiliary head, which only weight decay moves, rtol
  0.15;
* the CLI's checkpoint: the JAX package's reader restores the port's
  weights exactly.
"""

import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_siamese_cd_tpu import evaluation as jax_eval
from multimodal_siamese_cd_tpu import metrics as jax_metrics
from multimodal_siamese_cd_tpu import torch_port
from multimodal_siamese_cd_tpu import train_lib as jax_train_lib
from multimodal_siamese_cd_tpu import trainers as jax_trainers
from multimodal_siamese_cd_tpu.config import load_cfg as jax_load_cfg
from multimodal_siamese_cd_tpu.data.dataset import MultimodalCDDataset as JaxDataset
from multimodal_siamese_cd_tpu.data.loader import TrainLoader as JaxTrainLoader
from multimodal_siamese_cd_tpu.data.synthetic import fixture_cfg_overrides
from multimodal_siamese_cd_tpu.models import create_network as jax_create_network
from multimodal_siamese_cd_tpu.models import init_variables
from multimodal_siamese_cd_tpu_torch import (checkpoints, evaluation, metrics,
                                             train_lib, train_supervised_dualtask,
                                             trainers)
from multimodal_siamese_cd_tpu_torch.config import load_cfg
from multimodal_siamese_cd_tpu_torch.data.dataset import MultimodalCDDataset
from multimodal_siamese_cd_tpu_torch.models.factory import create_network
from multimodal_siamese_cd_tpu_torch.ops import confusion
from multimodal_siamese_cd_tpu_torch.weights import state_dict_from_jax
from test_torch_port_kernels import _inputs, _torch
from test_torch_port_train import _PRE_BN_BIAS, _bias_of, _random_variables, _sd

torch.set_num_threads(1)

TOPOLOGY = [8, 16]
SPLIT = "training"   # the fixture's two labeled AOIs (80x96 and 88x104)
HEADS = ("change", "sem_t1", "sem_t2", "change_sem")


def _cfgs(root, overrides=()):
    out = []
    for loader in (jax_load_cfg, load_cfg):
        cfg = loader("dtsiamese")
        cfg.merge_from_list(fixture_cfg_overrides() + list(overrides))
        cfg.PATHS.DATASET = str(root)
        cfg.MODEL.TOPOLOGY = TOPOLOGY
        cfg.TRAINER.PRECISION = "fp32"
        cfg.TRAINER.BATCH_SIZE = 2
        cfg.MODEL.PACKED_FULLRES = False
        out.append(cfg)
    return out


def _eval_datasets(root):
    kw = dict(no_augmentations=True, dataset_mode="first_last",
              disable_multiplier=True, disable_unlabeled=True)
    jcfg, tcfg = _cfgs(root)
    return JaxDataset(jcfg, SPLIT, **kw), MultimodalCDDataset(tcfg, SPLIT, **kw)


def _jax_heads(jmodel, variables, x1, x2):
    """The JAX package's four sigmoid heads, NHWC."""
    change, sem_t1, sem_t2 = jmodel.apply(variables, x1, x2, train=False)
    change_sem = jmodel.apply(variables, sem_t1, sem_t2,
                              method=jmodel.sem_change_head)
    return {k: np.asarray(jax.nn.sigmoid(v)) for k, v in
            zip(HEADS, (change, sem_t1, sem_t2, change_sem))}


@pytest.fixture(scope="module")
def models(fixture_dataset):
    """JAX model and variables and the port's model with the same random
    weights and BN statistics; every head's bias is centred on its median
    logit over the first scene, so about half its pixels are predicted
    positive and every count is far from trivial."""
    jcfg, tcfg = _cfgs(fixture_dataset)
    jmodel = jax_create_network(jcfg)
    variables = _random_variables(jmodel, jcfg, seed=17)
    item = _eval_datasets(fixture_dataset)[0][0]
    x1, x2 = item["x_t1"][None], item["x_t2"][None]
    for head in ("outc_change", "outc_sem"):
        logits = jmodel.apply(variables, x1, x2, train=False)
        logits = logits[0] if head == "outc_change" else jnp.concatenate(logits[1:])
        bias = variables["params"][head]["conv"]["bias"]
        variables["params"][head]["conv"]["bias"] = \
            bias - np.float32(np.median(np.asarray(logits)))
    _, sem_t1, sem_t2 = jmodel.apply(variables, x1, x2, train=False)
    logits = jmodel.apply(variables, sem_t1, sem_t2, method=jmodel.sem_change_head)
    bias = variables["params"]["outc_sem_change"]["conv"]["bias"]
    variables["params"]["outc_sem_change"]["conv"]["bias"] = \
        bias - np.float32(np.median(np.asarray(logits)))
    tmodel = create_network(tcfg, device="cpu")
    tmodel.load_state_dict(state_dict_from_jax(variables), strict=True)
    return jmodel, variables, tmodel


# --- the model ----------------------------------------------------------------

def test_converter_keys_load_strictly(models):
    """``weights.state_dict_from_jax`` maps ``decoder_change``,
    ``decoder_sem``, ``outc_change``, ``outc_sem`` and ``outc_sem_change``
    to the JAX package's own exporter's keys, and the port loads them with
    ``strict=True``."""
    _, variables, tmodel = models
    ours = state_dict_from_jax(variables, step=4)
    ref = torch_port.export_reference_state_dict(variables, step=4)
    assert set(ours) == set(ref) == set(tmodel.state_dict())
    for key, val in ref.items():
        np.testing.assert_array_equal(ours[key].numpy(), val, err_msg=key)
    tops = {k.split(".")[0] for k in ours}
    assert tops == {"inc", "encoder", "decoder_change", "decoder_sem",
                    "outc_change", "outc_sem", "outc_sem_change"}
    assert tuple(ours["outc_sem_change.conv.weight"].shape) == (1, 2, 1, 1)


@pytest.mark.parametrize("h,w", [(68, 76), (33, 47)])
def test_forward_heads_match_jax(models, h, w):
    """All three heads and the auxiliary head, eval mode: probabilities
    atol 1e-5 (float32 convolutions summed in another order)."""
    jmodel, variables, tmodel = models
    rng = np.random.default_rng(h * w)
    x1 = rng.uniform(0, 1, (2, h, w, 6)).astype(np.float32)
    x2 = rng.uniform(0, 1, (2, h, w, 6)).astype(np.float32)
    want = _jax_heads(jmodel, variables, x1, x2)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))  # noqa: E731
    got = evaluation._dualtask_forward(tmodel, t(x1), t(x2))
    for name, g in zip(HEADS, got):
        assert g.shape == (2, 1, h, w) and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy()[:, 0], want[name][..., 0], atol=1e-5,
                                   err_msg=name)
        assert want[name].std() > 0.01, name     # not vacuous
    # eval_forward takes the change head of the tuple
    probs = train_lib.eval_forward(tmodel, t(x1), t(x2))
    assert torch.equal(probs, got[0])


# --- strict counts --------------------------------------------------------------

@pytest.mark.parametrize("thr", [0.5, 0.3])
def test_strict_counts_match_jax(thr):
    """``metrics.strict_confusion_counts`` and the plain kernel version
    against the JAX function, on ties and +-1 ulp neighbours of the
    threshold and a valid mask with holes: equal."""
    probs, y, valid, thrs = _inputs(int(thr * 10), 3, 2000, [thr])
    got = confusion.strict_confusion_counts(*_torch(probs, y, valid, thrs))
    for b in range(3):
        want = jax_metrics.strict_confusion_counts(y[b], probs[b],
                                                   valid[b].astype(np.float32), thr)
        ours = metrics.strict_confusion_counts(torch.from_numpy(y[b]),
                                               torch.from_numpy(probs[b]),
                                               torch.from_numpy(valid[b]), thr)
        assert [float(v) for v in ours] == [float(v) for v in want]
        tp, tn, fp, fn = got[b, :, 0].tolist()
        assert [tp, fp, fn] == [float(v) for v in want]
        assert tp + tn + fp + fn == int(valid[b].sum())
    no_mask = metrics.strict_confusion_counts(torch.from_numpy(y[0]),
                                              torch.from_numpy(probs[0]))
    want = jax_metrics.strict_confusion_counts(y[0], probs[0])
    assert [float(v) for v in no_mask] == [float(v) for v in want]


def test_prob_metrics_from_counts_match_jax():
    for counts in ((1234.0, 56.0, 789.0), (0.0, 3.0, 4.0), (7.0, 0.0, 0.0)):
        ours = metrics.prob_metrics_from_counts(*counts)
        want = jax_metrics.prob_metrics_from_counts(*map(np.float64, counts))
        np.testing.assert_array_equal(np.asarray(ours), np.asarray(want))


# --- the assessment path --------------------------------------------------------

def test_eval_wire_sem_planes_match_jax(fixture_dataset):
    jds, tds = _eval_datasets(fixture_dataset)
    for i in range(len(tds)):
        jw, tw = jds.eval_wire(i, 64, sem=True), tds.eval_wire(i, 64, sem=True)
        assert set(tw) == set(jw)
        for key in ("x1", "x2", "y", "ysem1", "ysem2", "valid"):
            assert tw[key].dtype == jw[key].dtype, key
            np.testing.assert_array_equal(tw[key], jw[key], err_msg=key)
        assert tw["ysem1"].any() and tw["ysem2"].any()
        assert "ysem1" not in tds.eval_wire(i, 64)


def test_dualtask_counts_and_model_evaluation_match_jax(fixture_dataset, models):
    """Pooled strict counts of every block and their F1 / precision /
    recall equal the JAX package's; ``model_evaluation`` of the change head
    gives the JAX package's F1; one scene's four heads agree to 1e-5."""
    jmodel, variables, tmodel = models
    state = types.SimpleNamespace(params=variables["params"],
                                  batch_stats=variables["batch_stats"])
    jds, tds = _eval_datasets(fixture_dataset)
    ours = evaluation.dualtask_quantitative_counts(tmodel, tds, device="cpu")
    want = jax_eval.dualtask_quantitative_counts(jmodel, state, jds)
    assert set(ours) == set(want) == {"change", "change_sem", "sem"}
    for key in ours:
        assert ours[key] == tuple(float(v) for v in want[key]), key
        assert 0 < ours[key][0] and 0 < ours[key][1] and 0 < ours[key][2], key
        assert metrics.prob_metrics_from_counts(*ours[key]) == \
            jax_metrics.prob_metrics_from_counts(*want[key])

    jcfg, tcfg = _cfgs(fixture_dataset)
    f1 = evaluation.model_evaluation(tmodel, tcfg, SPLIT, 0.0, 0, device="cpu")
    assert f1 == jax_eval.model_evaluation(jmodel, state, jcfg, SPLIT, 0.0, 0)

    heads = evaluation.dualtask_scene_outputs(tmodel, tds[1], device="cpu")
    ref = jax_eval.dualtask_scene_outputs(jmodel, state, jds[1])
    for name in HEADS:
        assert heads[name].shape == tds[1]["x_t1"].shape[:2]
        np.testing.assert_allclose(heads[name], ref[name], atol=1e-5, err_msg=name)

    # a dataset without the wire path (cache off) has no fused counts
    tcfg.DATALOADER.SCENE_CACHE = False
    off = MultimodalCDDataset(tcfg, SPLIT, no_augmentations=True,
                              dataset_mode="first_last", disable_multiplier=True,
                              disable_unlabeled=True)
    assert evaluation.dualtask_quantitative_counts(tmodel, off, device="cpu") is None


# --- three dual-task steps ------------------------------------------------------

@pytest.fixture(scope="module")
def step_setup(fixture_dataset):
    overrides = ("AUGMENTATION.RANDOM_FLIP", "False",
                 "AUGMENTATION.RANDOM_ROTATE", "False")
    jcfg, tcfg = _cfgs(fixture_dataset, overrides)
    jmodel = jax_create_network(jcfg)
    variables = _random_variables(jmodel, jcfg)
    jds = JaxDataset(jcfg, "training", return_stack=True, crop_only=True)
    batches = list(JaxTrainLoader(jds, batch_size=2, num_workers=0, seed=5))
    batches += list(JaxTrainLoader(jds, batch_size=2, num_workers=0, seed=6))
    return types.SimpleNamespace(jcfg=jcfg, tcfg=tcfg, jmodel=jmodel,
                                 variables=variables, batches=batches[:3])


def _updates_per_step(bn: str) -> int:
    """Train-mode calls of a BatchNorm per dual-task step: the change
    decoder runs once; the stem, the encoder and the semantic decoder run
    on both dates."""
    return 1 if bn.startswith("decoder_change.") else 2


def test_dualtask_steps_match_jax(step_setup):
    """Losses atol 1e-5 at every step; every BN running statistic atol 1e-6
    after every step (running means corrected, as in the supervised test,
    for the offset that AdamW's roundoff steps on pre-BN biases make);
    every parameter after three steps atol 5e-6, pre-BN biases within their
    roundoff bound. The auxiliary head ``outc_sem_change`` takes no part in
    the loss: only weight decay moves it, p <- p·(1 - lr·wd) per step in
    both packages."""
    s = step_setup
    state = jax_train_lib.create_train_state(s.jcfg, jax.random.PRNGKey(0))[1]
    state = state.replace(params=s.variables["params"],
                          batch_stats=s.variables["batch_stats"],
                          opt_state=state.tx.init(s.variables["params"]))
    jstep = jax_train_lib.make_dualtask_train_step(s.jmodel, s.jcfg, jit=False)
    model = create_network(s.tcfg, device="cpu")
    model.load_state_dict(state_dict_from_jax(s.variables), strict=True)
    optimizer = train_lib.make_optimizer(model, s.tcfg)
    tstep = train_lib.make_train_step(model, optimizer, s.tcfg, "dualtask")
    aux_head0 = model.outc_sem_change.conv.weight.detach().clone()

    offset = {}
    for i, batch in enumerate(s.batches):
        ours = model.state_dict()
        dbias = {name: ours[name].double().numpy() - want
                 for name, want in _sd(state.params, "params").items()
                 if _PRE_BN_BIAS.search(name)}
        state, aux = jstep(state, jnp.asarray(batch["stack"]),
                           jnp.asarray(batch["is_labeled"]), jax.random.PRNGKey(0))
        out = tstep(torch.from_numpy(batch["stack"]),
                    torch.from_numpy(batch["is_labeled"]), i)
        assert set(out) == {"loss", "change_loss", "sem_loss"}
        for key in out:
            np.testing.assert_allclose(float(out[key]), float(aux[key]), atol=1e-5,
                                       err_msg=f"step {i} {key}")
        ours = model.state_dict()
        for name, want in _sd(state.batch_stats, "batch_stats").items():
            bn, stat = name.rsplit(".", 1)
            got = ours[name].double().numpy()
            if stat == "running_mean":
                for _ in range(_updates_per_step(bn)):
                    offset[bn] = 0.9 * offset.get(bn, 0.0) + 0.1 * dbias[_bias_of(bn)]
                got = got - offset[bn]
            np.testing.assert_allclose(got, want, atol=1e-6, rtol=0,
                                       err_msg=f"step {i} {name}")

    ours = model.state_dict()
    lr = s.tcfg.TRAINER.LR
    for name, want in _sd(state.params, "params").items():
        if _PRE_BN_BIAS.search(name):
            assert np.abs(ours[name].numpy() - want).max() <= 2 * 3 * lr
        else:
            np.testing.assert_allclose(ours[name].numpy(), want, atol=5e-6,
                                       err_msg=name)
    # the auxiliary head moved by weight decay alone: 3e-6 of its value in
    # three steps, far inside the atol above, so its change is compared on
    # its own (float32 rounds each step's change to ~2% of it: rtol 0.15)
    init = aux_head0.double().numpy()
    moved = ours["outc_sem_change.conv.weight"].double().numpy() - init
    want = _sd(state.params, "params")["outc_sem_change.conv.weight"] - init
    np.testing.assert_allclose(moved, want, rtol=0.15)
    np.testing.assert_allclose(moved, init * ((1 - lr * 0.01) ** 3 - 1), rtol=0.15)
    assert np.abs(moved).min() > 0
    for name, calls in (("inc.conv.conv.1", 2), ("decoder_change.up_seq.up1.conv.conv.1", 1),
                        ("decoder_sem.up_seq.up1.conv.conv.1", 2)):
        assert int(ours[f"{name}.num_batches_tracked"]) == calls * len(s.batches)


def test_torch_adamw_alone_skips_the_unused_head(step_setup):
    """The trap the step's zero gradients avoid: ``torch.optim.AdamW``
    skips a parameter whose gradient is None, so without them the
    auxiliary head would keep its initial weights while optax decays
    them."""
    s = step_setup
    model = create_network(s.tcfg, device="cpu")
    model.load_state_dict(state_dict_from_jax(s.variables), strict=True)
    optimizer = train_lib.make_optimizer(model, s.tcfg)
    before = model.outc_sem_change.conv.weight.detach().clone()
    train_lib.make_train_step(model, optimizer, s.tcfg, "dualtask")(
        torch.from_numpy(s.batches[0]["stack"]), None, 0)
    model.outc_sem_change.conv.weight.grad = None
    model.outc_sem_change.conv.bias.grad = None
    moved = model.outc_sem_change.conv.weight.detach().clone()
    optimizer.step()
    assert not torch.equal(moved, before)
    assert torch.equal(model.outc_sem_change.conv.weight, moved)


def test_unported_regime_is_refused(step_setup):
    """An unknown regime name is refused, by the step and by the trainer;
    a single-head model under 'semisupervised' raises the JAX package's
    ValueError."""
    model = create_network(step_setup.tcfg, device="cpu")
    optimizer = train_lib.make_optimizer(model, step_setup.tcfg)
    with pytest.raises(ValueError, match="no_such_regime"):
        train_lib.make_train_step(model, optimizer, step_setup.tcfg, "no_such_regime")
    with pytest.raises(ValueError, match="no_such_regime"):
        trainers.run_training(step_setup.tcfg, "no_such_regime", device="cpu")
    jcfg, tcfg = step_setup.jcfg.clone(), step_setup.tcfg.clone()
    jcfg.MODEL.TYPE = tcfg.MODEL.TYPE = "siameseunet"
    with pytest.raises(ValueError) as want:
        jax_train_lib.make_semisupervised_train_step(None, jcfg, jit=False)
    model = create_network(tcfg, device="cpu")
    with pytest.raises(ValueError) as got:
        train_lib.make_train_step(model, train_lib.make_optimizer(model, tcfg), tcfg,
                                  "semisupervised")
    assert str(got.value) == str(want.value)


# --- the CLI and its checkpoint ---------------------------------------------------

def test_cli_debug_and_checkpoint_epochs(fixture_dataset, tmp_path, step_setup, capsys):
    """``train_supervised_dualtask --device cpu``: a DEBUG epoch takes one
    step, evaluates and writes no checkpoint; a full epoch logs
    ``change_loss`` and ``sem_loss`` in its window and writes a checkpoint
    that holds ``outc_sem_change`` and that the JAX package's
    ``torch_port.load_reference_checkpoint`` reads into flax
    ``dtsiameseunet`` variables, weight for weight."""
    opts = fixture_cfg_overrides() + [
        "MODEL.TOPOLOGY", "[8, 16]", "TRAINER.BATCH_SIZE", "2",
        "TRAINER.PRECISION", "fp32", "TRAINER.EPOCHS", "1",
        "SAVE_CHECKPOINTS", "[1]", "LOG_FREQ", "2"]

    def base(out):
        out.mkdir()
        return ["-c", "dtsiamese", "-p", "proj", "-o", str(out), "-d",
                str(fixture_dataset), "--device", "cpu"]

    debug_out = tmp_path / "debug"
    train_supervised_dualtask.main(base(debug_out) + opts + ["DEBUG", "True"])
    printed = capsys.readouterr().out
    assert "epoch float 0.5 (step 1) - epoch 1" in printed
    assert not (debug_out / "networks").exists()

    out = tmp_path / "out"
    train_supervised_dualtask.main(base(out) + opts)
    printed = capsys.readouterr().out
    assert "epoch float 1.0 (step 2) - epoch 1" in printed
    log = (out / "logs" / "dtsiamese.jsonl").read_text()
    for key in ('"change_loss"', '"sem_loss"', '"loss"', '"train_time"',
                '"test F1"'):
        assert key in log, key
    # each window line writes its losses in the JAX package's payload order
    want = list(jax_trainers._window_summary(
        "dualtask", {k: [0.5] for k in ("loss", "sem_loss", "change_loss")}, []))
    assert want == ["change_loss", "sem_loss", "loss", "labeled_percentage"]
    windows = [json.loads(line) for line in log.splitlines() if '"train_time"' in line]
    assert windows
    for r in windows:
        assert [k for k in r if k != "_t"][:len(want)] == want, list(r)

    ckpt = out / "networks" / "dtsiamese_checkpoint1.pt"
    payload = torch.load(ckpt, map_location="cpu", weights_only=True)
    assert payload["step"] == 2
    assert "module.outc_sem_change.conv.weight" in payload["network"]
    variables = jax.eval_shape(lambda: init_variables(
        step_setup.jmodel, step_setup.jcfg, jax.random.PRNGKey(0)))
    variables = jax.tree_util.tree_map(lambda a: np.zeros(a.shape, a.dtype), variables)
    ported, step = torch_port.load_reference_checkpoint(ckpt, variables)
    assert step == 2
    cfg = _cfgs(fixture_dataset)[1]
    cfg.PATHS.OUTPUT = str(out)
    model, _, step = checkpoints.load_checkpoint(1, cfg, device="cpu")
    assert step == 2 and type(model).__name__ == "DualTaskSiameseUNet"
    back = state_dict_from_jax(jax.device_get(ported))
    for name, val in model.state_dict().items():
        if not name.endswith("num_batches_tracked"):
            np.testing.assert_array_equal(back[name].numpy(), val.numpy(), err_msg=name)
