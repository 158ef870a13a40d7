"""The port's supervised training path against the JAX package's, on the CPU
and the synthetic fixture (``fixture_dataset``), from one set of weights.

JAX side at ``TRAINER.PRECISION fp32`` and ``MODEL.PACKED_FULLRES False``,
topology [8, 16], 32 px crops, batch 2; the port runs fp32 on the CPU with
the plain ``bn_stats``. Weights and random BatchNorm running statistics are
drawn with numpy and moved with ``weights.state_dict_from_jax``.
Tolerances, each stated at its test:

* losses: atol 1e-6 (float32 sums in another order);
* augmentation decisions applied: exact;
* loader batches: identical bytes;
* one supervised step: loss atol 1e-5, gradients rtol 1e-4 (floor 1e-4 of
  the largest entry), parameters after 3 AdamW steps atol 5e-6, BN running
  statistics atol 1e-6 after every step;
* the CLI's checkpoint: the JAX package's reader restores the port's
  weights exactly.
"""

import copy
import re
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_siamese_cd_tpu import losses as jax_losses
from multimodal_siamese_cd_tpu import torch_port
from multimodal_siamese_cd_tpu import train_lib as jax_train_lib
from multimodal_siamese_cd_tpu.config import load_cfg as jax_load_cfg
from multimodal_siamese_cd_tpu.data import augmentations as jax_aug
from multimodal_siamese_cd_tpu.data.dataset import MultimodalCDDataset as JaxDataset
from multimodal_siamese_cd_tpu.data.loader import TrainLoader as JaxTrainLoader
from multimodal_siamese_cd_tpu.data.synthetic import fixture_cfg_overrides
from multimodal_siamese_cd_tpu.models import create_network as jax_create_network
from multimodal_siamese_cd_tpu.models import init_variables
from multimodal_siamese_cd_tpu_torch import (checkpoints, losses, train_lib,
                                             train_supervised, trainers)
from multimodal_siamese_cd_tpu_torch.config import load_cfg
from multimodal_siamese_cd_tpu_torch.data import augmentations
from multimodal_siamese_cd_tpu_torch.data.dataset import MultimodalCDDataset
from multimodal_siamese_cd_tpu_torch.data.loader import TrainLoader
from multimodal_siamese_cd_tpu_torch.models.batchnorm import BatchNorm2d
from multimodal_siamese_cd_tpu_torch.models.factory import create_network
from multimodal_siamese_cd_tpu_torch.weights import state_dict_from_jax

torch.set_num_threads(1)

TOPOLOGY = [8, 16]


def _cfgs(root, overrides=()):
    out = []
    for loader in (jax_load_cfg, load_cfg):
        cfg = loader("siamese")
        cfg.merge_from_list(fixture_cfg_overrides() + list(overrides))
        cfg.PATHS.DATASET = str(root)
        cfg.MODEL.TOPOLOGY = TOPOLOGY
        cfg.TRAINER.PRECISION = "fp32"
        cfg.TRAINER.BATCH_SIZE = 2
        cfg.MODEL.PACKED_FULLRES = False
        out.append(cfg)
    return out


# --- losses ------------------------------------------------------------------

_BINARY = ["bce_with_logits_loss", "soft_dice_loss", "soft_dice_squared_sum_loss",
           "jaccard_like_loss", "dice_like_loss", "power_jaccard_loss", "iou_loss",
           "jaccard_like_balanced_loss", "soft_dice_loss_balanced",
           "mean_square_error_loss"]
_MULTI = ["cross_entropy_loss", "soft_dice_loss_multi_class",
          "soft_dice_loss_multi_class_debug",
          "generalized_soft_dice_loss_multi_class", "jaccard_like_loss_multi_class"]


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("name", _BINARY + _MULTI)
def test_losses_match_jax(name, masked):
    """Every criterion, with and without a per-sample mask, atol 1e-6."""
    rng = np.random.default_rng(len(name))
    multi = name in _MULTI
    c = 3 if multi else 1
    logits = rng.normal(0, 2, (4, 9, 11, c)).astype(np.float32)
    if name == "cross_entropy_loss":
        y = rng.integers(0, c, (4, 9, 11, 1)).astype(np.float32)
    elif multi:
        y = np.eye(c, dtype=np.float32)[rng.integers(0, c, (4, 9, 11))]
    else:
        y = (rng.uniform(size=(4, 9, 11, 1)) > 0.6).astype(np.float32)
    mask = np.array([1, 0, 1, 1], np.float32) if masked else None

    want = getattr(jax_losses, name)(jnp.asarray(logits), jnp.asarray(y),
                                     None if mask is None else jnp.asarray(mask))
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))  # noqa: E731
    got = getattr(losses, name)(t(logits), t(y),
                                None if mask is None else torch.from_numpy(mask))
    if isinstance(want, tuple):
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6)
    else:
        np.testing.assert_allclose(float(got), float(want), atol=1e-6)


def test_criterion_registry_matches_jax():
    for key in ("BCEWithLogitsLoss", "SoftDiceLoss", "SoftDiceSquaredSumLoss",
                "SoftDiceBalancedLoss", "PowerJaccardLoss", "MeanSquareErrorLoss",
                "L2", "IoULoss", "DiceLikeLoss"):
        assert losses.get_criterion(key).__name__ == \
            jax_losses.get_criterion(key).__name__
    assert losses.get_criterion("CrossEntropyLoss", 2.0, 3.0) is not None
    with pytest.raises(Exception, match="unknown loss"):
        losses.get_criterion("NoSuchLoss")
    # the reference's SoftDiceSquaredSum is SoftDice
    x = torch.randn(2, 1, 5, 5)
    y = (torch.rand(2, 1, 5, 5) > 0.5).float()
    assert torch.equal(losses.soft_dice_squared_sum_loss(x, y),
                       losses.soft_dice_loss(x, y))


# --- augmentation --------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_apply_augmentation_matches_device_augment_batch(seed):
    """Decisions drawn in the test exactly as ``device_augment_batch`` draws
    them from its key, fed to both: the geometric result is exact, for every
    k in {1, 2, 3} and every flip; with color shift and gamma on too, the
    imagery agrees to 1e-6 (pow in two libraries) and the labels exactly."""
    n_img, b, s = 12, 16, 8
    rng = np.random.default_rng(seed)
    stack = rng.uniform(0, 1, (b, s, s, n_img + 3)).astype(np.float32)
    stack[..., n_img:] = rng.uniform(size=(b, s, s, 3)) > 0.5
    key = jax.random.PRNGKey(seed)
    k_flip, k_rot, k_color, k_gamma = jax.random.split(key, 4)
    do_h, do_v = np.array(jax.random.bernoulli(k_flip, 0.5, (2, b)))
    k = np.array(jax.random.randint(k_rot, (b,), 1, 4))
    color = np.array(jax.random.uniform(k_color, (b, 1, 1, n_img), minval=0.5,
                                        maxval=1.5, dtype=jnp.float32))
    gamma = np.array(jax.random.uniform(k_gamma, (b, 1, 1, n_img), minval=0.25,
                                        maxval=2.0, dtype=jnp.float32))
    assert set(k.tolist()) == {1, 2, 3} and do_h.any() and not do_h.all()
    assert do_v.any() and not do_v.all()
    nchw = torch.from_numpy(np.ascontiguousarray(stack.transpose(0, 3, 1, 2)))

    geo = dict(flip=True, rotate=True, n_img_channels=n_img)
    want = np.asarray(jax_aug.device_augment_batch(
        jnp.asarray(stack), key, color_shift=False, gamma=False, **geo))
    got = augmentations.apply_augmentation(
        nchw, do_h=torch.from_numpy(do_h), do_v=torch.from_numpy(do_v),
        k=torch.from_numpy(k), n_img_channels=n_img)
    np.testing.assert_array_equal(got.numpy().transpose(0, 2, 3, 1), want)

    want = np.asarray(jax_aug.device_augment_batch(
        jnp.asarray(stack), key, color_shift=True, gamma=True, **geo))
    got = augmentations.apply_augmentation(
        nchw, do_h=torch.from_numpy(do_h), do_v=torch.from_numpy(do_v),
        k=torch.from_numpy(k), color=torch.from_numpy(color[:, 0, 0]),
        gamma=torch.from_numpy(gamma[:, 0, 0]),
        n_img_channels=n_img).numpy().transpose(0, 2, 3, 1)
    np.testing.assert_allclose(got[..., :n_img], want[..., :n_img], atol=1e-6)
    np.testing.assert_array_equal(got[..., n_img:], want[..., n_img:])


def test_draw_augmentation_distributions():
    gen = torch.Generator().manual_seed(0)
    d = augmentations.draw_augmentation(4000, 3, flip=True, rotate=True,
                                        color_shift=True, gamma=True,
                                        generator=gen, dtype=torch.float32,
                                        device="cpu")
    assert abs(d["do_h"].float().mean() - 0.5) < 0.05
    assert abs(d["do_v"].float().mean() - 0.5) < 0.05
    assert set(d["k"].tolist()) == {1, 2, 3}
    assert 0.5 <= float(d["color"].min()) and float(d["color"].max()) <= 1.5
    assert 0.25 <= float(d["gamma"].min()) and float(d["gamma"].max()) <= 2.0
    none = augmentations.draw_augmentation(2, 3, flip=False, rotate=False,
                                           color_shift=False, gamma=False,
                                           generator=gen, dtype=torch.float32,
                                           device="cpu")
    assert all(v is None for v in none.values())


# --- loader --------------------------------------------------------------------

@pytest.mark.parametrize("overrides,workers", [
    ((), 0),
    (("DATALOADER.INCLUDE_BUILDING_LABELS", "True",
      "DATALOADER.INCLUDE_UNLABELED", "True"), 2),
    (("DATALOADER.CACHE_DTYPE", "float32",
      "AUGMENTATION.IMAGE_OVERSAMPLING_TYPE", "none"), 2),
])
def test_train_loader_matches_jax(fixture_dataset, overrides, workers):
    """Two epochs of batches: identical stack bytes and is_labeled."""
    jcfg, tcfg = _cfgs(fixture_dataset, overrides)
    jds = JaxDataset(jcfg, "training", return_stack=True, crop_only=True)
    tds = MultimodalCDDataset(tcfg, "training")
    jl = JaxTrainLoader(jds, batch_size=2, num_workers=workers, seed=3)
    tl = TrainLoader(tds, batch_size=2, num_workers=workers, seed=3)
    assert len(tl) == len(jl) > 0
    tl.set_epoch(1)
    jl.set_epoch(1)
    for _ in range(2):
        n = 0
        for jb, tb in zip(jl, tl):
            assert tb["stack"].dtype == jb["stack"].dtype
            assert tb["stack"].tobytes() == jb["stack"].tobytes()
            np.testing.assert_array_equal(tb["is_labeled"], jb["is_labeled"])
            assert tb["aoi_id"] == jb["aoi_id"]
            n += 1
        assert n == len(tl)


def test_loader_contract(fixture_dataset):
    """A training dataset yields the planar crop stack; an evaluation one
    has no stack; a worker type other than thread or process is refused."""
    _, tcfg = _cfgs(fixture_dataset)
    tds = MultimodalCDDataset(tcfg, "training")
    n_img = 2 * len(tcfg.DATALOADER.S1_BANDS) + 2 * len(tcfg.DATALOADER.S2_BANDS)
    assert tds.stack_spec() == ((n_img + 3, 32, 32), np.float16)
    assert tds.get(0, np.random.default_rng(0))["stack"].shape == (n_img + 3, 32, 32)
    assert MultimodalCDDataset(tcfg, "training", no_augmentations=True).stack_spec() is None
    with pytest.raises(ValueError, match="thread|process"):
        TrainLoader(tds, batch_size=2, worker_type="bogus")


# --- one supervised step -----------------------------------------------------------

def _random_variables(jmodel, jcfg, seed=3):
    """Random kernels, BN affine and running statistics; convolution biases
    zero, as flax initialises them, and every 3x3 kernel summing to zero over
    its taps, so a BatchNorm's batch mean stays near zero even where its
    input (pooled ReLU maps, imagery) is all positive. (A batch mean far from
    zero beside the spread makes the fast variance E[x²] - E[x]² cancel: the
    float32 running variances of two packages then differ by a few parts in
    1e6, and the JAX package's float32 gradients on the CPU drift ~2e-3 from
    a float64 run, while the port's stay within 1e-6 of it.)"""
    variables = jax.eval_shape(
        lambda: init_variables(jmodel, jcfg, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(seed)

    def rnd(path, leaf):
        names = [getattr(p, "key", "") for p in path]
        if names[-1] == "kernel":
            fan_in = np.prod(leaf.shape[:-1])
            w = rng.normal(size=leaf.shape) * np.sqrt(2.0 / fan_in)
            if leaf.shape[:2] == (3, 3):
                w -= w.mean(axis=(0, 1), keepdims=True)
            return w.astype(np.float32)
        if names[-1] in ("scale", "var"):
            return rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
        if names[-1] == "bias" and not names[-2].startswith("bn"):
            return np.zeros(leaf.shape, np.float32)
        return rng.uniform(-0.2, 0.2, leaf.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(rnd, variables)


# DoubleConv's conv biases (Sequential indices 0 and 3), each followed by a BN
_PRE_BN_BIAS = re.compile(r"conv\.[03]\.bias$")


def _bias_of(bn):
    """The convolution bias in front of the BN named ``bn`` (Sequential
    index j - 1)."""
    head, j = bn.rsplit(".", 1)
    return f"{head}.{int(j) - 1}.bias"


def _sd(tree, coll):
    """torch-named float32 numpy arrays of one flax collection."""
    return {k: v.numpy() for k, v in state_dict_from_jax({coll: tree}).items()
            if not k.endswith("num_batches_tracked")}


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


def _port_model(setup, bn_cls=None):
    model = create_network(setup.tcfg, device="cpu")
    model.load_state_dict(state_dict_from_jax(setup.variables), strict=True)
    if bn_cls is not None:   # swap every BatchNorm for another class, same state
        for name, mod in list(model.named_modules()):
            for child_name, child in list(mod.named_children()):
                if isinstance(child, BatchNorm2d):
                    new = bn_cls(child.num_features, eps=1e-5, momentum=0.1)
                    new.load_state_dict(child.state_dict())
                    setattr(mod, child_name, new)
    return model


def test_supervised_step_matches_jax(step_setup):
    """Loss atol 1e-5; gradients rtol 1e-4, with an absolute floor of 1e-4
    of the model's largest gradient entry; parameters after 3 AdamW steps
    atol 5e-6; every BN running statistic atol 1e-6 after every step.

    A convolution bias in front of a BatchNorm has zero gradient in exact
    arithmetic, so its float32 gradient is roundoff in both packages and
    AdamW moves it by up to lr of either sign: those biases are held only to
    that bound. A bias that differs by d shifts the BN's batch mean by d, so
    each running mean is compared after taking off the offset that the
    packages' bias differences account for (0.9·offset + 0.1·d at each
    update). The Siamese encoder's BNs update twice per step (t1, then t2),
    as in flax."""
    s = step_setup
    state = jax_train_lib.create_train_state(s.jcfg, jax.random.PRNGKey(0))[1]
    state = state.replace(params=s.variables["params"],
                          batch_stats=s.variables["batch_stats"],
                          opt_state=state.tx.init(s.variables["params"]))
    jstep = jax_train_lib.make_supervised_train_step(s.jmodel, s.jcfg, jit=False)
    model = _port_model(s)
    optimizer = train_lib.make_optimizer(model, s.tcfg)
    tstep = train_lib.make_supervised_train_step(model, optimizer, s.tcfg)

    layout = jax_train_lib.stack_layout(s.jcfg)
    offset = {}   # per BN: what the bias differences moved its running mean
    for i, batch in enumerate(s.batches):
        ours = model.state_dict()
        dbias = {name: ours[name].double().numpy() - want
                 for name, want in _sd(state.params, "params").items()
                 if _PRE_BN_BIAS.search(name)}
        if i == 0:   # the JAX gradient of the same loss, at the same weights
            x1, x2, y, _, _ = jax_train_lib.split_stack(
                jax_train_lib.wire_to_nhwc(jnp.asarray(batch["stack"])).astype(
                    jnp.float32), layout)

            def loss_fn(params):
                logits, _ = s.jmodel.apply(
                    {"params": params, "batch_stats": state.batch_stats},
                    x1, x2, train=True, mutable=["batch_stats"])
                return jax_losses.power_jaccard_loss(logits, y)

            jgrads = _sd(jax.grad(loss_fn)(state.params), "params")
        state, aux = jstep(state, jnp.asarray(batch["stack"]),
                           jnp.asarray(batch["is_labeled"]), jax.random.PRNGKey(0))
        out = tstep(torch.from_numpy(batch["stack"]),
                    torch.from_numpy(batch["is_labeled"]), i)
        np.testing.assert_allclose(float(out["loss"]), float(aux["loss"]), atol=1e-5)
        if i == 0:
            floor = 1e-4 * max(np.abs(g).max() for g in jgrads.values())
            for name, p in model.named_parameters():
                np.testing.assert_allclose(p.grad.numpy(), jgrads[name],
                                           rtol=1e-4, atol=floor, err_msg=name)
        ours = model.state_dict()
        for name, want in _sd(state.batch_stats, "batch_stats").items():
            bn, stat = name.rsplit(".", 1)
            got = ours[name].double().numpy()
            if stat == "running_mean":
                for _ in range(1 if bn.startswith("decoder.") else 2):
                    offset[bn] = 0.9 * offset.get(bn, 0.0) + 0.1 * dbias[_bias_of(bn)]
                got = got - offset[bn]
            np.testing.assert_allclose(got, want, atol=1e-6, rtol=0,
                                       err_msg=f"step {i} {name}")
    ours = model.state_dict()
    lr = s.tcfg.TRAINER.LR
    for name, want in _sd(state.params, "params").items():
        if _PRE_BN_BIAS.search(name):
            # zero gradient in exact arithmetic: AdamW turns each package's
            # roundoff into a step of up to lr of either sign
            assert np.abs(ours[name].numpy() - want).max() <= 2 * 3 * lr
        else:
            np.testing.assert_allclose(ours[name].numpy(), want, atol=5e-6,
                                       err_msg=name)
    # the encoder's BNs counted two calls per step, the decoder's one
    assert int(ours["inc.conv.conv.1.num_batches_tracked"]) == 2 * len(s.batches)
    assert int(ours["decoder.up_seq.up1.conv.conv.1.num_batches_tracked"]) == len(s.batches)


def test_torch_batchnorm_misses_flax_running_var(step_setup):
    """The fault the port's BatchNorm repairs, on the whole model: after one
    step at batch 2, ``torch.nn.BatchNorm2d``'s unbiased running variance is
    off flax's by more than the 1e-6 the port holds, while the means agree."""
    s = step_setup
    state = jax_train_lib.create_train_state(s.jcfg, jax.random.PRNGKey(0))[1]
    state = state.replace(params=s.variables["params"],
                          batch_stats=s.variables["batch_stats"],
                          opt_state=state.tx.init(s.variables["params"]))
    jstep = jax_train_lib.make_supervised_train_step(s.jmodel, s.jcfg, jit=False)
    state, _ = jstep(state, jnp.asarray(s.batches[0]["stack"]),
                     jnp.asarray(s.batches[0]["is_labeled"]), jax.random.PRNGKey(0))
    want = _sd(state.batch_stats, "batch_stats")
    model = _port_model(s, bn_cls=torch.nn.BatchNorm2d)
    optimizer = train_lib.make_optimizer(model, s.tcfg)
    train_lib.make_supervised_train_step(model, optimizer, s.tcfg)(
        torch.from_numpy(s.batches[0]["stack"]), None, 0)
    ours = model.state_dict()
    var_err = max(np.abs(ours[k].numpy() - v).max() for k, v in want.items()
                  if k.endswith("running_var"))
    mean_err = max(np.abs(ours[k].numpy() - v).max() for k, v in want.items()
                   if k.endswith("running_mean"))
    assert mean_err < 1e-6
    assert var_err > 1e-4


def test_split_stack_matches_jax(step_setup):
    batch = step_setup.batches[0]["stack"]
    for mode in ("s1", "s2", "s1s2"):
        jcfg, tcfg = step_setup.jcfg.clone(), step_setup.tcfg.clone()
        jcfg.DATALOADER.INPUT_MODE = tcfg.DATALOADER.INPUT_MODE = mode
        want = jax_train_lib.split_stack(
            jax_train_lib.wire_to_nhwc(jnp.asarray(batch)),
            jax_train_lib.stack_layout(jcfg))
        got = train_lib.split_stack(torch.from_numpy(batch),
                                    train_lib.stack_layout(tcfg))
        for g, w in zip(got, want):
            assert (g.dtype == torch.float32) == (w.dtype == jnp.float32)
            np.testing.assert_array_equal(g.float().numpy().transpose(0, 2, 3, 1),
                                          np.asarray(w, np.float32))


# --- the CLI, checkpoints and resume ---------------------------------------------

def test_cli_checkpoint_and_latest_resume(fixture_dataset, tmp_path, step_setup,
                                          monkeypatch, capsys):
    """A CPU CLI run (``--device cpu``) trains one epoch and writes the
    checkpoint; the JAX package's ``torch_port`` reads it back to the same
    weights; a DEBUG run with ``RESUME_CHECKPOINT latest`` restores the step
    and the loader epoch and takes one more step."""
    out = tmp_path / "out"
    out.mkdir()
    base = ["-c", "siamese", "-p", "proj", "-o", str(out), "-d",
            str(fixture_dataset), "--device", "cpu"]
    opts = fixture_cfg_overrides() + [
        "MODEL.TOPOLOGY", "[8, 16]", "TRAINER.BATCH_SIZE", "2",
        "TRAINER.PRECISION", "fp32", "TRAINER.EPOCHS", "1",
        "SAVE_CHECKPOINTS", "[1]", "LOG_FREQ", "2",
        "TRAINER.STEPS_PER_EXECUTION", "4"]
    epochs_seen = []
    iterate = TrainLoader.__iter__

    def spy(self):
        epochs_seen.append(self._epoch)
        return iterate(self)

    monkeypatch.setattr(TrainLoader, "__iter__", spy)
    train_supervised.main(base + opts)
    printed = capsys.readouterr().out
    assert "STEPS_PER_EXECUTION=4: runs as 1" in printed
    assert "epoch float 1.0 (step 2) - epoch 1" in printed
    log = (out / "logs" / "siamese.jsonl").read_text()
    assert '"train_time"' in log and '"test F1"' in log

    ckpt = out / "networks" / "siamese_checkpoint1.pt"
    payload = torch.load(ckpt, map_location="cpu", weights_only=True)
    assert payload["step"] == 2 and set(payload) == {"step", "network", "optimizer"}
    assert all(k.startswith("module.") for k in payload["network"])
    jcfg = step_setup.jcfg
    variables = jax.eval_shape(lambda: init_variables(
        step_setup.jmodel, jcfg, jax.random.PRNGKey(0)))
    variables = jax.tree_util.tree_map(lambda a: np.zeros(a.shape, a.dtype), variables)
    ported, step = torch_port.load_reference_checkpoint(ckpt, variables)
    assert step == 2
    model, _, step = checkpoints.load_checkpoint(1, _resume_cfg(out, fixture_dataset),
                                                 device="cpu")
    assert step == 2
    back = state_dict_from_jax(jax.device_get(ported))
    for name, val in model.state_dict().items():
        if not name.endswith("num_batches_tracked"):
            np.testing.assert_array_equal(back[name].numpy(), val.numpy(), err_msg=name)

    epochs_seen.clear()
    train_supervised.main(base + opts + ["TRAINER.EPOCHS", "2", "DEBUG", "True",
                                         "TRAINER.RESUME_CHECKPOINT", "latest"])
    printed = capsys.readouterr().out
    assert "resumed from checkpoint epoch 1 (step 2)" in printed
    assert "resuming at epoch 2 (step 2, 2 steps/epoch)" in printed
    assert "epoch float 1.5 (step 3) - epoch 2" in printed
    assert epochs_seen == [1]


def _resume_cfg(out, root):
    cfg = _cfgs(root)[1]
    cfg.PATHS.OUTPUT = str(out)
    return cfg


def test_run_training_defaults_to_the_card(fixture_dataset):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card; the default device resolves")
    _, tcfg = _cfgs(fixture_dataset)
    with pytest.raises(RuntimeError, match="CUDA"):
        trainers.run_training(tcfg, "supervised")
