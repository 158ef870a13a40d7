"""The port's ``siamunet_diff`` (FC-Siam-diff) against the JAX package's, on
the CPU and the synthetic fixture (``fixture_dataset``), from one set of
weights.

JAX side at ``TRAINER.PRECISION fp32`` (the model ignores
``MODEL.TOPOLOGY``: its widths are fixed), 32 px crops, batch 2; the port
runs fp32 on the CPU with the plain ``bn_stats``. Weights and BatchNorm
running statistics are drawn with numpy and moved with
``weights.state_dict_from_jax``. Tolerances, each stated at its test:

* eval forward at 37 x 45 (the decoder's edge pad) and 32 x 32 (no pad):
  probabilities atol 1e-5;
* one supervised step with dropout made the identity on both sides, from
  one resumed AdamW state: the loss atol 1e-5, every parameter and every BN
  running statistic atol 1e-6;
* the converter, the dropout masks, the BatchNorm call count and the
  checkpoint's round trip through ``torch_port``: exact.
"""

import json
import types

import flax.linen
import jax
import numpy as np
import pytest
import torch

from multimodal_siamese_cd_tpu import torch_port
from multimodal_siamese_cd_tpu import train_lib as jax_train_lib
from multimodal_siamese_cd_tpu.config import load_cfg as jax_load_cfg
from multimodal_siamese_cd_tpu.data.synthetic import fixture_cfg_overrides
from multimodal_siamese_cd_tpu.models import create_network as jax_create_network
from multimodal_siamese_cd_tpu.models import init_variables
from multimodal_siamese_cd_tpu_torch import (checkpoints, train_lib, trainers,
                                             wandb_compat)
from multimodal_siamese_cd_tpu_torch.config import load_cfg
from multimodal_siamese_cd_tpu_torch.data.dataset import MultimodalCDDataset
from multimodal_siamese_cd_tpu_torch.data.loader import TrainLoader
from multimodal_siamese_cd_tpu_torch.models import batchnorm, networks
from multimodal_siamese_cd_tpu_torch.models.factory import create_network
from multimodal_siamese_cd_tpu_torch.weights import state_dict_from_jax
from test_torch_port_semisup import _batches, _resumed_optimizers
from test_torch_port_train import _random_variables, _sd

torch.set_num_threads(1)

_FLIPS_OFF = ("AUGMENTATION.RANDOM_FLIP", "False", "AUGMENTATION.RANDOM_ROTATE", "False")
# train-mode BatchNorm calls of one step: 10 encoder BNs on each date and 9
# decoder BNs, each once forward and once backward
BN_CALLS_PER_STEP = 2 * (2 * 10 + 9)


def _cfgs(root, overrides=()):
    out = []
    for loader in (jax_load_cfg, load_cfg):
        cfg = loader("siamese")
        cfg.merge_from_list(fixture_cfg_overrides() + list(overrides))
        cfg.PATHS.DATASET = str(root)
        cfg.MODEL.TYPE = "siamunet_diff"
        cfg.TRAINER.PRECISION = "fp32"
        cfg.TRAINER.BATCH_SIZE = 2
        cfg.MODEL.PACKED_FULLRES = False
        out.append(cfg)
    return out


def _both(root, overrides=(), seed=3):
    """JAX model, random variables and the port's model loaded with them."""
    jcfg, tcfg = _cfgs(root, overrides)
    jmodel = jax_create_network(jcfg)
    variables = _random_variables(jmodel, jcfg, seed=seed)
    tmodel = create_network(tcfg, device="cpu")
    tmodel.load_state_dict(state_dict_from_jax(variables), strict=True)
    return types.SimpleNamespace(jcfg=jcfg, tcfg=tcfg, jmodel=jmodel,
                                 variables=variables, tmodel=tmodel)


def _zeros_like_variables(jmodel, jcfg):
    shapes = jax.eval_shape(lambda: init_variables(jmodel, jcfg, jax.random.PRNGKey(0)))
    return jax.tree_util.tree_map(lambda a: np.zeros(a.shape, a.dtype), shapes)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if hasattr(v, "items"):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


# --- the model and its weights ------------------------------------------------------

def test_converter_is_torch_ports_inverse(fixture_dataset):
    """``state_dict_from_jax`` gives the flat keys the port's model loads
    strictly (19 BNs, 14 transposed convs), and the JAX package's
    ``port_siamunet_diff_state_dict`` maps them back onto every flax leaf,
    bit for bit."""
    s = _both(fixture_dataset)
    ours = state_dict_from_jax(s.variables, step=4)
    assert set(ours) == set(s.tmodel.state_dict())
    tops = {k.split(".")[0] for k in ours}
    assert len([t for t in tops if t.startswith("bn")]) == 10 + 9
    assert {t for t in tops if t.startswith("upconv")} == {f"upconv{i}" for i in range(1, 5)}
    assert "conv11d" in tops and "bn11d" not in tops
    transposed = [m for m in s.tmodel.modules() if isinstance(m, torch.nn.ConvTranspose2d)]
    assert len(transposed) == 4 + 9 + 1     # upconvs, decoder convs, conv11d
    back = torch_port.port_siamunet_diff_state_dict(
        {f"module.{k}": v for k, v in ours.items()},
        _zeros_like_variables(s.jmodel, s.jcfg))
    want = dict(_leaves(s.variables))
    got = dict(_leaves(back))
    assert set(got) == set(want)
    for path, val in want.items():
        np.testing.assert_array_equal(np.asarray(got[path]), val, err_msg=str(path))


@pytest.mark.parametrize("h,w", [(37, 45), (32, 32)])
def test_eval_forward_matches_jax(fixture_dataset, h, w):
    """At 37 x 45 every decoder stage edge-pads the upsampled map; at 32 x 32
    none does. Probabilities atol 1e-5."""
    s = _both(fixture_dataset)
    rng = np.random.default_rng(h * w)
    x1 = rng.uniform(0, 1, (2, h, w, 6)).astype(np.float32)
    x2 = rng.uniform(0, 1, (2, h, w, 6)).astype(np.float32)
    want = np.asarray(jax.nn.sigmoid(s.jmodel.apply(s.variables, x1, x2, train=False)))
    got = train_lib.eval_forward(s.tmodel, _nchw(x1), _nchw(x2))
    assert got.shape == (2, 1, h, w) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy()[:, 0], want[..., 0], atol=1e-5)
    assert want.std() > 0.01     # not vacuous


class _NoDropout(flax.linen.Module):
    """flax ``nn.Dropout`` made the identity."""

    rate: float
    broadcast_dims: tuple = ()
    deterministic: bool | None = None

    def __call__(self, inputs, deterministic=None, rng=None):
        return inputs


def test_supervised_step_matches_jax(fixture_dataset, monkeypatch):
    """One supervised step, dropout the identity on both sides (patched in
    this test alone), flips and rotations off, from one resumed AdamW state
    (a cold AdamW step's sign is decided by roundoff where a gradient is
    near 0): the loss atol 1e-5; every parameter and every BN running
    statistic atol 1e-6; the encoder's BNs ran twice, the decoder's once."""
    monkeypatch.setattr(flax.linen, "Dropout", _NoDropout)
    monkeypatch.setattr(networks, "spatial_dropout", lambda x, p, generator, rows=None: x)
    s = _both(fixture_dataset, _FLIPS_OFF)
    state, optimizer = _resumed_optimizers(s)
    batch = _batches(s.jcfg, ("labeled",))[0]
    jstep = jax_train_lib.make_train_step(s.jmodel, s.jcfg, "supervised")
    tstep = train_lib.make_train_step(s.tmodel, optimizer, s.tcfg, "supervised")
    state, aux = jstep(state, jax.numpy.asarray(batch["stack"]),
                       jax.numpy.asarray(batch["is_labeled"]), jax.random.PRNGKey(0))
    out = tstep(torch.from_numpy(batch["stack"]), torch.from_numpy(batch["is_labeled"]), 0)
    assert set(out) == set(aux) == {"loss"}
    np.testing.assert_allclose(float(out["loss"]), float(aux["loss"]), atol=1e-5)
    assert float(out["loss"]) > 0
    ours = s.tmodel.state_dict()
    for name, want in _sd(state.batch_stats, "batch_stats").items():
        np.testing.assert_allclose(ours[name].numpy(), want, atol=1e-6, rtol=0,
                                   err_msg=name)
    init = _sd(s.variables["params"], "params")
    moved = 0.0
    for name, want in _sd(state.params, "params").items():
        np.testing.assert_allclose(ours[name].numpy(), want, atol=1e-6, rtol=0,
                                   err_msg=name)
        moved = max(moved, float(np.abs(want - init[name]).max()))
    assert moved > 10 * 1e-6     # the step moved parameters far past the atol
    tracked = {k: int(v) for k, v in ours.items() if k.endswith("num_batches_tracked")}
    assert tracked["bn11.num_batches_tracked"] == 2
    assert tracked["bn43d.num_batches_tracked"] == 1


def test_spatial_dropout_masks_whole_channels():
    """The mask is one draw per (sample, channel), shape (B, C, 1, 1): a
    plane is kept whole and divided by 0.8, or zero. One generator seed
    gives one mask whatever torch's global generator holds, and the draw
    leaves that global generator untouched."""
    x = torch.rand(8, 32, 5, 7) + 0.5
    torch.manual_seed(0)
    before = torch.random.get_rng_state()
    a = networks.spatial_dropout(x, 0.2, torch.Generator().manual_seed(11))
    assert torch.equal(torch.random.get_rng_state(), before)
    torch.manual_seed(1)
    b = networks.spatial_dropout(x, 0.2, torch.Generator().manual_seed(11))
    c = networks.spatial_dropout(x, 0.2, torch.Generator().manual_seed(12))
    assert torch.equal(a, b) and not torch.equal(a, c)
    kept = a != 0
    whole = kept.all(dim=(2, 3)) | (~kept).all(dim=(2, 3))
    assert bool(whole.all())
    torch.testing.assert_close(a[kept], x[kept] / (1.0 - 0.2), atol=0, rtol=0)
    share = float(kept[:, :, 0, 0].float().mean())
    assert 0.6 < share < 0.95
    # the mask's shape: draws of (B, C, 1, 1) are the generator's first ones
    u = torch.rand((8, 32, 1, 1), generator=torch.Generator().manual_seed(11))
    assert torch.equal(kept[:, :, :1, :1], u < 0.8)


def test_train_mode_needs_a_generator_and_eval_mode_draws_nothing(fixture_dataset):
    s = _both(fixture_dataset)
    x = torch.rand(1, 6, 32, 32)
    s.tmodel.train()
    with pytest.raises(ValueError, match="generator"):
        s.tmodel(x, x)
    s.tmodel.eval()
    with torch.no_grad():
        a = s.tmodel(x, x)
        b = s.tmodel(x, x, generator=torch.Generator().manual_seed(5))
    assert torch.equal(a, b)


def test_step_calls_bn_stats_58_times_and_draws_from_its_generator(fixture_dataset,
                                                                   monkeypatch):
    """The supervised step with dropout active: 58 ``bn_stats`` calls (29
    BNs forward and backward, counted through the plain wrapper on the
    CPU); two steps at one ``global_step`` from one state give one result,
    another ``global_step`` another mask; torch's global generator is
    never drawn from."""
    calls = []
    plain = batchnorm.bn_stats

    def counted(a, b):
        calls.append(tuple(a.shape))
        return plain(a, b)

    monkeypatch.setattr(batchnorm, "bn_stats", counted)
    s = _both(fixture_dataset)
    batch = _batches(s.jcfg, ("labeled",))[0]
    start = {k: v.clone() for k, v in s.tmodel.state_dict().items()}

    def one_step(global_step):
        s.tmodel.load_state_dict(start)
        optimizer = train_lib.make_optimizer(s.tmodel, s.tcfg)
        step = train_lib.make_train_step(s.tmodel, optimizer, s.tcfg, "supervised")
        return float(step(torch.from_numpy(batch["stack"]),
                          torch.from_numpy(batch["is_labeled"]), global_step)["loss"])

    torch.manual_seed(0)
    before = torch.random.get_rng_state()
    first = one_step(7)
    assert len(calls) == BN_CALLS_PER_STEP == 58
    assert {c[1] for c in calls} == {16, 32, 64, 128}
    assert one_step(7) == first
    assert torch.equal(torch.random.get_rng_state(), before)
    assert one_step(8) != first


def test_run_training_checkpoint_loads_through_torch_port(fixture_dataset, tmp_path):
    """``run_training(cfg, 'supervised')`` trains ``siamunet_diff`` one
    epoch on the CPU with dropout active: finite window losses and a
    checkpoint that the JAX package's ``port_siamunet_diff_state_dict``
    (which refuses any unmapped or unfilled key) loads as it is; the JAX
    forward on those weights equals the port's, atol 1e-5."""
    jcfg, tcfg = _cfgs(fixture_dataset)
    tcfg.PATHS.OUTPUT = str(tmp_path)
    tcfg.TRAINER.EPOCHS = 1
    tcfg.SAVE_CHECKPOINTS = [1]
    tcfg.LOG_FREQ = 1
    wandb_compat.init(name=tcfg.NAME, config=tcfg, mode="jsonl", out_dir=tmp_path)
    try:
        trainers.run_training(tcfg, "supervised", device="cpu")
    finally:
        wandb_compat.finish()
    records = [json.loads(line) for line in
               (tmp_path / "logs" / f"{tcfg.NAME}.jsonl").read_text().splitlines()]
    windows = [r for r in records if "train_time" in r]
    assert len(windows) == len(TrainLoader(MultimodalCDDataset(tcfg, "training"), 2))
    assert all(np.isfinite(r["loss"]) and r["loss"] > 0 for r in windows)

    payload = torch.load(checkpoints.checkpoint_file(tcfg, 1), map_location="cpu",
                         weights_only=True)
    jmodel = jax_create_network(jcfg)
    ported = torch_port.port_siamunet_diff_state_dict(
        payload["network"], _zeros_like_variables(jmodel, jcfg))
    model, _, step = checkpoints.load_checkpoint(1, tcfg, device="cpu")
    assert step == len(windows) and type(model).__name__ == "SiamUnetDiff"
    rng = np.random.default_rng(0)
    x1 = rng.uniform(0, 1, (1, 37, 45, 6)).astype(np.float32)
    x2 = rng.uniform(0, 1, (1, 37, 45, 6)).astype(np.float32)
    want = np.asarray(jax.nn.sigmoid(jmodel.apply(ported, x1, x2, train=False)))
    got = train_lib.eval_forward(model, _nchw(x1), _nchw(x2))
    np.testing.assert_allclose(got.numpy()[:, 0], want[..., 0], atol=1e-5)
