"""The port's evaluation path against the JAX package's, on the synthetic
fixture dataset (``fixture_dataset``), from one set of weights.

Both packages read the same tree (each through its own scene cache:
``.cache_tpu`` and ``.cache_torch``). The JAX side runs at ``TRAINER.
PRECISION fp32`` with ``MODEL.PACKED_FULLRES False``; the port runs fp32 on
the CPU with the plain confusion version. Tolerances: wires, pads, group
limits and confusion totals are exact; F1/precision/recall are float32
values derived from equal totals, compared exactly.
"""

import types

import jax
import numpy as np
import pytest
import torch

from multimodal_siamese_cd_tpu import evaluation as jax_eval
from multimodal_siamese_cd_tpu import metrics as jax_metrics
from multimodal_siamese_cd_tpu.config import load_cfg as jax_load_cfg
from multimodal_siamese_cd_tpu.data.dataset import MultimodalCDDataset as JaxDataset
from multimodal_siamese_cd_tpu.data.synthetic import fixture_cfg_overrides
from multimodal_siamese_cd_tpu.models import create_network as jax_create_network
from multimodal_siamese_cd_tpu.models import init_variables
from multimodal_siamese_cd_tpu_torch import evaluation, metrics
from multimodal_siamese_cd_tpu_torch.config import load_cfg
from multimodal_siamese_cd_tpu_torch.data.dataset import MultimodalCDDataset
from multimodal_siamese_cd_tpu_torch.models.factory import create_network
from multimodal_siamese_cd_tpu_torch.weights import state_dict_from_jax

torch.set_num_threads(1)

TOPOLOGY = [8, 16]
SPLIT = "training"   # the fixture's two labeled AOIs (80x96 and 88x104)


def _cfgs(root):
    out = []
    for loader in (jax_load_cfg, load_cfg):
        cfg = loader("siamese")
        cfg.merge_from_list(fixture_cfg_overrides())
        cfg.PATHS.DATASET = str(root)
        cfg.MODEL.TOPOLOGY = TOPOLOGY
        cfg.TRAINER.PRECISION = "fp32"
        cfg.MODEL.PACKED_FULLRES = False
        out.append(cfg)
    return out


def _datasets(root, dataset_mode="first_last", overrides=()):
    jcfg, tcfg = _cfgs(root)
    for cfg in (jcfg, tcfg):
        cfg.merge_from_list(list(overrides))
    kw = dict(no_augmentations=True, dataset_mode=dataset_mode,
              disable_multiplier=True, disable_unlabeled=True)
    return JaxDataset(jcfg, SPLIT, **kw), MultimodalCDDataset(tcfg, SPLIT, **kw)


@pytest.fixture(scope="module")
def models(fixture_dataset):
    """JAX model + state and the port's model, with the same random weights
    and BN statistics (spread so predictions are neither all 0 nor all 1)."""
    jcfg, tcfg = _cfgs(fixture_dataset)
    jmodel = jax_create_network(jcfg)
    # shapes only: tracing init is far cheaper than running it on the CPU
    variables = jax.eval_shape(
        lambda: init_variables(jmodel, jcfg, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(17)

    def rnd(path, leaf):
        name = path[-1].key
        if name == "kernel":
            fan_in = np.prod(leaf.shape[:-1])
            return (rng.normal(size=leaf.shape) * np.sqrt(2.0 / fan_in)).astype(np.float32)
        if name in ("scale", "var"):
            return rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
        return rng.uniform(-0.2, 0.2, leaf.shape).astype(np.float32)

    variables = jax.tree_util.tree_map_with_path(rnd, variables)
    # centre the head on the first scene's median logit, so about half the
    # pixels are predicted positive
    item = _datasets(fixture_dataset)[0][0]
    logits = jmodel.apply(variables, item["x_t1"][None], item["x_t2"][None],
                          train=False)
    variables["params"]["outc"]["conv"]["bias"] = (
        variables["params"]["outc"]["conv"]["bias"]
        - np.float32(np.median(np.asarray(logits))))
    state = types.SimpleNamespace(params=variables["params"],
                                  batch_stats=variables["batch_stats"])
    tmodel = create_network(tcfg, device="cpu")
    tmodel.load_state_dict(state_dict_from_jax(variables), strict=True)
    return jmodel, state, tmodel


@pytest.mark.parametrize("bucket,mode,overrides", [
    (64, "first_last", ()),
    (1, "first_last", ()),
    (64, "all", ()),                                  # seeded random pairs
    (64, "first_last", ("DATALOADER.INPUT_MODE", "s2")),
    (1, "all", ("DATALOADER.INPUT_MODE", "s1")),
])
def test_eval_wire_matches_jax(fixture_dataset, bucket, mode, overrides):
    jds, tds = _datasets(fixture_dataset, mode, overrides)
    assert len(jds) == len(tds) == 2
    assert tds.supports_eval_wire()
    for i in range(len(tds)):
        jw, tw = jds.eval_wire(i, bucket), tds.eval_wire(i, bucket)
        assert tw["shape"] == jw["shape"]
        for key in ("x1", "x2", "y", "valid"):
            assert tw[key].dtype == jw[key].dtype, key
            np.testing.assert_array_equal(tw[key], jw[key], err_msg=key)
        for key in ("aoi_id", "year_t1", "month_t1", "year_t2", "month_t2",
                    "is_labeled"):
            assert tw[key] == jw[key], key


@pytest.mark.parametrize("mode,overrides", [
    ("first_last", ()),
    ("all", ("DATALOADER.INCLUDE_BUILDING_LABELS", "True")),
    ("first_last", ("DATALOADER.INPUT_MODE", "s1", "DATALOADER.SCENE_CACHE", "False")),
])
def test_items_match_jax(fixture_dataset, mode, overrides):
    jds, tds = _datasets(fixture_dataset, mode, overrides)
    for i in range(len(tds)):
        ji, ti = jds[i], tds[i]
        assert set(ti) == set(ji)
        for key in ("x_t1", "x_t2", "y_change", "y_sem_t1", "y_sem_t2"):
            if key in ji:
                assert ti[key].dtype == np.float32
                np.testing.assert_array_equal(ti[key], ji[key], err_msg=key)
        for key in ("aoi_id", "year_t1", "month_t1", "year_t2", "month_t2"):
            assert ti[key] == ji[key], key
    # the cache is the port's own
    assert tds.cache.cache_dir.name == ".cache_torch"


@pytest.mark.parametrize("seed", [0, 1])
def test_training_item_matches_jax_crop_stack(fixture_dataset, seed):
    """The default (training) mode: for the same numpy generator, each
    item's planar crop stack is byte for byte the JAX package's
    ``crop_only=True, return_stack=True`` item."""
    jcfg, tcfg = _cfgs(fixture_dataset)
    jds = JaxDataset(jcfg, SPLIT, crop_only=True, return_stack=True)
    tds = MultimodalCDDataset(tcfg, SPLIT)
    assert len(tds) == len(jds)
    for i in range(len(tds)):
        ji = jds.get(i, np.random.default_rng([seed, i]))
        ti = tds.get(i, np.random.default_rng([seed, i]))
        assert ti["stack"].dtype == ji["stack"].dtype
        assert ti["stack"].tobytes() == ji["stack"].tobytes()
        for key in ("aoi_id", "year_t1", "month_t1", "year_t2", "month_t2",
                    "is_labeled"):
            assert ti[key] == ji[key], key


@pytest.mark.parametrize("shape,bucket", [((80, 96, 6), 64), ((88, 104, 1), 64),
                                          ((33, 47, 3), 1), ((1000, 1016, 6), 64),
                                          ((5, 7), 4)])
def test_pad_to_bucket_matches_jax(shape, bucket):
    arr = np.random.default_rng(0).uniform(size=shape).astype(np.float32)
    ours, ours_valid = evaluation.pad_to_bucket(arr, bucket)
    ref, ref_valid = jax_eval.pad_to_bucket(arr, bucket)
    np.testing.assert_array_equal(ours, ref)
    np.testing.assert_array_equal(ours_valid, ref_valid)
    assert ours_valid.dtype == ref_valid.dtype


def test_eval_group_limit_matches_jax():
    for shape in [(64, 64), (128, 128), (1024, 1024), (1024, 1088), (2048, 2048),
                  (4096, 4096), (8192, 8192), (88, 104)]:
        assert evaluation.eval_group_limit(shape) == jax_eval.eval_group_limit(shape)
    assert evaluation.EVAL_BUCKET == jax_eval.EVAL_BUCKET


@pytest.mark.parametrize("path", ["wire", "item"])
@pytest.mark.parametrize("bucket", [64, 1])
def test_inference_loop_matches_jax(fixture_dataset, models, path, bucket):
    """Same F1/precision/recall and the same confusion totals as the JAX
    package, on the wire path (a cache-backed dataset) and the item path (a
    list of items), padded to 64 and at exact shapes."""
    jmodel, state, tmodel = models
    jds, tds = _datasets(fixture_dataset)
    if path == "item":
        jds = [jds[i] for i in range(len(jds))]
        tds = [tds[i] for i in range(len(tds))]
    ours = evaluation.inference_loop(tmodel, tds, bucket=bucket, device="cpu")
    ref = jax_eval.inference_loop(jmodel, state, jds, bucket=bucket)
    assert ours["change"] == tuple(ref["change"])
    assert 0.0 < ours["change"][0] < 1.0   # neither all-0 nor perfect

    thr = np.array([0.3, 0.5, 0.7])
    m_ours = evaluation.run_measurer(tmodel, tds, thr, bucket=bucket, device="cpu")
    m_ref = jax_eval.run_measurer(jmodel, state, jds, thr, bucket=bucket)
    for name in ("TP", "TN", "FP", "FN"):
        np.testing.assert_array_equal(getattr(m_ours, name),
                                      np.asarray(getattr(m_ref, name)), err_msg=name)


def test_scene_probabilities_matches_jax(fixture_dataset, models):
    jmodel, state, tmodel = models
    jds, tds = _datasets(fixture_dataset)
    item = tds[1]
    ours = evaluation.scene_probabilities(tmodel, item, device="cpu")
    ref = jax_eval.scene_probabilities(jmodel, state, jds[1])
    assert ours.shape == item["x_t1"].shape[:2]
    np.testing.assert_allclose(ours, ref, atol=1e-5)


def test_multi_threshold_metric_matches_jax():
    """Float64 host totals, float32 derived metrics with the 1e-4 clamp."""
    rng = np.random.default_rng(3)
    thr = np.array([0.25, 0.5, 0.75])
    ours, ref = metrics.MultiThresholdMetric(thr), jax_metrics.MultiThresholdMetric(thr)
    for _ in range(3):
        counts = rng.integers(0, 5_000_000, size=(4, 3)).astype(np.float64)
        counts[:, 2] = 0       # a threshold with no positives: the clamp
        ours.add_counts(*counts)
        ref.add_counts(*counts)
    y = (rng.uniform(size=(37, 41)) > 0.6).astype(np.float32)
    p = rng.uniform(size=(37, 41)).astype(np.float32)
    v = (rng.uniform(size=(37, 41)) > 0.2).astype(np.float32)
    ours.add_sample(torch.from_numpy(y), torch.from_numpy(p), torch.from_numpy(v))
    ref.add_sample(y, p, v)
    for name in ("TP", "TN", "FP", "FN"):
        np.testing.assert_array_equal(getattr(ours, name), getattr(ref, name))
    np.testing.assert_array_equal(ours.precision, np.asarray(ref.precision))
    np.testing.assert_array_equal(ours.recall, np.asarray(ref.recall))
    np.testing.assert_array_equal(ours.compute_f1(), np.asarray(ref.compute_f1()))
    for a, b in zip(ours.compute_basic_metrics(), ref.compute_basic_metrics()):
        np.testing.assert_array_equal(a, np.asarray(b))
    np.testing.assert_array_equal(ours.thresholds, np.asarray(ref.thresholds))
