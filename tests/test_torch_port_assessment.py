"""The port's offline assessment, figure and dataset CLIs (and the host
modules they need) against the JAX package's root scripts, on the CPU and
the synthetic fixture (``fixture_dataset``).

Tiny shapes (``MODEL.TOPOLOGY [4, 8]``, 32 px crops, fp32,
``MODEL.PACKED_FULLRES False``, the fixture's AOI lists), seeded weights
written straight into checkpoints rather than trained: the port writes its
checkpoint, the JAX package reads those weights with
``torch_port.load_reference_checkpoint`` and writes its own with its
``save_checkpoint``. Tolerances, each stated at its test: printed metric
lines, parser namespaces, metrics, dataset lookups, PNG bytes and
metadata.json exact; figure pixels exact except where a probability lies
within 1e-5 of 0.5.
"""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import assessment_change as jax_assessment_change
import assessment_semantics as jax_assessment_semantics
import preprocessing as jax_preprocessing
import qualitative_comparison as jax_qualitative_comparison
import upload_study_area as jax_upload_study_area
from multimodal_siamese_cd_tpu import checkpoints as jax_checkpoints
from multimodal_siamese_cd_tpu import evaluation as jax_evaluation
from multimodal_siamese_cd_tpu import experiment_manager as jax_experiment_manager
from multimodal_siamese_cd_tpu import metrics as jax_metrics
from multimodal_siamese_cd_tpu import parsers as jax_parsers
from multimodal_siamese_cd_tpu import png as jax_png
from multimodal_siamese_cd_tpu import torch_port
from multimodal_siamese_cd_tpu import train_lib as jax_train_lib
from multimodal_siamese_cd_tpu import visualization as jax_visualization
from multimodal_siamese_cd_tpu.config import load_cfg as jax_load_cfg
from multimodal_siamese_cd_tpu.data.dataset import MultimodalCDDataset as JaxDataset
from multimodal_siamese_cd_tpu.data.synthetic import TEST_AOIS, fixture_cfg_overrides
from multimodal_siamese_cd_tpu_torch import (assessment_change, assessment_semantics,
                                             checkpoints, evaluation, geofiles,
                                             metrics, parsers, png, preprocessing,
                                             qualitative_comparison, sanity_check,
                                             train_lib, upload_study_area,
                                             visualization)
from multimodal_siamese_cd_tpu_torch.config import load_cfg
from multimodal_siamese_cd_tpu_torch.data.dataset import MultimodalCDDataset
from multimodal_siamese_cd_tpu_torch.models.factory import create_network

torch.set_num_threads(1)

SMALL = ["MODEL.TOPOLOGY", "[4,8]", "TRAINER.PRECISION", "fp32",
         "MODEL.PACKED_FULLRES", "False", "INFERENCE_CHECKPOINT", "1"]


def _opts(overrides=()):
    return fixture_cfg_overrides() + SMALL + list(overrides)


def _write_checkpoints(root, tmp_path, name, overrides=(), seed=3):
    """One seeded set of weights for config ``name``: the port's checkpoint
    under ``tmp_path/torch``, the same weights as the JAX package's under
    ``tmp_path/jax`` (epoch 1, step 7). BN running statistics are drawn
    too, so eval-mode BN is not the identity. Returns (jax_out, torch_out)."""
    tout, jout = tmp_path / "torch", tmp_path / "jax"
    tout.mkdir(exist_ok=True)
    jout.mkdir(exist_ok=True)
    tcfg = load_cfg(name)
    tcfg.merge_from_list(_opts(overrides))
    tcfg.PATHS.DATASET, tcfg.PATHS.OUTPUT = str(root), str(tout)
    gen = torch.Generator().manual_seed(seed)
    model = create_network(tcfg, device="cpu", generator=gen)
    with torch.no_grad():
        for key, buf in model.named_buffers():
            if key.endswith("running_mean"):
                buf.uniform_(-0.2, 0.2, generator=gen)
            elif key.endswith("running_var"):
                buf.uniform_(0.5, 1.5, generator=gen)
    _center_heads(model, tcfg)
    ckpt = checkpoints.save_checkpoint(model, train_lib.make_optimizer(model, tcfg),
                                       1, 7, tcfg)
    jcfg = jax_load_cfg(name)
    jcfg.merge_from_list(_opts(overrides))
    jcfg.PATHS.DATASET, jcfg.PATHS.OUTPUT = str(root), str(jout)
    _, state = jax_train_lib.create_train_state(jcfg, jax.random.PRNGKey(0))
    ported, step = torch_port.load_reference_checkpoint(
        ckpt, {"params": state.params, "batch_stats": state.batch_stats})
    assert step == 7
    state = state.replace(params=ported["params"], batch_stats=ported["batch_stats"])
    jax_checkpoints.save_checkpoint(state, 1, 7, jcfg)
    return jout, tout


def _center_heads(model, cfg) -> None:
    """Shift each head's bias by its median logit over the first test scene,
    so about half the pixels are predicted positive (the auxiliary head
    last: it reads the semantic logits)."""
    item = MultimodalCDDataset(cfg, "test", no_augmentations=True,
                               dataset_mode="first_last", disable_multiplier=True,
                               disable_unlabeled=True)[0]
    heads = {"siameseunet": {"outc": None},
             "dtsiameseunet": {"outc_change": "change", "outc_sem": "sem_t2",
                               "outc_sem_change": "change_sem"}}[cfg.MODEL.TYPE]
    for head, key in heads.items():
        if key is None:
            p = evaluation.scene_probabilities(model, item, device="cpu")
        else:
            p = evaluation.dualtask_scene_outputs(model, item, device="cpu")[key]
        p = np.clip(p.astype(np.float64), 1e-12, 1 - 1e-12)
        with torch.no_grad():
            getattr(model, head).conv.bias -= float(np.median(np.log(p / (1 - p))))


def _metric_lines(text):
    return [line for line in text.splitlines()
            if line.startswith(("F1 score", "--"))]


# --- parsers ----------------------------------------------------------------------

_ARGVS = {
    "preprocess_argument_parser": [["-d", "/data/x"], ["-d", "/data/x", "K", "V"]],
    "assessment_argument_parser": [["-c", "siamese", "-o", "/o", "-d", "/d"],
                                   ["-c", "dtsiamese", "-o", "/o", "-d", "/d", "-r",
                                    "validation", "TRAINER.LR", "0.1"]],
    "comparison_argument_parser": [["-c", "a", "b", "-o", "/o", "-d", "/d"],
                                   ["-c", "a", "-o", "/o", "-d", "/d", "-r", "x",
                                    "K", "V"]],
    "metadata_argument_parser": [["-s", "/sn7"], ["-s", "/sn7", "-c", "x", "K", "V"]],
}


@pytest.mark.parametrize("name", sorted(_ARGVS))
def test_parsers_match_jax(name):
    """For the same argv, the same namespace as the JAX package's parser;
    the parsers of entry points that run a model add ``--device`` (None by
    default, read before the overrides), the others do not take it."""
    runs_model = name in ("assessment_argument_parser", "comparison_argument_parser")
    for argv in _ARGVS[name]:
        want = vars(getattr(jax_parsers, name)().parse_known_args(argv)[0])
        got = vars(getattr(parsers, name)().parse_known_args(argv)[0])
        device = got.pop("device", "absent")
        assert got == want, argv
        assert device == (None if runs_model else "absent")
    if runs_model:
        argv = _ARGVS[name][1]          # --device goes before the overrides
        got = getattr(parsers, name)().parse_known_args(
            argv[:8] + ["--device", "cpu"] + argv[8:])[0]
        assert got.device == "cpu"
        assert got.opts == vars(getattr(jax_parsers, name)().parse_known_args(
            argv)[0])["opts"]


# --- metrics ------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1])
def test_numpy_metrics_match_jax(seed):
    rng = np.random.default_rng(seed)
    prob = rng.uniform(0, 1, 5000).astype(np.float32)
    prob[:50] = 0.5                          # ties at the strict threshold
    truth = rng.uniform(size=5000) > 0.6
    for name in ("true_positives_from_prob", "false_positives_from_prob",
                 "false_negatives_from_prob", "precision_from_prob",
                 "precsision_from_prob", "recall_from_prob", "f1_score_from_prob"):
        for thr in (0.5, 0.3):
            got = getattr(metrics, name)(prob, truth, thr)
            want = getattr(jax_metrics, name)(prob, truth, thr)
            assert got == want and type(got) is type(want), name
    assert metrics.precsision_from_prob is metrics.precision_from_prob
    assert metrics.root_mean_square_error(prob, truth.astype(np.float32)) == \
        jax_metrics.root_mean_square_error(prob, truth.astype(np.float32))


@pytest.mark.parametrize("multi", [False, True])
def test_functional_metrics_match_jax(multi):
    """``true_pos`` ... ``f1_score`` in torch against the JAX package's,
    float32, exact; ``multi_threashold_mode`` (the reference's spelling) is
    the same switch."""
    rng = np.random.default_rng(3 + multi)
    gts = (rng.uniform(size=(4, 9, 11)) > 0.5).astype(np.float32)
    preds = rng.uniform(size=(4, 3, 9, 11) if multi else (4, 9, 11)).astype(np.float32)
    t = torch.from_numpy
    for name in ("true_pos", "false_pos", "false_neg"):
        np.testing.assert_array_equal(
            getattr(metrics, name)(t(gts), t(preds[:, 0] if multi else preds)).numpy(),
            np.asarray(getattr(jax_metrics, name)(gts, preds[:, 0] if multi else preds)))
    for name in ("precision", "recall"):
        np.testing.assert_array_equal(
            getattr(metrics, name)(t(gts), t(preds[:, 0] if multi else preds), (-1, -2)).numpy(),
            np.asarray(getattr(jax_metrics, name)(gts, preds[:, 0] if multi else preds,
                                                  (-1, -2))))
    want = np.asarray(jax_metrics.f1_score(gts, preds, multi_threshold_mode=multi))
    got = metrics.f1_score(gts, preds, multi_threashold_mode=multi)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(TypeError, match="unexpected"):
        metrics.f1_score(gts, preds, bogus=1)


# --- the dataset ---------------------------------------------------------------------

def _datasets(root, run_type, overrides=(), **kw):
    jcfg, tcfg = jax_load_cfg("siamese"), load_cfg("siamese")
    for cfg in (jcfg, tcfg):
        cfg.merge_from_list(_opts(overrides))
        cfg.PATHS.DATASET = str(root)
    return JaxDataset(jcfg, run_type, **kw), MultimodalCDDataset(tcfg, run_type, **kw)


@pytest.mark.parametrize("run_type,kw", [
    ("training", {}),
    ("training", {"disable_multiplier": True}),
    ("test", {"no_augmentations": True}),
])
def test_dataset_lookups_match_jax(fixture_dataset, run_type, kw):
    jds, tds = _datasets(fixture_dataset, run_type, **kw)
    assert str(tds) == str(jds) == f"Dataset with {len(tds)} samples."
    assert tds.get_aoi_ids() == jds.get_aoi_ids()
    for aoi in tds.get_aoi_ids() + ["no_such_aoi"]:
        assert tds.get_index(aoi) == jds.get_index(aoi)
    assert tds.get_index("no_such_aoi") is None


@pytest.mark.parametrize("overrides", [
    (),
    ("DATALOADER.INCLUDE_BUILDING_LABELS", "True", "AUGMENTATION.COLOR_SHIFT", "True",
     "AUGMENTATION.GAMMA_CORRECTION", "True"),
], ids=["flips", "flips-jitter-buildings"])
def test_augmented_item_moves_labels_with_images(fixture_dataset, overrides):
    """``ds[i]`` in training mode: the keys, shapes and dtypes of the JAX
    package's augmented item. For the same generator the crop is the
    training stack's, and the labels went through one of the eight flips /
    rotations; without photometric jitter the imagery went through the same
    one (with it, the imagery stays in [0, 1])."""
    jds, tds = _datasets(fixture_dataset, "training", overrides, disable_multiplier=True)
    jitter = bool(overrides)
    moved = set()
    for i in range(len(tds)):
        want, got = jds[i], tds[i]
        assert set(got) == set(want)
        for key, val in want.items():
            if isinstance(val, np.ndarray):
                assert got[key].shape == val.shape and got[key].dtype == val.dtype, key
            elif key in ("aoi_id", "is_labeled"):   # the dates are drawn
                assert got[key] == val, key
        for seed in range(4):
            stack = tds.get(i, np.random.default_rng([seed, i]))["stack"].astype(
                np.float32).transpose(1, 2, 0)
            item = tds.augmented_item(i, np.random.default_rng([seed, i]))
            n = stack.shape[-1] - 3
            labels = [np.concatenate([item[k] for k in ("y_sem_t1", "y_sem_t2")
                                      if k in item] + [item["y_change"]], axis=-1)]
            planes = stack[..., n:] if jitter else stack[..., n + 2:]
            ks = [k for k in range(8)
                  if np.array_equal(_dihedral(planes, k), labels[0])]
            assert ks, (i, seed)
            if jitter:
                for key in ("x_t1", "x_t2"):
                    assert 0.0 <= item[key].min() and item[key].max() <= 1.0
                continue
            ks = [k for k in ks if all(
                np.array_equal(a, b) for a, b in zip(
                    tds._split_imgs(_dihedral(stack[..., :n], k)),
                    (item["x_t1"], item["x_t2"])))]
            assert len(ks) == 1, (i, seed, ks)
            moved.add(ks[0])
    if not jitter:
        assert len(moved) > 1     # the draws are not all the identity


def _dihedral(a, k):
    """The k-th of the eight flips / rotations of an (S, S, C) array."""
    a = np.rot90(a, k % 4, axes=(0, 1))
    return a[:, ::-1] if k >= 4 else a


# --- png and figures -----------------------------------------------------------------

def test_png_and_panels_are_byte_equal_to_jax(tmp_path):
    """The same arrays give the same panels and the same PNG bytes."""
    rng = np.random.default_rng(0)
    cfg = load_cfg("siamese")
    x = rng.uniform(-0.1, 1.2, (20, 24, 6)).astype(np.float32)
    pred = (rng.uniform(size=(20, 24)) > 0.5).astype(np.uint8)
    gt = (rng.uniform(size=(20, 24)) > 0.5).astype(np.float32)
    for arr in (rng.integers(0, 256, (5, 7), dtype=np.uint8),
                rng.integers(0, 256, (5, 7, 3), dtype=np.uint8),
                rng.integers(0, 256, (5, 7, 4), dtype=np.uint8)):
        assert png.encode_png(arr) == jax_png.encode_png(arr)
    panels = {}
    for mod in (visualization, jax_visualization):
        rows = [[mod.imagery_panel(x, cfg), mod.gray_rgb(gt),
                 mod.classification_rgb(mod.get_misclassifications(pred, gt))],
                [mod.optical_rgb(x[..., 2:]), mod.sar_gray(x), mod.to_uint8(x[..., :3])]]
        panels[mod] = rows
        mod.save_figure(tmp_path / f"{mod.__name__}.png", rows, title="siamese L15-0331E",
                        col_titles=["t1", "GT", "pred"], row_labels=["a", "b"])
    for row_t, row_j in zip(panels[visualization], panels[jax_visualization]):
        for p, q in zip(row_t, row_j):
            assert p.dtype == q.dtype and p.tobytes() == q.tobytes()
    got = (tmp_path / f"{visualization.__name__}.png").read_bytes()
    assert got == (tmp_path / f"{jax_visualization.__name__}.png").read_bytes()
    assert png.read_png(tmp_path / f"{visualization.__name__}.png").ndim == 3


# --- the assessment CLIs ---------------------------------------------------------------

def test_assessment_change_prints_the_jax_lines(fixture_dataset, tmp_path, capsys):
    """``assessment_change`` (``main``, ``--device cpu``) on the port's
    checkpoint prints exactly the JAX script's F1 / precision / recall line
    on the same weights; the returned triple is ``inference_loop``'s."""
    jout, tout = _write_checkpoints(fixture_dataset, tmp_path, "siamese")
    base = ["-c", "siamese", "-d", str(fixture_dataset), "-r", "test"]
    assessment_change.main(base + ["-o", str(tout), "--device", "cpu"] + _opts())
    got = capsys.readouterr().out
    args = jax_parsers.assessment_argument_parser().parse_known_args(
        base + ["-o", str(jout)] + _opts())[0]
    jax_assessment_change.quantitative_assessment(
        jax_experiment_manager.setup_cfg(args), run_type="test")
    want = capsys.readouterr().out
    assert _metric_lines(got) == _metric_lines(want) and len(_metric_lines(got)) == 1
    assert "nan" not in want and "F1 score: 0.000" not in want     # not vacuous
    cfg = load_cfg("siamese")
    cfg.merge_from_list(_opts())
    cfg.PATHS.DATASET, cfg.PATHS.OUTPUT = str(fixture_dataset), str(tout)
    triple = assessment_change.quantitative_assessment(cfg, "test", device="cpu")
    assert _metric_lines(capsys.readouterr().out) == _metric_lines(want)
    f1, p, r = triple
    assert f"F1 score: {f1:.3f} - Precision: {p:.3f} - Recall {r:.3f}" in want


@pytest.mark.parametrize("cache", ["True", "False"], ids=["wire", "items"])
def test_assessment_semantics_prints_the_jax_blocks(fixture_dataset, tmp_path, capsys,
                                                    cache):
    """``assessment_semantics`` on a dual-task checkpoint prints the JAX
    script's three blocks, line for line: with the scene cache (the strict
    counts of ``dualtask_quantitative_counts``) and without it (every
    scene's probabilities pooled through the numpy ``*_from_prob``
    metrics)."""
    overrides = ("DATALOADER.SCENE_CACHE", cache)
    jout, tout = _write_checkpoints(fixture_dataset, tmp_path, "dtsiamese", overrides)
    base = ["-c", "dtsiamese", "-d", str(fixture_dataset)]
    assessment_semantics.main(base + ["-o", str(tout), "--device", "cpu"]
                              + _opts(overrides))
    got = capsys.readouterr().out
    parser = jax_parsers.assessment_argument_parser()
    parser.set_defaults(run_type="validation")
    args = parser.parse_known_args(base + ["-o", str(jout)] + _opts(overrides))[0]
    jax_assessment_semantics.quantitative_assessment(
        jax_experiment_manager.setup_cfg(args), run_type=args.run_type)
    want = capsys.readouterr().out
    lines = _metric_lines(want)
    assert [line for line in lines if line.startswith("--")] == \
        ["--Change--", "--Change Sem--", "--Sem--"]
    assert "nan" not in want and "F1 score: 0.000" not in want     # not vacuous
    assert _metric_lines(got) == lines


def test_assessment_semantics_device_item_path_prints_the_jax_blocks(
        fixture_dataset, tmp_path, capsys):
    """Without the scene cache, off the CPU, ``assessment_semantics`` counts
    each float32 scene item with the strict kernel
    (``dualtask_item_counts``). Here through the kernel's plain version:
    its blocks print as the JAX script's reference-shaped cache-disabled
    lines; on the cached scenes its counts equal the wire path's exactly."""
    overrides = ("DATALOADER.SCENE_CACHE", "False")
    jout, tout = _write_checkpoints(fixture_dataset, tmp_path, "dtsiamese", overrides)
    parser = jax_parsers.assessment_argument_parser()
    parser.set_defaults(run_type="validation")
    args = parser.parse_known_args(["-c", "dtsiamese", "-d", str(fixture_dataset),
                                    "-o", str(jout)] + _opts(overrides))[0]
    jax_assessment_semantics.quantitative_assessment(
        jax_experiment_manager.setup_cfg(args), run_type=args.run_type)
    want = _metric_lines(capsys.readouterr().out)

    cfg = load_cfg("dtsiamese")
    cfg.merge_from_list(_opts(overrides))
    cfg.PATHS.DATASET, cfg.PATHS.OUTPUT = str(fixture_dataset), str(tout)
    model, _, _ = checkpoints.load_checkpoint(1, cfg, device="cpu")
    ds = assessment_semantics._dataset(cfg, "validation")
    assert evaluation.dualtask_quantitative_counts(model, ds, device="cpu") is None
    counts = evaluation.dualtask_item_counts(model, ds, device="cpu")
    for title, key in assessment_semantics._BLOCKS:
        assessment_semantics._print_block(
            title, *metrics.prob_metrics_from_counts(*counts[key]))
    assert _metric_lines(capsys.readouterr().out) == want and len(want) == 6
    assert "F1 score: 0.000" not in "".join(want)             # not vacuous

    # the cached scenes as items count as their wires do
    cfg.DATALOADER.SCENE_CACHE = True
    cached = assessment_semantics._dataset(cfg, "validation")
    assert evaluation.dualtask_item_counts(model, list(cached), device="cpu") == \
        evaluation.dualtask_quantitative_counts(model, cached, device="cpu")


def test_qualitative_comparison_pixels_match_jax(fixture_dataset, tmp_path, monkeypatch):
    """The colored zoom figure and the plain one: the same PNG as the JAX
    script's on the same weights, pixel for pixel, except where a change
    probability lies within 1e-5 of 0.5 (none does here: then the bytes are
    equal)."""
    jout, tout = _write_checkpoints(fixture_dataset, tmp_path, "siamese")
    orig = jax_experiment_manager.setup_cfg_manual

    def manual_with_fixture(name, out, data):
        cfg = orig(name, out, data)
        cfg.merge_from_list(_opts())
        return cfg

    monkeypatch.setattr(jax_qualitative_comparison.experiment_manager,
                        "setup_cfg_manual", manual_with_fixture)
    aois, zooms = list(TEST_AOIS), [(3, 5, 40)]
    got = qualitative_comparison.main(
        ["-c", "siamese", "-o", str(tout), "-d", str(fixture_dataset), "--device",
         "cpu"] + _opts(), aoi_ids=aois, zooms=zooms)
    want = jax_qualitative_comparison.qualitative_comparison_zoom(
        ["siamese"], str(jout), str(fixture_dataset), aois, zooms, colored=True)
    assert got.name == want.name == "qualitative_comparison_zoom_colored.png"
    plain = qualitative_comparison.qualitative_comparison(
        ["siamese"], str(tout), str(fixture_dataset), aois, device="cpu", opts=_opts())
    plain_want = jax_qualitative_comparison.qualitative_comparison(
        ["siamese"], str(jout), str(fixture_dataset), aois)

    # where the packages' probabilities straddle 0.5 they may differ
    cfg = manual_with_fixture("siamese", tout, fixture_dataset)
    model, _, _ = checkpoints.load_checkpoint(1, cfg, device="cpu")
    item = MultimodalCDDataset(cfg, "test", no_augmentations=True,
                               dataset_mode="first_last", disable_multiplier=True,
                               disable_unlabeled=True)[0]
    probs = evaluation.scene_probabilities(model, item, device="cpu")
    jcfg = manual_with_fixture("siamese", jout, fixture_dataset)
    jmodel, state, _ = jax_checkpoints.load_checkpoint(1, jcfg)
    jprobs = jax_evaluation.scene_probabilities(jmodel, state, item)
    np.testing.assert_allclose(probs, jprobs, atol=1e-5)
    assert 0.05 < float((probs > 0.5).mean()) < 0.95       # not vacuous
    straddle = (probs > 0.5) != (jprobs > 0.5)
    assert not straddle[np.abs(probs - 0.5) >= 1e-5].any()
    for ours, theirs in ((got, want), (plain, plain_want)):
        a, b = png.read_png(ours), png.read_png(theirs)
        assert a.shape == b.shape
        if not straddle.any():
            assert ours.read_bytes() == theirs.read_bytes()


def test_sanity_check_writes_panels(fixture_dataset, tmp_path, monkeypatch):
    """``sanity_check`` (``main``) writes one figure per sample, each of the
    JAX script's size for the same config (the crops differ: the port's
    augmentation draws are its own)."""
    files = sanity_check.main(["-c", "siamese", "-d", str(fixture_dataset), "-n", "2",
                               "-o", str(tmp_path / "torch")] + _opts())
    orig = jax_experiment_manager.load_cfg

    def load_with_fixture(name):
        cfg = orig(name)
        cfg.merge_from_list(_opts())
        return cfg

    import sanity_check as jax_sanity_check
    monkeypatch.setattr(jax_sanity_check.experiment_manager, "load_cfg", load_with_fixture)
    want = jax_sanity_check.sanity_check_dataset("siamese", str(fixture_dataset),
                                                 n_samples=2,
                                                 out_dir=str(tmp_path / "jax"))
    assert [f.name for f in files] == [f.name for f in want] == \
        ["siamese_training_0.png", "siamese_training_1.png"]
    for a, b in zip(files, want):
        assert png.read_png(a).shape == png.read_png(b).shape


def test_preprocessing_metadata_matches_jax(fixture_dataset, tmp_path, capsys):
    """On two copies of the fixture tree without their metadata.json, the
    port's ``preprocessing`` writes the JAX script's file, byte for byte,
    which holds the generator's metadata."""
    trees = []
    for name in ("torch", "jax"):
        tree = tmp_path / name
        shutil.copytree(fixture_dataset, tree,
                        ignore=shutil.ignore_patterns(".cache*"))
        (tree / "metadata.json").unlink()
        trees.append(tree)
    preprocessing.main(["-d", str(trees[0])])
    jax_preprocessing.create_metadata_file(str(trees[1]))
    assert "metadata.json written for 5 AOIs" in capsys.readouterr().out
    got = (trees[0] / "metadata.json").read_bytes()
    assert got == (trees[1] / "metadata.json").read_bytes()
    assert json.loads(got) == geofiles.load_json(fixture_dataset / "metadata.json")


def test_upload_study_area_builds_records_without_ee(tmp_path):
    """The module imports, and builds the JAX script's records, in an
    interpreter where ``ee`` cannot be imported; its CLI then stops with a
    message instead of exporting."""
    for dataset, ids in {"train": ["aoiA", "aoiB", "aoiC"], "test": ["aoiD"]}.items():
        for k, a in enumerate(ids):
            geofiles.write_tif(tmp_path / dataset / a / "images_masked" / f"{a}_m.tif",
                               np.zeros((4, 4, 3), np.uint8),
                               (1.0, 0.0, 10.0 * k, 0.0, -1.0, 10.0 * k + 1), "EPSG:3857")
    cfg = load_cfg("base")
    cfg.DATASET.TRAINING_IDS, cfg.DATASET.VALIDATION_IDS = ["aoiA"], ["aoiB"]
    cfg.DATASET.TEST_IDS = ["aoiD"]
    jcfg = jax_load_cfg("base")
    jcfg.DATASET.TRAINING_IDS, jcfg.DATASET.VALIDATION_IDS = ["aoiA"], ["aoiB"]
    jcfg.DATASET.TEST_IDS = ["aoiD"]
    records = upload_study_area.study_area_records(cfg, str(tmp_path))
    assert records == jax_upload_study_area.study_area_records(jcfg, str(tmp_path))
    assert [(r["aoi_id"], r["split"], r["labeled"]) for r in records] == [
        ("aoiA", "training", 1), ("aoiB", "validation", 1), ("aoiC", "training", 0),
        ("aoiD", "test", 1)]
    assert upload_study_area.EXPORT_SPEC == jax_upload_study_area.EXPORT_SPEC
    code = (
        "import sys\n"
        "sys.modules['ee'] = None\n"
        "from multimodal_siamese_cd_tpu_torch import upload_study_area as u\n"
        "from multimodal_siamese_cd_tpu_torch.config import load_cfg\n"
        f"print(len(u.study_area_records(load_cfg('base'), {str(tmp_path)!r})))\n"
        f"u.main(['-s', {str(tmp_path)!r}])\n")
    env = dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parent.parent))
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.stdout.strip() == "4"
    assert out.returncode != 0 and "earthengine-api is not installed" in out.stderr


# --- checkpoints: the repairs ------------------------------------------------------------

def test_load_checkpoint_net_file_and_corrupt_files(fixture_dataset, tmp_path):
    """``net_file`` names the file to load; a truncated or foreign file
    raises ``ValueError`` naming it; a missing one ``FileNotFoundError``."""
    _, tout = _write_checkpoints(fixture_dataset, tmp_path, "siamese")
    cfg = load_cfg("siamese")
    cfg.merge_from_list(_opts())
    cfg.PATHS.DATASET, cfg.PATHS.OUTPUT = str(fixture_dataset), str(tout)
    src = checkpoints.checkpoint_file(cfg, 1)
    moved = tmp_path / "elsewhere.pt"
    shutil.copy(src, moved)
    model, _, step = checkpoints.load_checkpoint(99, cfg, net_file=moved, device="cpu")
    want, _, _ = checkpoints.load_checkpoint(1, cfg, device="cpu")
    assert step == 7
    for (k, a), (_, b) in zip(model.state_dict().items(), want.state_dict().items()):
        assert torch.equal(a, b), k
    truncated = tmp_path / "truncated.pt"
    truncated.write_bytes(src.read_bytes()[:1000])
    with pytest.raises(ValueError, match="Corrupt or incompatible checkpoint .*truncated.pt"):
        checkpoints.load_checkpoint(1, cfg, net_file=truncated, device="cpu")
    other = tmp_path / "other.pt"
    torch.save({"step": 1, "network": {"module.x": torch.zeros(1)}, "optimizer": {}},
               other)
    with pytest.raises(ValueError, match="Corrupt or incompatible checkpoint .*other.pt"):
        checkpoints.load_checkpoint(1, cfg, net_file=other, device="cpu")
    with pytest.raises(FileNotFoundError):
        checkpoints.load_checkpoint(5, cfg, device="cpu")
    shapes = tmp_path / "shapes.pt"        # the model's keys, one wrong shape
    ckpt = torch.load(src, weights_only=True)
    key = next(iter(ckpt["network"]))
    ckpt["network"][key] = torch.zeros(3)
    torch.save(ckpt, shapes)
    with pytest.raises(ValueError, match=f"shapes.pt.*{key[len('module.'):]}: shape"):
        checkpoints.load_checkpoint(1, cfg, net_file=shapes, device="cpu")

    # a device's failure while a sound file is copied onto it is not a
    # corrupt checkpoint
    def out_of_memory(*args, **kwargs):
        raise torch.OutOfMemoryError("CUDA out of memory")

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch.nn.Module, "load_state_dict", out_of_memory)
        with pytest.raises(torch.OutOfMemoryError):
            checkpoints.load_checkpoint(1, cfg, device="cpu")


def test_cli_entry_points_default_to_the_card(fixture_dataset, tmp_path):
    """Without ``--device`` the CLIs that run a model ask for the card and
    raise on a host without one, before writing anything."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card; the default device resolves")
    _, tout = _write_checkpoints(fixture_dataset, tmp_path, "siamese")
    base = ["-c", "siamese", "-o", str(tout), "-d", str(fixture_dataset)]
    for main in (assessment_change.main, assessment_semantics.main,
                 qualitative_comparison.main):
        with pytest.raises(RuntimeError, match="CUDA"):
            main(base + _opts())
    assert not (tout / "plots").exists()
