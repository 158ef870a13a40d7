"""The port's lifecycle tools and its last host helpers against the JAX
package's, on the CPU.

* ``convergence_run``: its CLI argv equals the JAX tool's (module path
  aside) and it prints the same trajectory; its dataset marker refuses a
  tree it did not write; the tree it writes equals the JAX tool's, byte for
  byte.
* ``lifecycle_run``: ``plan`` and ``window_rates`` equal the JAX tool's
  (the cases of ``test_aux.py``); its dataset generation is atomic and
  guarded, and equals the JAX tool's; one real run with ``--device cpu`` at
  a tiny shape and topology: a SIGKILL of the training process once the
  seam window is logged, a resume from ``latest``, a seam difference of
  0.0, and an assessment line equal to ``quantitative_assessment`` in
  process on the same checkpoint.
* ``geofiles`` mosaicking, ``CfgNode.dump`` and ``models.factory.
  param_count`` equal the JAX package's results on the same inputs.
* The native GeoTIFF decoders, built into a temporary directory with the C
  compiler, equal the pure-Python decoders byte for byte (skipped only on a
  host without a C compiler).
"""

import contextlib
import io
import json
import shutil
import signal
import subprocess
import sys
import types
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from conftest import import_tool
from multimodal_siamese_cd_tpu import geofiles as jax_geofiles
from multimodal_siamese_cd_tpu.config import load_cfg as jax_load_cfg
from multimodal_siamese_cd_tpu.models import init_variables
from multimodal_siamese_cd_tpu.models import create_network as jax_create_network
from multimodal_siamese_cd_tpu.models import param_count as jax_param_count
from multimodal_siamese_cd_tpu_torch import (assessment_change, build_native,
                                             convergence_run, experiment_manager,
                                             geofiles, geotiff, lifecycle_run, parsers)
from multimodal_siamese_cd_tpu_torch.config import load_cfg
from multimodal_siamese_cd_tpu_torch.models.factory import create_network, param_count
from test_geotiff import _lzw_encode_reference

torch.set_num_threads(1)

DATA = Path(__file__).resolve().parent / "data"


def _tree(root: Path) -> dict:
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


def _one_aoi_each(monkeypatch, *tools) -> None:
    for tool in tools:
        for name in ("TRAIN", "VAL", "TEST", "UNLAB"):
            monkeypatch.setattr(tool, name, [f"L15-tiny{name}"])


# --- lifecycle_run: plan, window_rates, dataset -----------------------------

def test_lifecycle_plan_matches_jax():
    """The schedule from each regime's config (the cases of
    ``test_aux.py::test_lifecycle_plan_uses_config_batch``), equal to the
    JAX tool's."""
    jax_tool = import_tool("lifecycle_run")
    sup = lifecycle_run.plan("supervised", 128, 100, 3)
    assert sup == {"batch": 8, "steps_per_epoch": 624,
                   "resume_epoch": 2, "seam_step": 1300}
    semi = lifecycle_run.plan("semisupervised", 128, 100, 3)
    assert semi == {"batch": 4, "steps_per_epoch": 1888,
                    "resume_epoch": 2, "seam_step": 3800}
    assert lifecycle_run.plan("semisupervised", 128, 100, 3,
                              batch=8)["steps_per_epoch"] == 944
    with pytest.raises(AssertionError):
        lifecycle_run.plan("supervised", 2, 100, 3)
    for regime in lifecycle_run.REGIMES:
        for args in ((128, 100, 3), (16, 100, 3), (8, 4, 2)):
            assert lifecycle_run.plan(regime, *args) == jax_tool.plan(regime, *args)
    assert [v[1:] for v in lifecycle_run.REGIMES.values()] == \
        [v[1:] for v in jax_tool.REGIMES.values()]
    for name in ("TRAIN", "VAL", "TEST", "UNLAB"):
        assert getattr(lifecycle_run, name) == getattr(jax_tool, name)


def test_lifecycle_window_rates_match_jax():
    """Each window's real step coverage (epoch starts reset the trainer's
    train_time), each phase's first window dropped; equal to the JAX
    tool's."""
    jax_tool = import_tool("lifecycle_run")
    recs = [{"step": s, "train_time": 10.0} for s in (100, 200, 300, 400, 500)]
    assert lifecycle_run.window_rates(recs, 312, 8) == \
        [80.0, 80.0, 8 * 88 / 10.0, 80.0]
    b = [{"step": s, "train_time": 10.0} for s in (700, 800)]
    assert lifecycle_run.window_rates(b, 312, 8, start_step=624) == [80.0]
    mixed = recs + [{"step": 510, "train_time": 0.0}, {"loss": 1.0},
                    {"step": None, "train_time": 3.0}, {"step": 530, "train_time": 2.5}]
    for args in ((recs, 312, 8), (b, 312, 8, 624), (mixed, 97, 4), (mixed, 600, 8, 50)):
        assert lifecycle_run.window_rates(*args) == jax_tool.window_rates(*args)


def test_lifecycle_dataset_generation_is_atomic(tmp_path, monkeypatch):
    """Generated into a .partial sibling and renamed; idempotent; a
    changed shape regenerates over its own tree; a marker-less tree is
    refused (the cases of ``test_aux.py``); the tree equals the JAX tool's."""
    jax_tool = import_tool("lifecycle_run")
    _one_aoi_each(monkeypatch, lifecycle_run, jax_tool)

    root = tmp_path / "ds"
    lifecycle_run.ensure_dataset(root, 32)
    marker = root / "lifecycle_gen_params.json"
    assert marker.exists() and not root.with_name("ds.partial").exists()
    jax_tool.ensure_dataset(tmp_path / "jax_ds", 32)
    assert _tree(root) == _tree(tmp_path / "jax_ds")

    before = marker.stat().st_mtime_ns
    lifecycle_run.ensure_dataset(root, 32)
    assert marker.stat().st_mtime_ns == before

    lifecycle_run.ensure_dataset(root, 48)
    assert json.loads(marker.read_text())["scene"] == 48

    (root.with_name("ds.partial")).mkdir()
    marker.unlink()
    with pytest.raises(SystemExit, match="refusing to overwrite"):
        lifecycle_run.ensure_dataset(root, 32)


# --- convergence_run ----------------------------------------------------------

def test_convergence_dataset_marker(tmp_path, monkeypatch):
    """The hard fixture as the JAX tool writes it, byte for byte; the same
    parameters write nothing; other parameters regenerate the tool's own
    tree; a tree without the marker is refused and left as it was."""
    jax_tool = import_tool("convergence_run")
    _one_aoi_each(monkeypatch, convergence_run, jax_tool)
    root = tmp_path / "ds"
    convergence_run.ensure_dataset(root, 32, hard=True, signal=0.3)
    jax_tool.ensure_dataset(tmp_path / "jax_ds", 32, hard=True, signal=0.3)
    assert _tree(root) == _tree(tmp_path / "jax_ds")
    marker = root / "convergence_gen_params.json"
    before = marker.stat().st_mtime_ns
    convergence_run.ensure_dataset(root, 32, hard=True, signal=0.3)
    assert marker.stat().st_mtime_ns == before
    convergence_run.ensure_dataset(root, 32)
    assert json.loads(marker.read_text())["hard"] is False

    foreign = tmp_path / "real"
    foreign.mkdir()
    (foreign / "metadata.json").write_text("{}")
    with pytest.raises(SystemExit, match="refusing to overwrite"):
        convergence_run.ensure_dataset(foreign, 32)
    assert _tree(foreign) == {"metadata.json": b"{}"}


_CONVERGENCE_ARGS = [
    ["--regime", "supervised", "--hard", "--scene", "512", "--signal", "0.3",
     "--multiplier", "64", "--log-freq", "16", "--epochs", "6"],
    ["--regime", "dualtask"],
    ["--regime", "semisupervised", "--save-checkpoints", "[1]", "--uniform-crop",
     "--model", "whatevernet2", "--config", "unet_mmcr_alpha0500",
     "--batch-size", "4", "DEBUG", "False"],
]


@pytest.mark.parametrize("args", _CONVERGENCE_ARGS)
def test_convergence_argv_and_trajectory_match_jax(tmp_path, monkeypatch, args):
    """The training command each tool runs, the module path aside (the port
    runs ``python -m multimodal_siamese_cd_tpu_torch.<cli>``, ``--device``
    before the overrides when given), and the F1 trajectory each prints
    from the same JSONL log."""
    jax_tool = import_tool("convergence_run")
    args = args + ["--data-dir", str(tmp_path / "ds"), "--out-dir", str(tmp_path / "out")]
    records = [{"_event": "init", "config": {}},
               {"training F1": 0.25, "step": 16}, {"validation F1": 0.5, "step": 16},
               {"loss": 0.9, "train_time": 1.0, "step": 16},
               {"test F1": 0.125, "step": 32}]
    ran = {}

    def fake_run(tag, config):
        def run(cmd, cwd=None, env=None):
            ran[tag] = cmd
            if tag == "port":
                assert env["MSCD_LOG_SINK"] == "jsonl"
            log = tmp_path / "out" / "logs" / f"{config}.jsonl"
            log.parent.mkdir(parents=True, exist_ok=True)
            log.write_text("".join(json.dumps(r) + "\n" for r in records))
            return types.SimpleNamespace(returncode=0)
        return run

    def printed(tool, tag, argv):
        parsed = convergence_run.parse_args(args)
        config = parsed.config or convergence_run.REGIMES[parsed.regime][1]
        monkeypatch.setattr(tool, "ensure_dataset", lambda *a, **k: None)
        monkeypatch.setattr(subprocess, "run", fake_run(tag, config))
        monkeypatch.setattr(sys, "argv", ["convergence_run.py"] + argv)
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            assert tool.main() == 0
        return out.getvalue().split("F1 trajectory")[1].split("\n", 1)[1]

    want = printed(jax_tool, "jax", args)
    got = printed(convergence_run, "port", args)
    assert got == want and "validation F1: 0.5000" in got
    jax_cmd, port_cmd = ran["jax"], ran["port"]
    parsed = convergence_run.parse_args(args)
    script, _ = jax_tool.REGIMES[parsed.regime]
    assert jax_cmd[1].endswith(script)
    assert port_cmd[:3] == [sys.executable, "-m", "multimodal_siamese_cd_tpu_torch."
                            + script[:-len(".py")]]
    assert port_cmd[3:] == jax_cmd[2:]
    module, argv, _ = convergence_run.command(
        convergence_run.parse_args(args + ["--device", "cpu"]), tmp_path / "ds",
        tmp_path / "out")
    assert argv[:10] == jax_cmd[2:10] + ["--device", "cpu"] and argv[10:] == jax_cmd[10:]
    assert "TRAINER.WEDGE_TIMEOUT" in argv


def test_log_sink_env_picks_jsonl_over_wandb(tmp_path, monkeypatch):
    """Where wandb is installed, ``MSCD_LOG_SINK=jsonl`` (set by the
    lifecycle tools for the CLIs they run) still writes the JSONL sink they
    read; without it the facade goes to wandb, and ``disabled`` stays
    wandb's disabled mode."""
    from multimodal_siamese_cd_tpu_torch import wandb_compat

    inits = []
    fake = types.SimpleNamespace(init=lambda **kw: inits.append(kw) or "run",
                                 log=lambda m: None, finish=lambda: None)
    monkeypatch.setattr(wandb_compat, "_wandb", fake)
    monkeypatch.delenv("MSCD_LOG_SINK", raising=False)
    wandb_compat.init("a", config={"A": 1}, mode="online", out_dir=tmp_path)
    wandb_compat.finish()
    assert [kw["mode"] for kw in inits] == ["online"]
    monkeypatch.setenv(*next(iter(wandb_compat.SINK_ENV.items())))
    wandb_compat.init("b", config={"A": 1}, mode="online", out_dir=tmp_path)
    wandb_compat.log({"loss": 0.5, "step": 1})
    wandb_compat.finish()
    lines = [json.loads(x) for x in (tmp_path / "logs" / "b.jsonl").read_text().splitlines()]
    assert len(inits) == 1 and lines[1]["loss"] == 0.5
    wandb_compat.init("c", config={"A": 1}, mode="disabled", out_dir=tmp_path)
    wandb_compat.finish()
    assert [kw["mode"] for kw in inits] == ["online", "disabled"]
    assert not (tmp_path / "logs" / "c.jsonl").exists()


# --- one lifecycle run on the CPU ---------------------------------------------

def test_lifecycle_run_kill_resume_and_assessment(tmp_path, monkeypatch):
    """A real run through the port's CLIs on the CPU: the training process
    is SIGKILLed once the seam window (the first log window of epoch 3) is
    logged, the same command resumes from ``latest`` (the epoch-2
    checkpoint), every number of the seam's records agrees exactly, and the
    assessment CLI's line equals ``quantitative_assessment`` in process."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    kills = []
    real_send = subprocess.Popen.send_signal

    def send_signal(proc, sig):
        kills.append(sig)
        return real_send(proc, sig)

    monkeypatch.setattr(subprocess.Popen, "send_signal", send_signal)
    data, out = tmp_path / "ds", tmp_path / "out"
    extra = ["MODEL.TOPOLOGY", "[8,16]", "TRAINER.PRECISION", "fp32"]
    argv = ["--scene", "32", "--crop", "32", "--multiplier", "6", "--log-freq", "8",
            "--device", "cpu", "--data-dir", str(data),
            "--out-dir", str(out)] + extra
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        assert lifecycle_run.main(argv) == 0
    report = json.loads((out / "lifecycle_report.json").read_text())
    plan = lifecycle_run.plan("supervised", 6, 8, 3)
    assert kills == [signal.SIGKILL]
    assert report["seam_step"] == plan["seam_step"] == 64
    assert report["seam_max_abs_diff"] == 0.0
    assert plan["seam_step"] <= report["killed_after_step"] < 3 * plan["steps_per_epoch"]
    assert report["shape"] == {"scene": 32, "aois": [39, 9, 12, 20],
                               "steps_per_epoch": 29, "epochs": 3, "log_freq": 8,
                               "batch": 8, "multiplier": 6}
    assert "RESUME_CHECKPOINT latest" in text.getvalue()
    console = (out / "console.log").read_text()
    assert "resumed from checkpoint epoch 2 (step 58)" in console
    steps = [r["step"] for r in report["trajectory"]]
    assert steps[-1] == 3 * plan["steps_per_epoch"]
    assert report["window_rates"] and report["median_train_patches_per_sec"] > 0

    # the CLI's printed line == quantitative_assessment in process
    line = report["assessment_tail"][-1]
    assert line.startswith("F1 score: ")
    args = parsers.assessment_argument_parser().parse_known_args(
        lifecycle_run.assessment_argv(
            lifecycle_run.parser().parse_args(argv), "siamese", out, data))[0]
    cfg = experiment_manager.setup_cfg(args)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assessment_change.quantitative_assessment(cfg, run_type="test", device="cpu")
    assert buf.getvalue().splitlines()[-1] == line


# --- host helpers -------------------------------------------------------------

def test_patch_helpers_match_jax():
    for f in (Path("pred_aoi_0000000512-0000000256.tif"),
              Path("a/b_c_d_0000000000-0000000064.tif")):
        assert geofiles.get_coords(f) == jax_geofiles.get_coords(f)
        assert geofiles.basename_from_file(f) == jax_geofiles.basename_from_file(f)
    assert geofiles.get_coords(Path("pred_aoi_0000000512-0000000256.tif")) == [512, 256]
    assert geofiles.basename_from_file(Path("pred_aoi_0000000512-0000000256.tif")) \
        == "pred_aoi"
    assert geofiles.id2yx("512-256") == jax_geofiles.id2yx("512-256") == (512, 256)


@pytest.mark.parametrize("delete_tiles", [False, True])
def test_combine_tif_patches_matches_jax(tmp_path, delete_tiles):
    """Four 4x4 tiles back into the 8x8 raster (the case of
    ``test_geotiff.py::test_combine_tif_patches``), plus a ragged lower-right
    tile: the same array, transform and CRS as the JAX package's mosaic, and
    with ``delete_tiles`` only the mosaic is left."""
    t = geotiff.Affine.from_origin(0, 0, 1, 1)
    full = np.arange(8 * 8, dtype=np.int8).reshape(8, 8, 1)
    ragged = np.arange(7 * 6 * 2, dtype=np.int8).reshape(7, 6, 2)
    results = {}
    for pkg, mod in (("jax", jax_geofiles), ("port", geofiles)):
        for name, arr in (("mosaic", full), ("ragged", ragged)):
            folder = tmp_path / pkg / name
            for i in (0, 4):
                for j in (0, 4):
                    geofiles.write_tif(folder / f"{name}_{i:010d}-{j:010d}.tif",
                                       arr[i:i + 4, j:j + 4], t, "EPSG:4326")
            mod.combine_tif_patches(folder, name, delete_tiles=delete_tiles)
            results[pkg, name] = geofiles.read_tif(folder / f"{name}.tif")
            left = sorted(p.name for p in folder.iterdir())
            assert left == ([f"{name}.tif"] if delete_tiles else sorted(
                [f"{name}.tif"] + [f"{name}_{i:010d}-{j:010d}.tif"
                                   for i in (0, 4) for j in (0, 4)]))
    np.testing.assert_array_equal(results["port", "mosaic"][0], full)
    np.testing.assert_array_equal(results["port", "ragged"][0], ragged)
    for name in ("mosaic", "ragged"):
        (got, gt, gc), (want, wt, wc) = results["port", name], results["jax", name]
        np.testing.assert_array_equal(got, want)
        assert got.dtype == want.dtype and tuple(gt) == tuple(wt) and str(gc) == str(wc)


@pytest.mark.parametrize("name", ["base", "siamese", "dtsiamese",
                                  "siamese_mmcr_alpha0500", "baseline_dualstream"])
def test_cfg_dump_matches_jax(name):
    """``CfgNode.dump`` gives the JAX package's bytes for the same YAML
    config, with and without ``yaml.safe_dump`` keywords."""
    ours, ref = load_cfg(name), jax_load_cfg(name)
    assert ours.dump() == ref.dump()
    assert ours.dump(default_flow_style=True, width=60) == \
        ref.dump(default_flow_style=True, width=60)
    ours.merge_from_list(["TRAINER.LR", "3e-3", "MODEL.TOPOLOGY", "[8,16]"])
    ref.merge_from_list(["TRAINER.LR", "3e-3", "MODEL.TOPOLOGY", "[8,16]"])
    assert ours.dump() == ref.dump()


@pytest.mark.parametrize("model_type", ["siameseunet", "dtsiameseunet", "siamunet_diff",
                                        "unet", "dualstreamunet", "whatevernet",
                                        "whatevernet2"])
def test_param_count_matches_jax(model_type):
    """Trainable parameters at full width (topology [64,128,256,512]): the
    JAX package's count of ``variables['params']``; BatchNorm running
    statistics are left out in both."""
    cfgs = []
    for loader in (jax_load_cfg, load_cfg):
        cfg = loader("siamese")
        cfg.MODEL.TYPE = model_type
        cfg.MODEL.PACKED_FULLRES = False
        cfgs.append(cfg)
    jmodel = jax_create_network(cfgs[0])
    variables = jax.eval_shape(
        lambda: init_variables(jmodel, cfgs[0], jax.random.PRNGKey(0)))
    model = create_network(cfgs[1], device="cpu")
    assert param_count(model) == jax_param_count(variables["params"])
    n_buffers = sum(b.numel() for b in model.buffers())
    assert n_buffers > 0 and param_count(model) < sum(
        p.numel() for p in model.parameters()) + n_buffers


# --- the native decoders --------------------------------------------------------

@pytest.fixture(scope="module")
def native(tmp_path_factory):
    if shutil.which("cc") is None and shutil.which("gcc") is None:
        pytest.skip("no C compiler on this host")
    out = tmp_path_factory.mktemp("native")
    with contextlib.redirect_stdout(io.StringIO()):
        assert build_native.main(["--out-dir", str(out)]) == 0
    module = geotiff.load_native(out)
    assert module is not None and geotiff.native_path(out).exists()
    return module


def test_native_lzw_matches_python(native):
    """The cases of ``test_geotiff.py::test_native_codecs_match_python``:
    random payloads of 0 to 200,000 bytes, LZW-encoded, decode to the same
    bytes natively and in Python, with and without an output limit."""
    rng = np.random.default_rng(0)
    for size in (0, 1, 17, 5000, 200000):
        raw = rng.integers(0, 12, size=size, dtype=np.uint8).tobytes()
        compressed = _lzw_encode_reference(raw)
        assert native.lzw_decode(compressed) == geotiff._lzw_decode_py(compressed) == raw
        assert native.lzw_decode(compressed, size + 1) == raw
    with pytest.raises(ValueError):
        geotiff._lzw_decode_py(_lzw_encode_reference(bytes(5000)), 100)
    with pytest.raises(ValueError):
        native.lzw_decode(_lzw_encode_reference(bytes(5000)), 100)


def test_native_packbits_matches_python(native):
    payload = bytes([257 - 30, 9, 4, 1, 2, 3, 4, 5, 128, 257 - 2, 0])
    assert native.packbits_decode(payload) == geotiff._packbits_decode_py(payload)
    assert native.packbits_decode(bytes([1, 7, 7])) == bytes([7, 7])
    with pytest.raises(ValueError):
        geotiff._packbits_decode_py(payload, 10)
    with pytest.raises(ValueError):
        native.packbits_decode(payload, 10)


@pytest.mark.parametrize("path", sorted(DATA.glob("*.tif")), ids=lambda p: p.name)
def test_native_reads_libtiff_fixtures_as_python(native, monkeypatch, path):
    """Each libtiff-written fixture reads to the same array and metadata
    with the native decoders in place as with the pure-Python ones; the LZW
    files go through the native decoder."""
    calls = []
    counted = types.SimpleNamespace(
        lzw_decode=lambda *a: calls.append("lzw") or native.lzw_decode(*a),
        packbits_decode=lambda *a: calls.append("packbits") or native.packbits_decode(*a))
    monkeypatch.setattr(geotiff, "_fastcodecs", None)
    want, want_meta = geotiff.imread(path)
    monkeypatch.setattr(geotiff, "_fastcodecs", counted)
    got, got_meta = geotiff.imread(path)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == want.dtype
    assert repr(got_meta) == repr(want_meta)
    assert bool(calls) == ("lzw" in path.name)


def test_native_absent_keeps_python(tmp_path):
    """Without a build the loader gives None, and the package's decoders are
    the pure-Python ones."""
    assert geotiff.load_native(tmp_path) is None
    assert geotiff.native_path(tmp_path).parent == tmp_path
    assert geotiff.native_path().parent == geotiff.NATIVE_DIR
