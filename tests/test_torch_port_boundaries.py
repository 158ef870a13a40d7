"""The port stands alone: it imports nothing of JAX or of the JAX package,
and its entry points default to the card instead of running on the CPU
unasked."""

import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "multimodal_siamese_cd_tpu_torch"
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "ml_dtypes",
             "multimodal_siamese_cd_tpu"}
PORT_MODULES = [
    "device", "config", "geotiff", "geofiles", "data.cache", "data.dataset",
    "data.synthetic", "models.blocks", "models.networks", "models.factory",
    "weights", "train_lib", "metrics", "ops.confusion", "ops._build",
    "evaluation",
    # slice 2: supervised training
    "losses", "ops.bn_stats", "models.batchnorm", "data.augmentations",
    "data.loader", "wandb_compat", "checkpoints", "parsers",
    "experiment_manager", "trainers", "train_supervised",
    # slice 3: dual-task training and assessment, the conv3x3 op
    "train_supervised_dualtask", "ops.conv3x3",
    # slice 5: semi-supervised training
    "train_semisupervised",
    # slice 6: siamunet_diff, the offline assessment, figure and dataset CLIs
    "png", "bitmap_font", "visualization", "spacenet7", "dataset_helpers",
    "assessment_change", "assessment_semantics", "qualitative_comparison",
    "sanity_check", "preprocessing", "upload_study_area",
    # slice 7: serving
    "serving", "export_serving",
    # slice 8: data parallelism over processes
    "parallel.distributed", "parallel.group", "parallel.cluster_check",
    # slice 9: height sharding over a (data, space) grid of ranks
    "parallel.halo",
    # slice 11: the training lifecycle tools and the native GeoTIFF decode
    "convergence_run", "lifecycle_run", "build_native",
    # slice 12: the measurement surface
    "bench", "bench_eval", "bench_assessment", "profile_step", "ablate_step",
    "bench_remat_memory", "soak_loader", "eval_exactness",
    # slice 13: the entry points and the collective count
    "graft_entry", "model_scaling",
]


def _port_files():
    return sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]


def test_every_slice_module_exists():
    for mod in PORT_MODULES:
        assert (PORT / (mod.replace(".", "/") + ".py")).is_file(), mod
    assert (PORT / "ops" / "csrc" / "confusion.cu").is_file()
    assert (PORT / "ops" / "csrc" / "bn_stats.cu").is_file()
    assert (PORT / "ops" / "csrc" / "conv3x3.cu").is_file()


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: p.name)
def test_no_jax_imports(path):
    """AST scan of every import statement, at any depth."""
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, \
                f"{path.relative_to(REPO)}:{node.lineno} imports {name}"


def test_imports_with_jax_blocked():
    """Every module of the port, and chip_smoke.py, import in a fresh
    interpreter where importing jax or the JAX package raises."""
    blocked = sorted(FORBIDDEN)
    mods = [f"multimodal_siamese_cd_tpu_torch.{m}" for m in PORT_MODULES]
    code = (
        "import importlib, sys\n"
        f"for name in {blocked!r}:\n"
        "    sys.modules[name] = None\n"
        f"for mod in {mods!r} + ['chip_smoke']:\n"
        "    importlib.import_module(mod)\n"
        f"assert not any(m in sys.modules and sys.modules[m] is not None "
        f"for m in {blocked!r})\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_entry_points_default_to_the_card():
    """Without ``device=`` the entry points ask for CUDA and raise on a
    host without it, rather than running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card; the default device resolves")
    from multimodal_siamese_cd_tpu_torch import evaluation
    from multimodal_siamese_cd_tpu_torch.config import load_cfg
    from multimodal_siamese_cd_tpu_torch.device import resolve_device
    from multimodal_siamese_cd_tpu_torch.models.factory import create_network

    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    assert resolve_device("cpu") == torch.device("cpu")
    cfg = load_cfg("siamese")
    cfg.MODEL.TOPOLOGY = [8, 16]
    with pytest.raises(RuntimeError, match="CUDA"):
        create_network(cfg)
    model = create_network(cfg, device="cpu")
    item = {"x_t1": np.zeros((16, 16, 6), np.float32),
            "x_t2": np.zeros((16, 16, 6), np.float32),
            "y_change": np.zeros((16, 16, 1), np.float32)}
    with pytest.raises(RuntimeError, match="CUDA"):
        evaluation.inference_loop(model, [item])
    with pytest.raises(RuntimeError, match="CUDA"):
        evaluation.scene_probabilities(model, item)
    f1, _, _ = evaluation.inference_loop(model, [item], device="cpu")["change"]
    assert np.isfinite(f1)


def test_cluster_check_run_case_defaults_to_the_card():
    """``cluster_check.run_case`` without ``device`` asks for the card and
    raises on a host without one, before it runs the case."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card; the default device resolves")
    from multimodal_siamese_cd_tpu_torch.parallel import cluster_check

    case = {"name": "step", "kind": "step", "config": "siamese"}
    with pytest.raises(RuntimeError, match="CUDA"):
        cluster_check.run_case(case)


def test_chip_smoke_refuses_without_the_card_or_the_repo(tmp_path):
    """No CUDA: non-zero exit and no result line. Alone in a directory
    without the package: the same."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    here = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    alone = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                           env=env, capture_output=True, text=True, timeout=120)
    for run in (here, alone):
        assert run.returncode != 0
        assert '"ok": true' not in run.stdout
