"""The port's serving bundle (``serving.py``, ``export_serving.py``) against
the JAX package's, on the CPU, from one set of weights.

The JAX side is its own serving test's setting (``tests/test_serving.py``
``_cfg``: ``configs/base.yaml``, topology [8, 16], fp32, buckets 32 and 64)
with numpy-drawn variables (random BatchNorm statistics included), exported
``platforms=("cpu",)``; the port gets the same variables through
``weights.state_dict_from_jax`` and exports ``platforms="cpu"``.
Tolerances: served probabilities against the JAX package's bundle atol 1e-5
(bucket-sized, padded, batched with a partial chunk, bf16 weights,
multi-head); against the port's own ``eval_forward`` atol 1e-6;
``predict_batch`` against ``predict`` atol 1e-6.
"""

import os
import subprocess
import sys
import types
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from multimodal_siamese_cd_tpu import serving as jax_serving
from multimodal_siamese_cd_tpu.models import create_network as jax_create_network
from multimodal_siamese_cd_tpu_torch import (checkpoints, export_serving, serving,
                                             train_lib)
from multimodal_siamese_cd_tpu_torch.config import load_cfg
from multimodal_siamese_cd_tpu_torch.models.factory import create_network
from multimodal_siamese_cd_tpu_torch.weights import state_dict_from_jax
from test_serving import _cfg as jax_cfg
from test_torch_port_train import _random_variables

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
BUCKETS = ((32, 32), (64, 64))
SIZES = [(32, 32), (30, 28), (40, 50), (33, 40)]


def _port_cfg(model_type):
    cfg = load_cfg("base")
    cfg.MODEL.TYPE = model_type
    cfg.MODEL.TOPOLOGY = [8, 16]
    cfg.TRAINER.PRECISION = "fp32"
    return cfg


def _bundles(root, model_type="siameseunet", weights_dtype="fp32",
             batch_sizes=(1,), seed=3):
    """The JAX package's and the port's bundles of one set of variables."""
    jcfg = jax_cfg(model_type)
    jmodel = jax_create_network(jcfg)
    variables = _random_variables(jmodel, jcfg, seed=seed)
    state = types.SimpleNamespace(params=variables["params"],
                                  batch_stats=variables["batch_stats"])
    jpath = jax_serving.export_serving_bundle(
        jmodel, state, jcfg, root / f"jax_{model_type}_{weights_dtype}.zip",
        buckets=BUCKETS, platforms=("cpu",), weights_dtype=weights_dtype,
        batch_sizes=batch_sizes)
    tcfg = _port_cfg(model_type)
    tmodel = create_network(tcfg, device="cpu")
    tmodel.load_state_dict(state_dict_from_jax(variables), strict=True)
    tpath = serving.export_serving_bundle(
        tmodel, tcfg, root / f"port_{model_type}_{weights_dtype}.zip",
        buckets=BUCKETS, platforms="cpu", weights_dtype=weights_dtype,
        batch_sizes=batch_sizes)
    return types.SimpleNamespace(
        jax=jax_serving.load_serving_bundle(jpath),
        port=serving.load_serving_bundle(tpath, device="cpu"),
        path=tpath, model=tmodel, cfg=tcfg)


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    return _bundles(tmp_path_factory.mktemp("serving"), batch_sizes=(1, 4))


def _scene(rng, h, w, c=6):
    return (rng.uniform(0, 1, (h, w, c)).astype(np.float32),
            rng.uniform(0, 1, (h, w, c)).astype(np.float32))


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_predict_matches_jax(pair, size):
    """A bucket-sized scene and three padded ones (routed to the 32 or the
    64 bucket): the port's map equals the JAX package's, atol 1e-5."""
    x1, x2 = _scene(np.random.default_rng(size[0] * 100 + size[1]), *size)
    got = pair.port.predict(x1, x2)
    want = np.asarray(pair.jax.predict(x1, x2))
    assert got.shape == want.shape == size and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-5)
    assert want.std() > 1e-3     # not vacuous


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_predict_matches_eval_forward(pair, size):
    """The bundle against the port's own ``eval_forward`` on the scene
    zero-padded to its bucket and cropped back: atol 1e-6."""
    x1, x2 = _scene(np.random.default_rng(size[0] + size[1]), *size)
    bh, bw = (32, 32) if max(size) <= 32 else (64, 64)

    def nchw(a):
        a = np.pad(a, ((0, bh - a.shape[0]), (0, bw - a.shape[1]), (0, 0)))
        return torch.from_numpy(np.ascontiguousarray(a.transpose(2, 0, 1)[None]))

    want = train_lib.eval_forward(pair.model, nchw(x1), nchw(x2))[0, 0].numpy()
    np.testing.assert_allclose(pair.port.predict(x1, x2), want[:size[0], :size[1]],
                               atol=1e-6)


def test_predict_batch_matches_jax(pair):
    """Batch sizes (1, 4), six mixed-size pairs: three in each bucket, so
    each bucket runs one partial chunk zero-padded to 4. Equal to the JAX
    package's ``predict_batch`` (atol 1e-5) and to the port's ``predict``
    (atol 1e-6)."""
    assert pair.port.batch_sizes == [1, 4]
    rng = np.random.default_rng(9)
    pairs = [_scene(rng, h, w) for h, w in
             [(32, 32), (30, 28), (64, 64), (40, 50), (32, 32), (33, 40)]]
    got = pair.port.predict_batch(pairs)
    want = pair.jax.predict_batch(pairs)
    for (x1, x2), g, w in zip(pairs, got, want):
        assert g.shape == x1.shape[:2]
        np.testing.assert_allclose(g, np.asarray(w), atol=1e-5)
        np.testing.assert_allclose(g, pair.port.predict(x1, x2), atol=1e-6)


def _fresh(pair):
    """A model of ``pair``'s bundle with no staging buffer yet."""
    return serving.load_serving_bundle(pair.path, device="cpu")


@pytest.mark.parametrize("call", ["predict", "predict_batch"])
def test_staging_leaves_nothing_stale(pair, pieces, call):
    """Larger scenes, then smaller ones in the same bucket, on one model:
    the smaller ones' maps are bit-equal to a fresh model's, so nothing the
    larger call staged reaches the artifact (``predict_batch``: two pairs
    through the batch-4 artifact after four larger ones)."""
    rng = np.random.default_rng(11)
    served, fresh = _fresh(pair), _fresh(pair)
    big = [_scene(rng, 64, 64) for _ in range(4)]
    small = [_scene(rng, 40, 50), _scene(rng, 33, 36)]
    if call == "predict":
        served.predict(*big[0])
        got, want = [served.predict(*small[0])], [fresh.predict(*small[0])]
    else:
        served.predict_batch(big)
        got, want = served.predict_batch(small), fresh.predict_batch(small)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == np.float32
        np.testing.assert_array_equal(g, w)


def test_returned_maps_alias_no_buffer(pair):
    """A returned map is unchanged by the calls after it."""
    rng = np.random.default_rng(12)
    served = _fresh(pair)
    a, b = _scene(rng, 40, 50), _scene(rng, 40, 50)
    first = served.predict(*a)
    batch = served.predict_batch([a, b])
    kept = [first.copy()] + [m.copy() for m in batch]
    served.predict(*b)
    served.predict_batch([b, a])
    for got, want in zip([first] + batch, kept):
        np.testing.assert_array_equal(got, want)


@pytest.fixture(params=["whole", "pieces"])
def pieces(request, monkeypatch):
    """The staging copy as one piece a scene, or cut into pieces of 1 KiB
    over three threads (as ~1000² scenes are)."""
    if request.param == "pieces":
        monkeypatch.setattr(serving, "_PIECE_BYTES", 1024)
        monkeypatch.setattr(serving, "_COPY_THREADS", 3)
    return request.param


@pytest.mark.parametrize("form", ["channel_planar", "row_strided", "float64", "fortran",
                                  "float16", "flipped"])
def test_staging_takes_any_layout_and_dtype(pair, pieces, form):
    """Channel-planar crops (as the benchmark's serving traffic sends: an
    ``(H, W, C)`` view of a ``(C, H, W)`` scene), row-strided crops of an
    ``(H, W, C)`` scene, float64, Fortran-ordered, float16 and flipped
    (negative-stride) scenes serve the maps of the same values as
    contiguous float32, bit for bit."""
    rng = np.random.default_rng(13)
    if form == "channel_planar":
        whole = [np.moveaxis(rng.uniform(0, 1, (6, 64, 64)).astype(np.float32), 0, -1)
                 for _ in range(2)]
        x = [a[5:45, 7:57] for a in whole]
    elif form == "row_strided":
        x = [a[5:45, 7:57] for a in _scene(rng, 64, 64)]
    elif form == "float64":
        x = [rng.uniform(0, 1, (40, 50, 6)) for _ in range(2)]
    elif form == "fortran":
        x = [np.asfortranarray(a) for a in _scene(rng, 40, 50)]
    elif form == "float16":
        x = [a.astype(np.float16) for a in _scene(rng, 40, 50)]
    else:
        x = [a[::-1, :, ::-1] for a in _scene(rng, 40, 50)]
    assert form in ("float64", "float16") or not x[0].flags.c_contiguous
    want = _fresh(pair).predict(*(np.ascontiguousarray(a, np.float32) for a in x))
    np.testing.assert_array_equal(pair.port.predict(*x), want)


def test_predict_batch_one_bucket_mixed_sizes(pair):
    """Five pairs of five sizes in the 64 bucket (a chunk of 4, then 1):
    each map equals ``predict``'s (atol 1e-6, the batch-4 artifact against
    the batch-1 one)."""
    rng = np.random.default_rng(14)
    pairs = [_scene(rng, h, w) for h, w in [(64, 64), (40, 50), (33, 40), (60, 36), (50, 64)]]
    for (x1, x2), got in zip(pairs, pair.port.predict_batch(pairs)):
        assert got.shape == x1.shape[:2]
        np.testing.assert_allclose(got, pair.port.predict(x1, x2), atol=1e-6)


def test_concurrent_callers_get_serial_maps(pair, pieces):
    """More threads than cores calling ``predict`` on one model, through
    shared staging buffers and with the interpreter switching threads
    often, get the maps of serial calls, bit for bit, and every call is
    counted."""
    from concurrent.futures import ThreadPoolExecutor

    rng = np.random.default_rng(15)
    served = _fresh(pair)
    scenes = [_scene(rng, h, w) for h, w in
              [(64, 64), (40, 50), (33, 40), (60, 36), (32, 32), (30, 28)]]
    serial = [served.predict(*s) for s in scenes]
    workers, rounds = (os.cpu_count() or 1) + 2, 3
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with ThreadPoolExecutor(workers) as pool:
            futures = [pool.submit(served.predict, *scenes[i % len(scenes)])
                       for i in range(rounds * workers)]
            for i, f in enumerate(futures):
                np.testing.assert_array_equal(f.result(timeout=120), serial[i % len(scenes)])
    finally:
        sys.setswitchinterval(interval)
    assert served.staging_stats()["calls"] == len(scenes) + rounds * workers


def test_staging_counts(pair):
    """Every artifact call is staged and counted (unpinned on the CPU); a
    buffer is made once per (batch, bucket), so ten calls in one bucket
    reuse it nine times."""
    rng = np.random.default_rng(16)
    served = _fresh(pair)
    assert served.staging_stats() == {"calls": 0, "pinned": 0, "unpinned": 0,
                                      "allocations": 0, "reuse": None}
    for i in range(10):
        served.predict(*_scene(rng, 40 + i, 50))
    stats = served.staging_stats()
    assert stats == {"calls": 10, "pinned": 0, "unpinned": 10, "allocations": 1,
                     "reuse": 0.9}
    assert stats["reuse"] >= 1 - 1 / stats["calls"]
    served.predict(*_scene(rng, 32, 32))      # the 32 bucket: a buffer of its own
    # the 64 bucket in chunks of 4 (a new buffer) and 1, the 32 bucket in 1
    served.predict_batch([_scene(rng, 64, 64) for _ in range(5)] + [_scene(rng, 30, 28)])
    assert served.staging_stats() == {"calls": 14, "pinned": 0, "unpinned": 14,
                                      "allocations": 3, "reuse": 1 - 3 / 14}


def test_bf16_weights_match_jax(tmp_path):
    """bf16 weight storage. The port widens the stored bf16 weights back to
    float32 and computes as before, so its bf16 bundle equals the JAX
    package's fp32 bundle of the same bf16-rounded weights (atol 1e-5).
    The JAX package's own bf16 bundle computes BatchNorm's multiplier
    ``rsqrt(var + eps) · scale`` in bf16 when those leaves are bf16 (flax's
    dtype promotion): one more bf16 rounding, relative 2^-9, per
    BatchNorm, which moves its probabilities by up to 1.4e-3 from its
    own fp32 bundle of the rounded weights on these scenes; the port is
    held to that bundle within 5e-3."""
    import ml_dtypes

    s = _bundles(tmp_path, weights_dtype="bf16")
    assert s.port.meta["weights_dtype"] == "bf16"
    assert s.port.meta["bf16_leaves"] and all(
        leaf.dtype == torch.float32 for i, leaf in enumerate(s.port.leaves)
        if i in s.port.meta["bf16_leaves"])
    jcfg = jax_cfg("siameseunet")
    jmodel = jax_create_network(jcfg)
    rounded = jax.tree_util.tree_map(
        lambda a: np.asarray(a).astype(ml_dtypes.bfloat16).astype(np.float32),
        _random_variables(jmodel, jcfg, seed=3))
    jpath = jax_serving.export_serving_bundle(
        jmodel, types.SimpleNamespace(params=rounded["params"],
                                      batch_stats=rounded["batch_stats"]),
        jcfg, tmp_path / "jax_rounded.zip", buckets=BUCKETS, platforms=("cpu",))
    rounded_fp32 = jax_serving.load_serving_bundle(jpath)
    for size in SIZES:
        x1, x2 = _scene(np.random.default_rng(sum(size)), *size)
        got = s.port.predict(x1, x2)
        np.testing.assert_allclose(got, np.asarray(rounded_fp32.predict(x1, x2)),
                                   atol=1e-5)
        np.testing.assert_allclose(got, np.asarray(s.jax.predict(x1, x2)), atol=5e-3)


def test_multihead_model_serves_its_first_head_like_jax(tmp_path):
    """``dtsiameseunet``: the bundle serves the change head, as the JAX
    package's does (atol 1e-5)."""
    s = _bundles(tmp_path, model_type="dtsiameseunet", seed=4)
    assert s.port.meta["model_type"] == "dtsiameseunet"
    x1, x2 = _scene(np.random.default_rng(1), 40, 50)
    np.testing.assert_allclose(s.port.predict(x1, x2),
                               np.asarray(s.jax.predict(x1, x2)), atol=1e-5)


def test_bundle_layout(pair):
    """Weights once, as graph inputs: the artifacts carry no tensors of
    their own; one artifact per (platform, batch, bucket)."""
    import zipfile

    with zipfile.ZipFile(pair.path) as z:
        names = set(z.namelist())
    assert names == {"meta.json", "variables.npz"} | {
        f"cpu/{stem}.pt2" for stem in ("fwd_32x32", "fwd_64x64", "fwd_b4_32x32",
                                        "fwd_b4_64x64")}
    meta = pair.port.meta
    assert meta["platforms"] == ["cpu"] and meta["compute_dtype"] == {"cpu": "torch.float32"}
    assert meta["in_channels"] == 6 and meta["input_mode"] == "s1s2"
    assert meta["torch_version"] == torch.__version__
    assert len(pair.port.leaves) == len(pair.model.state_dict())
    import io

    with zipfile.ZipFile(pair.path) as z:
        for name in sorted(names - {"meta.json", "variables.npz"}):
            ep = torch.export.load(io.BytesIO(z.read(name)))
            # no weights, constants or example inputs ride in an artifact
            assert not ep.state_dict and not ep.constants, name
            assert ep.example_inputs is None, name


def test_errors_name_the_problem(pair, tmp_path):
    """The JAX package's four ValueErrors, with its wording: an oversized
    scene, a channel mismatch, unequal bitemporal shapes and a corrupt
    bundle named by its path (a missing file keeps FileNotFoundError)."""
    x = np.zeros((100, 100, 6), np.float32)
    with pytest.raises(ValueError, match="exceeds every exported bucket"):
        pair.port.predict(x, x)
    x = np.zeros((32, 32, 4), np.float32)
    with pytest.raises(ValueError, match="expected 6 channels"):
        pair.port.predict(x, x)
    with pytest.raises(ValueError, match="bitemporal shapes differ"):
        pair.port.predict(np.zeros((32, 32, 6), np.float32),
                          np.zeros((32, 30, 6), np.float32))
    f = tmp_path / "b.zip"
    with pytest.raises(FileNotFoundError):
        serving.load_serving_bundle(f, device="cpu")
    f.write_bytes(b"PKgarbage" * 50)
    with pytest.raises(ValueError, match="serving bundle .*b.zip"):
        serving.load_serving_bundle(f, device="cpu")
    import zipfile

    with zipfile.ZipFile(f, "w") as z:   # valid zip, missing members
        z.writestr("meta.json", "{}")
    with pytest.raises(ValueError, match="serving bundle .*b.zip"):
        serving.load_serving_bundle(f, device="cpu")


def test_platforms(pair, tmp_path):
    """``tpu`` is no platform here; ``gpu`` is ``cuda``; a bundle without
    artifacts for the loading device's platform is refused, never run on
    another; exporting for ``cuda`` needs the card."""
    with pytest.raises(ValueError, match="unknown serving platform 'tpu'"):
        serving.export_serving_bundle(pair.model, pair.cfg, tmp_path / "t.zip",
                                      buckets=BUCKETS, platforms="tpu")
    assert serving._platforms(["cpu", "cpu"], pair.model) == ["cpu"]
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    with pytest.raises(RuntimeError, match="CUDA"):
        serving.export_serving_bundle(pair.model, pair.cfg, tmp_path / "g.zip",
                                      buckets=BUCKETS, platforms=["gpu"])
    with pytest.raises(RuntimeError, match="CUDA"):
        serving.ServingModel(pair.path)          # device=None is the card
    with pytest.raises(RuntimeError, match="CUDA"):
        serving.load_serving_bundle(pair.path)
    import json
    import zipfile

    cuda_only = tmp_path / "cuda_only.zip"
    with zipfile.ZipFile(pair.path) as src, zipfile.ZipFile(cuda_only, "w") as dst:
        for name in src.namelist():
            data = src.read(name)
            if name == "meta.json":
                meta = json.loads(data)
                meta["platforms"] = ["cuda"]
                data = json.dumps(meta)
            dst.writestr(name, data)
    with pytest.raises(ValueError, match="no artifacts for platform 'cpu'"):
        serving.ServingModel(cuda_only, device="cpu")


def test_batch_one_always_exported(pair, tmp_path):
    """``predict`` routes through the batch-1 artifact, so the export adds
    batch 1 when the caller asks only for larger batches."""
    path = serving.export_serving_bundle(pair.model, pair.cfg, tmp_path / "nob1.zip",
                                         buckets=((32, 32),), platforms="cpu",
                                         batch_sizes=(4,))
    served = serving.load_serving_bundle(path, device="cpu")
    assert served.batch_sizes == [1, 4]
    x1, x2 = _scene(np.random.default_rng(2), 32, 32)
    np.testing.assert_allclose(served.predict(x1, x2), pair.port.predict(x1, x2),
                               atol=1e-6)


def test_cli_round_trip(tmp_path, capsys):
    """``export_serving.main`` on a trainer checkpoint: it prints the JAX
    tool's line, and the bundle serves the checkpoint's ``eval_forward``."""
    cfg = load_cfg("debug")
    cfg.NAME = "debug"
    cfg.PATHS.OUTPUT = str(tmp_path)
    cfg.TRAINER.PRECISION = "fp32"
    model = create_network(cfg, device="cpu", generator=torch.Generator().manual_seed(2))
    checkpoints.save_checkpoint(model, train_lib.make_optimizer(model, cfg), 1, 7, cfg)
    dest = tmp_path / "bundle.zip"
    path = export_serving.main(
        ["-c", "debug", "-p", "proj", "-o", str(tmp_path), "-d", str(tmp_path),
         "--dest", str(dest), "--epoch", "1", "--buckets", "32",
         "--platforms", "cpu", "--weights", "fp32", "--batch-sizes", "1,2",
         "--device", "cpu", "TRAINER.PRECISION", "fp32"])
    assert path == dest and dest.exists()
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith(f"exported step-7 checkpoint to {dest} (")
    assert line.endswith("MB, buckets=[(32, 32)], batch_sizes=[1, 2], weights=fp32)")
    served = serving.load_serving_bundle(dest, device="cpu")
    x1, x2 = _scene(np.random.default_rng(0), 32, 32)
    loaded, _, _ = checkpoints.load_checkpoint(1, cfg, device="cpu")
    want = train_lib.eval_forward(
        loaded, torch.from_numpy(x1.transpose(2, 0, 1)[None].copy()),
        torch.from_numpy(x2.transpose(2, 0, 1)[None].copy()))[0, 0].numpy()
    np.testing.assert_allclose(served.predict(x1, x2), want, atol=1e-6)


def test_loads_with_torch_and_numpy_only(pair):
    """A fresh interpreter where the port's models, config and training
    code (and JAX) cannot be imported loads the bundle and serves the same
    map (atol 1e-6: that interpreter runs torch's CPU kernels on its own
    thread count)."""
    x1, x2 = _scene(np.random.default_rng(5), 40, 50)
    np.save(pair.path.parent / "x1.npy", x1)
    np.save(pair.path.parent / "x2.npy", x2)
    np.save(pair.path.parent / "want.npy", pair.port.predict(x1, x2))
    blocked = ["multimodal_siamese_cd_tpu_torch.models",
               "multimodal_siamese_cd_tpu_torch.config",
               "multimodal_siamese_cd_tpu_torch.train_lib",
               "jax", "flax", "multimodal_siamese_cd_tpu"]
    d = pair.path.parent
    code = (
        "import sys\n"
        f"for name in {blocked!r}:\n"
        "    sys.modules[name] = None\n"
        "import numpy as np\n"
        "from multimodal_siamese_cd_tpu_torch import serving\n"
        f"s = serving.ServingModel({str(pair.path)!r}, device='cpu')\n"
        f"got = s.predict(np.load({str(d / 'x1.npy')!r}), np.load({str(d / 'x2.npy')!r}))\n"
        f"assert np.abs(got - np.load({str(d / 'want.npy')!r})).max() <= 1e-6\n"
        "assert not any(m.startswith('multimodal_siamese_cd_tpu_torch.models') "
        "and sys.modules[m] is not None for m in sys.modules)\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
