"""The port's measurement modules (``bench``, ``bench_eval``,
``bench_assessment``, ``profile_step``, ``ablate_step``,
``bench_remat_memory``, ``soak_loader``, ``eval_exactness``) on the CPU,
against the JAX package's scripts where they compute the same thing.

Tolerances, each stated at its test:

* the bench's batches against the JAX bench's: bit for bit;
* the bench's window loss against the JAX package's scanned step on the same
  weights and AdamW state (fp32, topology [8, 16], 32 px crops, batch 2,
  K 2, flips and rotations off): atol 1e-5 (``test_torch_port_steps.py``'s);
* the convolution FLOP count against a hand count, the assessment's F1
  against ``inference_loop``'s on the same weights, kernel categories:
  exact.

No time a CPU run prints is a card's: every line names the device it ran on.
"""

import contextlib
import io
import json
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench as jax_bench
from multimodal_siamese_cd_tpu import train_lib as jax_train_lib
from multimodal_siamese_cd_tpu.config import load_cfg as jax_load_cfg
from multimodal_siamese_cd_tpu.models import create_network as jax_create_network
from multimodal_siamese_cd_tpu_torch import (ablate_step, bench, bench_assessment,
                                             bench_eval, bench_remat_memory,
                                             eval_exactness, evaluation, profile_step,
                                             soak_loader)
from multimodal_siamese_cd_tpu_torch.config import load_cfg
from multimodal_siamese_cd_tpu_torch.data.synthetic import generate_fixture_dataset
from multimodal_siamese_cd_tpu_torch.models.factory import create_network
from multimodal_siamese_cd_tpu_torch.weights import state_dict_from_jax
from test_torch_port_semisup import _resumed_optimizers
from test_torch_port_train import _random_variables

torch.set_num_threads(1)

CPU = torch.device("cpu")
SMALL = ["MODEL.TOPOLOGY", "[8,16]", "AUGMENTATION.RANDOM_FLIP", "False",
         "AUGMENTATION.RANDOM_ROTATE", "False", "MODEL.PACKED_FULLRES", "False"]


def _lines(main, argv) -> list:
    """Run ``main(argv)``; its printed JSON lines."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert main(argv) == 0
    return [json.loads(line) for line in out.getvalue().splitlines()
            if line.startswith("{")]


# --- bench ------------------------------------------------------------------------

@pytest.mark.parametrize("k,batch,crop", [(3, 2, 16), (2, 8, 32)])
def test_build_batches_bit_equal_to_the_jax_bench(k, batch, crop):
    """The same seed gives the JAX bench's stacks and label masks, bit for
    bit."""
    ours = bench.build_batches(k, batch, crop, np.random.default_rng(0))
    theirs = jax_bench.build_batches(k, batch, crop, np.random.default_rng(0))
    for a, b in zip(ours, theirs):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def test_build_payload_contract():
    """The line ``test_aux.py::test_bench_payload_contract`` pins for the JAX
    bench, without ``vs_baseline`` and ``vs_torch`` (no reference figure),
    with each regime's step time, loss and mode, and the card it ran on."""
    results = {r: {"value": v, "step_ms": 33.0, "loss": 0.7, "mode": "graph"}
               for r, v in (("supervised", 240.5), ("dualtask", 150.1),
                            ("semisupervised", 120.2))}
    device = {"platform": "gpu", "name": "NVIDIA H100 80GB HBM3", "count": 1,
              "power_limit": "700.00 W"}
    payload = bench.build_payload(results, "supervised", device)
    assert payload["metric"] == "train_patches_per_sec_per_chip"
    assert payload["value"] == 240.5
    assert payload["unit"] == "patches/sec/chip"
    assert payload["regimes"] == {r: v["value"] for r, v in results.items()}
    for regime, rec in payload["per_regime"].items():
        assert {"step_ms", "loss", "mode"} <= set(rec), regime
    assert payload["device"] == device
    assert "vs_baseline" not in payload and "vs_torch" not in payload
    assert json.loads(json.dumps(payload)) == payload


@pytest.mark.parametrize("regime", list(bench.REGIME_MODELS))
def test_bench_window_matches_jax_scanned_step(regime):
    """The bench's calls at ``--device cpu`` (one warm-up and one timed
    window of K = 2 on the JAX bench's stacks) against the JAX package's
    ``make_scanned_train_step`` called the same two times, from one set of
    weights and one resumed AdamW state: the last window's loss within atol
    1e-5, and both windows' modes and printed keys."""
    args = bench.parse_args(["--device", "cpu", "--crop", "32", "--batch-size", "2",
                             "--steps-per-call", "2", "--warmup-calls", "1",
                             "--calls", "1", "--precision", "fp32", "--regime",
                             regime] + SMALL)
    model_type = bench.REGIME_MODELS[regime]
    cfg, model, _ = bench.setup(args, regime, model_type, CPU)
    jcfg = jax_load_cfg("base")
    jcfg.MODEL.TYPE = model_type
    jcfg.TRAINER.PRECISION = "fp32"
    jcfg.AUGMENTATION.CROP_SIZE = 32
    jcfg.TRAINER.BATCH_SIZE = 2
    if regime == "semisupervised":
        jcfg.DATALOADER.INCLUDE_UNLABELED = True
    jcfg.merge_from_list(SMALL)
    jmodel = jax_create_network(jcfg)
    variables = _random_variables(jmodel, jcfg)
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    s = types.SimpleNamespace(jcfg=jcfg, tcfg=cfg, variables=variables, tmodel=model)
    state, optimizer = _resumed_optimizers(s)

    got = bench.measure(args, regime, cfg, model, optimizer, CPU)
    stacks, labs = jax_bench.build_batches(2, 2, 32, np.random.default_rng(0))
    step_fn = jax_train_lib.make_scanned_train_step(jmodel, jcfg, regime)
    for _ in range(2):
        state, m = step_fn(state, jnp.asarray(stacks), jnp.asarray(labs),
                           jax.random.PRNGKey(7))
    assert got["mode"] == "eager" and got["chips"] == 1
    assert got["value"] == got["total"] > 0 and got["step_ms"] > 0
    np.testing.assert_allclose(got["loss"], float(m["loss"]), atol=1e-5)


def _torch_located(name, body):
    """A function whose code object lies in torch's package, as a synchronising
    op's warning site does (the sync debug mode warns from torch's C++)."""
    import os
    import warnings

    ns = {"warnings": warnings}
    src = f"def {name}(*args, **kwargs):\n    {body}\n"
    exec(compile(src, os.path.join(os.path.dirname(torch.__file__), "_sync_fake.py"),
                 "exec"), ns)
    return ns[name]


@pytest.mark.parametrize("controlled", [True, False])
def test_hidden_syncs_counts_call_sites_outside_torch(monkeypatch, controlled):
    """Every synchronising call the sync debug mode reports is counted at the
    innermost frame outside torch's package; the control (a scalar's
    ``.item()`` after the call) is left out, and without it the count is not
    measured (None)."""
    warn = "warnings.warn('called a synchronizing CUDA operation')"
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", lambda mode: None)
    monkeypatch.setattr(torch.Tensor, "item",
                        _torch_located("item", warn if controlled else "return 0.0"))
    hidden = _torch_located("hidden", warn)

    def call():
        for _ in range(2):
            hidden()

    got = bench.hidden_syncs(call, CPU)
    if not controlled:
        assert got is None
        return
    ((site, n),) = got.items()
    assert n == 2 and site.endswith("(call)") and "test_torch_port_bench.py" in site


# --- bench_eval ---------------------------------------------------------------------

def test_model_flops_equals_a_hand_count():
    """``siameseunet`` at topology [8, 16], 6 channels a date, batch 2 at
    64^2: every 3x3 convolution (the stem and two Downs on each date, two
    Ups), the two 2x2 stride-2 transposed convolutions (counted at their
    input) and the 1x1 head."""
    cfg = load_cfg("base")
    cfg.MODEL.TYPE = "siameseunet"
    cfg.MODEL.TOPOLOGY = [8, 16]
    model = create_network(cfg, device=CPU)
    x = torch.zeros((2, 6, 64, 64))
    b = 2

    def c3(cin, cout, side):
        return 2 * cin * cout * 9 * b * side * side

    per_date = (c3(6, 8, 64) + c3(8, 8, 64) + c3(8, 16, 32) + c3(16, 16, 32)
                + c3(16, 16, 16) + c3(16, 16, 16))
    up2 = 2 * 16 * 16 * 4 * b * 16 * 16 + c3(32, 8, 32) + c3(8, 8, 32)
    up1 = 2 * 8 * 8 * 4 * b * 32 * 32 + c3(16, 8, 64) + c3(8, 8, 64)
    head = 2 * 8 * 1 * b * 64 * 64
    assert bench_eval.model_flops(model, x, x) == 2 * per_date + up2 + up1 + head


# --- bench_assessment ---------------------------------------------------------------

@pytest.mark.parametrize("path", ["wire", "item"])
def test_bench_assessment_f1_equals_inference_loop(tmp_path, path):
    """On a 4-AOI dataset of 64^2 scenes the module writes, its timed pass's
    F1 equals ``inference_loop``'s on the same weights and split, exactly,
    and its line has the JAX tool's keys and the device."""
    opts = ["MODEL.TOPOLOGY", "[8,16]", "TRAINER.PRECISION", "fp32"]
    data = tmp_path / "bass"
    argv = ["--device", "cpu", "--scene", "64", "--n-aois", "4", "--data-dir",
            str(data)] + (["--item-path"] if path == "item" else []) + opts
    (line,) = _lines(bench_assessment.main, argv)
    assert {"metric", "value", "unit", "scene_class", "n_scenes",
            "host_only_scenes_per_sec", "e2e_wall_s", "f1", "device"} <= set(line)
    assert (line["metric"], line["n_scenes"], line["scene_class"], line["path"]) == (
        "eval_e2e_scenes_per_sec", 4, 64, path)
    assert line["device"]["platform"] == "cpu"
    cfg = bench_assessment.assessment_cfg(
        data, [bench_assessment.AOI_TMPL.format(i) for i in range(4)])
    cfg.merge_from_list(opts)
    model = create_network(cfg, device=CPU,
                           generator=torch.Generator().manual_seed(bench.SEED))
    f1, _, _ = evaluation.inference_loop(
        model, bench_assessment.assessment_dataset(cfg), device="cpu")["change"]
    assert line["f1"] == f1


def test_bench_assessment_reads_a_foreign_split_and_refuses_to_overwrite(tmp_path):
    """``--data-dir`` on a dataset the module did not write (no marker):
    read as it stands, its labeled AOIs the split, nothing written; a
    directory with neither marker nor ``metadata.json`` is refused."""
    data = tmp_path / "split"
    generate_fixture_dataset(data, seed=11, scene_size=(64, 64), n_timestamps=2,
                             aois={"a_0": True, "a_1": True, "u_0": False})
    before = sorted(p.name for p in data.iterdir())
    assert bench_assessment.ensure_dataset(data, 1000, 32) == ["a_0", "a_1"]
    assert sorted(p.name for p in data.iterdir()) == before
    (tmp_path / "other").mkdir()
    with pytest.raises(SystemExit, match="refusing to overwrite"):
        bench_assessment.ensure_dataset(tmp_path / "other", 64, 2)


# --- profile_step ---------------------------------------------------------------------

# kernels of the port's training step on an NVIDIA H100 80GB HBM3, as
# chip_smoke.py's profiles printed them (at most 90 characters), with the
# kernels of the port's own sources and of torch's foreach AdamW
H100_KERNELS = {
    "sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc_tilesize256x64x32_warpgro":
        "conv/gemm",
    "sm90_xmma_wgrad_indexed_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc_tilesize64x64x64_":
        "conv/gemm",
    "sm90_xmma_dgrad_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc_tilesize128x128x64_warpgr":
        "conv/gemm",
    "void cudnn::engines_precompiled::nchwToNhwcKernel<__nv_bfloat16, __nv_bfloat16, float, fal":
        "transpose",
    "void cudnn::engines_precompiled::nhwcToNchwKernel<__nv_bfloat16, __nv_bfloat16, float, tru":
        "transpose",
    "void bn_stats_partial<__nv_bfloat16, true, true>(__nv_bfloat16 const*, __nv_bfloat16 const*":
        "bn_stats",
    "bn_stats_finalize(float const*, int, int, float*, float*)": "bn_stats",
    "void at::native::elementwise_kernel<128, 2, at::native::gpu_kernel_impl_nocast<at::native:":
        "bn/elementwise",
    "void at::native::unrolled_elementwise_kernel<at::native::direct_copy_kernel_cuda(at::Tenso":
        "bn/elementwise",
    "void at::native::vectorized_elementwise_kernel<4, at::native::CUDAFunctor_add<float>, std:":
        "bn/elementwise",
    "void at::native::vectorized_elementwise_kernel<8, at::native::bfloat16_copy_kernel_cuda(at":
        "bn/elementwise",
    "void at::native::batch_norm_transform_input_kernel<c10::BFloat16, float, float, true, int>":
        "bn/elementwise",
    "void at::native::reduce_kernel<512, 1, at::native::ReduceOp<c10::BFloat16, at::native::fun":
        "reduction",
    "void at::native::(anonymous namespace)::multi_tensor_apply_kernel<at::native::(anonymous na":
        "optimizer",
    "void at::native::(anonymous namespace)::max_pool_backward_nchw<c10::BFloat16, float, int>(":
        "other",
    "void at::native::(anonymous namespace)::max_pool_forward_nchw<c10::BFloat16, int>(int, c10":
        "other",
    "confusion_kernel(float const*, float const*, float const*, float const*, int, long, int, i":
        "confusion",
    "Memcpy HtoD (Pinned -> Device)": "memcpy/memset",
    "Memset (Device)": "memcpy/memset",
}


@pytest.mark.parametrize("name", sorted(H100_KERNELS))
def test_categorize_h100_kernel_names(name):
    assert profile_step.categorize(name) == H100_KERNELS[name]
    assert H100_KERNELS[name] in profile_step.CATEGORIES


def test_summarize_a_trace():
    """Per-step category times and launches, the busy share of the host
    wall time, the top kernels; no device time: the share is not
    measured (None)."""
    conv, transpose = (n for n in H100_KERNELS if n.startswith(("sm90_xmma_fprop",
                                                                 "void cudnn::engines_precompiled::nchw")))
    names = [conv, transpose]
    traced = {"wall_us": 4000.0,
              "kernels": {conv: [300.0, 4], transpose: [100.0, 2],
                          "Memset (Device)": [40.0, 2]}}
    s = profile_step.summarize(traced, steps=2, top=2)
    assert s["categories_ms_per_step"] == pytest.approx(
        {"conv/gemm": 0.15, "transpose": 0.05, "memcpy/memset": 0.02})
    assert s["launches"] == {"conv/gemm": 4, "transpose": 2, "memcpy/memset": 2}
    assert s["device_ms_per_step"] == pytest.approx(0.22)
    assert s["busy_share"] == pytest.approx(440.0 / 4000.0)
    assert [t["kernel"] for t in s["top"]] == [names[0], names[1]]
    assert s["top"][0]["launches"] == 4
    assert profile_step.summarize({"wall_us": 10.0, "kernels": {}}, 1, 5)[
        "busy_share"] is None


def test_trace_holds_the_call_and_not_its_warm_up():
    """``trace`` records ``fn`` once and leaves the profiler's warm-up
    cycle (``WARM_LAUNCHES`` in-place adds) out of what it returns."""
    calls = []

    def fn():
        calls.append(1)
        torch.ones(3).mul(2)

    traced = profile_step.trace(fn, torch.device("cpu"))
    names = [e.name for e in traced["prof"].events()]
    assert calls == [1] and traced["wall_us"] > 0 and traced["kernels"] == {}
    assert names.count("aten::mul") == 1 and "aten::add_" not in names


# --- the other modules at a tiny size -----------------------------------------------

def _tiny(tmp_path):
    small = ["--device", "cpu", "--crop", "32", "--batch-size", "2", "--calls", "1",
             "--warmup-calls", "1", "--precision", "fp32", "MODEL.TOPOLOGY", "[8,16]"]
    return {
        "bench": (bench.main, ["--steps-per-call", "2"] + small,
                  ["train_patches_per_sec_per_chip"]),
        "bench_k1": (bench.main, ["--regime", "supervised", "--steps-per-call", "1"]
                     + small, ["train_patches_per_sec_per_chip"]),
        "bench_eval": (bench_eval.main, ["--device", "cpu", "--scene", "64", "--group",
                                         "2", "--calls", "1", "--sol", "MODEL.TOPOLOGY",
                                         "[8,16]"], ["eval_scenes_per_sec"]),
        "ablate_step": (ablate_step.main, ["--device", "cpu", "--batch-sizes", "2",
                                           "--k", "2", "AUGMENTATION.CROP_SIZE", "32",
                                           "MODEL.TOPOLOGY", "[8,16]"],
                        ["step_segments_ms"]),
        "bench_remat_memory": (bench_remat_memory.main,
                               ["--device", "cpu", "--crop", "32", "--batch", "4",
                                "--grad-accum", "2", "MODEL.TOPOLOGY", "[8,16]"],
                               [None] * 4 + ["remat_memory"]),
        "soak_loader": (soak_loader.main, ["--scene", "64", "--seconds", "0.3",
                                           "--batch", "2", "--wire", "--data-dir",
                                           str(tmp_path / "soak")],
                        ["loader_soak_samples_per_sec"]),
    }


@pytest.mark.parametrize("name", ["bench", "bench_k1", "bench_eval", "ablate_step",
                                  "bench_remat_memory", "soak_loader"])
def test_module_prints_its_lines(tmp_path, name):
    """Each module at a tiny size prints its JSON lines, each naming where it
    ran; none reports a device number from the CPU."""
    main, argv, metrics = _tiny(tmp_path)[name]
    lines = _lines(main, argv)
    assert [line.get("metric") for line in lines] == metrics
    for line in lines:
        if name == "soak_loader":
            assert line["device"] == "host"
            assert line["alone"] > 0 and line["with_eval_host_work"] > 0
        elif "device" in line:
            assert line["device"]["platform"] == "cpu"
    if name == "bench_remat_memory":
        assert [r["label"] for r in lines[:4]] == ["plain", "remat", "grad_accum_2",
                                                   "remat+grad_accum_2"]
        assert all(r["max_allocated_mib"] == "not measured"
                   and r["device"]["platform"] == "cpu" for r in lines[:4])
        # REMAT recomputes the same step
        assert lines[1]["loss"] == pytest.approx(lines[0]["loss"], abs=1e-6)
    if name in ("bench", "bench_k1"):
        want = ["supervised"] if name == "bench_k1" else list(bench.REGIME_MODELS)
        assert list(lines[0]["regimes"]) == want
        assert all(r["mode"] == "eager" and r["step_ms"] > 0
                   for r in lines[0]["per_regime"].values())
    if name == "bench_eval":
        assert lines[0]["peak_gib"] == "not measured"
        assert "bf16_peak_share" not in lines[0] and lines[0]["tflop_per_group"] > 0


@pytest.mark.parametrize("flag,code", [("--wedge-timeout", 2), ("--deadline", 3)])
def test_bench_watchdogs_exit_with_a_failure_line(flag, code):
    """A watchdog that fires (no warm-up call within ``--wedge-timeout``, or
    the run past ``--deadline``) ends the process with its exit code and one
    JSON line that says why, instead of hanging."""
    import subprocess
    import sys

    argv = [sys.executable, "-m", "multimodal_siamese_cd_tpu_torch.bench", "--device",
            "cpu", "--crop", "32", "--batch-size", "2", "--steps-per-call", "2",
            "--calls", "50", "--precision", "fp32", "--regime", "supervised",
            "--wedge-timeout", "600", flag, "0.05", "MODEL.TOPOLOGY", "[8,16]"]
    run = subprocess.run(argv, capture_output=True, text=True, timeout=120,
                         cwd=str(Path(__file__).resolve().parent.parent))
    assert run.returncode == code, run.stderr
    (line,) = [json.loads(l) for l in run.stdout.splitlines() if l.startswith("{")]
    assert line["value"] == 0.0 and line["error"].startswith("BENCH")
    assert line["device"]["platform"] == "cpu"


def test_bench_refuses_a_world_of_ranks(monkeypatch):
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(SystemExit, match="world of one process"):
        bench.main(["--device", "cpu"])


def test_bench_remat_memory_refuses_a_tpu_topology():
    with pytest.raises(SystemExit):
        bench_remat_memory.main(["--device", "cpu", "--topology", "v5e-4"])


@pytest.mark.parametrize("module", [bench, bench_eval, bench_assessment, profile_step,
                                    ablate_step, bench_remat_memory, eval_exactness],
                         ids=lambda m: m.__name__.rsplit(".", 1)[-1])
def test_device_module_needs_the_card(module, monkeypatch):
    """Without ``--device cpu``, on a host without a card, ``main`` raises
    before it does any work, instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card; the default device resolves")
    monkeypatch.setattr(module, "load_cfg",
                        lambda *a: pytest.fail("ran past the device check"),
                        raising=False)
    with pytest.raises(RuntimeError, match="CUDA"):
        module.main([])
