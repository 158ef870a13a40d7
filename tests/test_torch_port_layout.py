"""The training step's memory layout (``train_lib.step_memory_format``) and
what follows it, on the CPU, with no JAX in the process.

On the card the step runs in channels-last; everywhere else in NCHW. Here
the CPU holds the channels-last path to the NCHW one through the plain
versions of the BatchNorm kernels: the module on a channels-last input
gives the NCHW module's output, gradients and running statistics to
float32 rounding (the plain sums and casts are taken in another order of
memory), and one siameseunet and one whatevernet step with the model and
inputs in channels-last give the NCHW step's losses, gradients, parameter
changes and running statistics to float32 tolerance (the CPU's
convolutions take other algorithms per layout). The layout rule, the
wrappers' layout checks, the serving bundle of a channels-last model,
the benchmark's names for the kernels and, on the card, the channels-last
bn_stats launch's plan are held too.

This file also runs on the machine with the card:

    python -m pytest --noconftest -q tests/test_torch_port_layout.py
"""

import re
import zipfile

import pytest
import torch

from benchmark.yardstick.trace import categorize
from multimodal_siamese_cd_tpu_torch import serving, train_lib
from multimodal_siamese_cd_tpu_torch.config import load_cfg
from multimodal_siamese_cd_tpu_torch.models.batchnorm import BatchNorm2d
from multimodal_siamese_cd_tpu_torch.models.factory import create_network
from multimodal_siamese_cd_tpu_torch.ops import _build, batch_norm, bn_stats, layout

torch.set_num_threads(1)

CL = torch.channels_last


def _activation(shape, dtype, seed):
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(shape, generator=gen) * 1.7 + 0.3
    g = torch.randn(shape, generator=gen)
    return x.to(dtype), g.to(dtype)


def _bn_run(x, g, memory_format):
    """One train-mode BatchNorm call and its backward on ``x`` laid out in
    ``memory_format``: output, input, weight and bias gradients, running
    statistics."""
    gen = torch.Generator().manual_seed(4)
    bn = BatchNorm2d(x.shape[1])
    with torch.no_grad():
        for p in (bn.weight, bn.bias, bn.running_mean):
            p.copy_(torch.rand(p.shape, generator=gen) - 0.5)
        bn.weight.add_(1.0)
    xd = x.contiguous(memory_format=memory_format).requires_grad_()
    y = bn(xd)
    (y * g.contiguous(memory_format=memory_format)).sum().backward()
    return [y.detach(), xd.grad, bn.weight.grad, bn.bias.grad, bn.running_mean,
            bn.running_var]


@pytest.mark.parametrize("shape", [(2, 16, 8, 8), (3, 5, 7, 9), (2, 64, 4, 6)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_batchnorm_channels_last_matches_nchw(shape, dtype):
    """A channels-last input keeps its layout through the module, output and
    input gradient, with no layout copy, and gives the NCHW input's numbers
    to float32 rounding (bf16 outputs to one bf16 ulp)."""
    x, g = _activation(shape, dtype, seed=sum(shape))
    copies = BatchNorm2d.layout_copies
    got = _bn_run(x, g, CL)
    assert BatchNorm2d.layout_copies == copies
    want = _bn_run(x, g, torch.contiguous_format)
    assert got[0].is_contiguous(memory_format=CL) and not got[0].is_contiguous()
    assert got[1].is_contiguous(memory_format=CL)
    low = dict(atol=1e-5, rtol=1e-5) if dtype == torch.float32 else \
        dict(atol=2e-2, rtol=1e-2)
    for i, (name, a, b) in enumerate(zip(("y", "dx", "dweight", "dbias",
                                          "running_mean", "running_var"), got, want)):
        tol = low if i < 2 else dict(atol=1e-4, rtol=1e-5)
        torch.testing.assert_close(a.float(), b.float(), msg=name, **tol)


def test_batchnorm_counts_the_copies_it_makes():
    """An input dense in neither layout is copied, and its gradient too when
    it arrives in another layout: each copy counted."""
    x, g = _activation((2, 8, 6, 6), torch.float32, seed=1)
    bn = BatchNorm2d(8)
    copies = BatchNorm2d.layout_copies
    xd = x.transpose(2, 3).requires_grad_()          # dense in neither layout
    y = bn(xd)
    assert BatchNorm2d.layout_copies == copies + 1
    y.backward(g.transpose(2, 3).contiguous(memory_format=CL))
    assert BatchNorm2d.layout_copies == copies + 2


@pytest.mark.parametrize("device, world, shards, want", [
    ("cuda", 1, 1, CL), ("cpu", 1, 1, torch.contiguous_format),
    ("cuda", 2, 1, torch.contiguous_format), ("cuda", 2, 2, torch.contiguous_format),
    ("cuda", 4, 2, torch.contiguous_format), (torch.device("cuda", 0), 1, 1, CL),
])
def test_step_layout_rule(device, world, shards, want):
    """Channels-last exactly on a CUDA device in a world of one rank with no
    height shards."""
    assert train_lib.step_memory_format(device, world, shards) == want


def _stack(batch, side, seed):
    gen = torch.Generator().manual_seed(seed)
    stack = torch.rand((batch, 15, side, side), generator=gen)
    stack[:, 12:] = (stack[:, 12:] > 0.7).float()       # the label planes
    return stack


def _step(cfg, regime, memory_format, stack, labs, monkeypatch):
    """One step of ``cfg``'s model from seeded weights with the step's layout
    set to ``memory_format``: metrics, gradients, parameters before and
    after, and buffers."""
    monkeypatch.setattr(train_lib, "step_memory_format", lambda *a: memory_format)
    model = create_network(cfg, device="cpu", generator=torch.Generator().manual_seed(1))
    before = {k: v.detach().clone() for k, v in model.named_parameters()}
    optimizer = train_lib.make_optimizer(model, cfg)
    step = train_lib.make_train_step(model, optimizer, cfg, regime)
    weights = [p for p in model.parameters() if p.dim() == 4]
    assert all(p.is_contiguous(memory_format=memory_format) for p in weights)
    metrics = step(stack, labs, 0)
    moments = [optimizer.state[p]["exp_avg"] for p in weights]
    assert all(m.stride() == p.stride() for m, p in zip(moments, weights))
    return ({k: float(v) for k, v in metrics.items()},
            {k: p.grad.clone() for k, p in model.named_parameters()}, before,
            {k: p.detach().clone() for k, p in model.named_parameters()},
            {k: b.clone() for k, b in model.named_buffers()})


@pytest.mark.parametrize("model_type, config, regime, knobs", [
    ("siameseunet", "siamese", "supervised", ()),
    ("whatevernet", "siamese_mmcr_alpha0500", "semisupervised", ()),
    ("siameseunet", "siamese", "supervised", ("MODEL.REMAT", "True",
                                               "TRAINER.GRAD_ACCUM", "2")),
    ("siamunet_diff", "siamese", "supervised", ()),
    ("dtsiameseunet", "dtsiamese", "dualtask", ()),
])
def test_channels_last_step_matches_nchw(model_type, config, regime, knobs, monkeypatch):
    """One step at topology [8, 16], batch 2 (whatevernet: a labeled and an
    unlabeled row; siamunet_diff with its dropout; siameseunet also with
    REMAT and two micro-batches), 32 px, fp32, in both layouts from the
    same weights:
    every metric rel 1e-5; every gradient within 1e-4 of its leaf's largest
    plus 1e-6; the parameters' change within 1e-6 wherever the gradient is
    above twice that (AdamW's first step moves an element by ±lr on its
    gradient's sign, so one whose gradient is round-off, as the
    convolution biases' before BatchNorm, may move either way); running
    statistics atol 1e-6."""
    cfg = load_cfg(config)
    cfg.MODEL.TYPE = model_type
    cfg.MODEL.TOPOLOGY = [8, 16]
    cfg.TRAINER.PRECISION = "fp32"
    cfg.merge_from_list(list(knobs))
    stack, labs = _stack(2, 32, seed=5), torch.tensor([1.0, 0.0])
    if regime == "supervised":
        labs = torch.ones(2)
    m_cl, g_cl, before, p_cl, b_cl = _step(cfg, regime, CL, stack, labs, monkeypatch)
    m_n, g_n, _, p_n, b_n = _step(cfg, regime, torch.contiguous_format, stack, labs,
                                  monkeypatch)
    assert m_cl.keys() == m_n.keys()
    for key, value in m_n.items():
        assert m_cl[key] == pytest.approx(value, rel=1e-5, abs=1e-7), key
    for name, want in g_n.items():
        atol = 1e-4 * float(want.abs().max()) + 1e-6
        torch.testing.assert_close(g_cl[name], want, atol=atol, rtol=0, msg=name)
        # AdamW's first step moves an element by lr on its gradient's sign:
        # where the gradient is above the two layouts' gap, the same sign
        sure = want.abs() > 2 * atol
        torch.testing.assert_close((p_cl[name] - before[name])[sure],
                                   (p_n[name] - before[name])[sure], atol=1e-6, rtol=0,
                                   msg=name)
    for name, want in b_n.items():
        torch.testing.assert_close(b_cl[name], want, atol=1e-6, rtol=0, msg=name)


def test_wrappers_take_both_dense_layouts_and_no_other():
    """Each wrapper's check names the layout of two dense ones and refuses
    any other strides, mixed layouts included."""
    x, dy = _activation((2, 16, 4, 6), torch.float32, seed=2)
    v = [torch.rand(16) for _ in range(4)]
    for fmt, want in ((torch.contiguous_format, "nchw"), (CL, "nhwc")):
        xf, dyf = x.contiguous(memory_format=fmt), dy.contiguous(memory_format=fmt)
        assert layout.of(xf) == want and layout.memory_format(xf) == fmt
        assert bn_stats._check(xf, dyf) == want
        assert batch_norm._check({"dy": dyf, "x": xf}, dict(zip("mabg", v))) == want
    odd = x.transpose(2, 3)
    assert layout.of(odd) is None
    mixed = (x, dy.contiguous(memory_format=CL))
    for a, b in ((odd, odd), mixed):
        with pytest.raises(ValueError, match="one layout"):
            bn_stats._check(a, b)
        with pytest.raises(ValueError, match="layout"):
            batch_norm._check({"dy": a, "x": b}, dict(zip("mabg", v)))
    # one channel, one pixel a plane: dense in both, taken as NCHW
    assert layout.of(torch.zeros(2, 1, 3, 3)) == "nchw"
    assert layout.of(torch.zeros(2, 5, 1, 1).contiguous(memory_format=CL)) == "nchw"
    # a view dense in neither is copied to NCHW
    assert layout.memory_format(odd) == torch.contiguous_format


@pytest.mark.cuda
def test_channels_last_launch_plans():
    """Needs the card: the channels-last bn_stats launch's chunks, as its C
    entry plans them from the card's SMs: about four blocks an SM over the
    channel groups, at most one chunk for each 128 rows, the same for two
    calls and either dtype; a launch whose scratch holds other chunks than
    the plan's raises."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the plan is the C entry's, on the card")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for rows, channels, dtype in ((1 << 20, 64, torch.bfloat16), (4096, 512, torch.bfloat16),
                                  (2048, 512, torch.float32), (999, 12, torch.float32)):
        a = torch.zeros((1, channels, rows, 1), dtype=dtype, device="cuda").contiguous(
            memory_format=CL)
        groups = -(-channels // 64)
        chunks = bn_stats.nhwc_chunks(a)
        assert chunks == bn_stats.nhwc_chunks(a.float()) == bn_stats.nhwc_chunks(a.bfloat16())
        assert 1 <= chunks <= min(-(-4 * sms // groups), -(-rows // 128))
        # enough rows: every SM gets blocks
        assert rows < 128 * 4 * sms or chunks * groups >= 2 * sms
    s1, s2 = torch.empty(64, device="cuda"), torch.empty(64, device="cuda")
    a = torch.zeros((1, 64, 4096, 1), device="cuda").contiguous(memory_format=CL)
    partial = torch.empty(64 * 2 * (bn_stats.nhwc_chunks(a) + 1), device="cuda")
    with pytest.raises(RuntimeError, match="mscd_bn_stats_nhwc"):
        bn_stats.launch_nhwc(a, a, s1, s2, partial)


def _bundle_members(model, cfg, path):
    serving.export_serving_bundle(model, cfg, path, buckets=((32, 32),),
                                  platforms="cpu")
    with zipfile.ZipFile(path) as z:
        return {name: z.read(name) for name in z.namelist()}


def test_serving_bundle_of_a_channels_last_model_is_the_nchw_one(tmp_path):
    """A model whose weights are channels-last (one trained on the card)
    exports the same bundle, member for member and byte for byte, as the
    same weights in NCHW, and it serves the same maps."""
    cfg = load_cfg("base")
    cfg.MODEL.TYPE = "siameseunet"
    cfg.MODEL.TOPOLOGY = [8, 16]
    cfg.TRAINER.PRECISION = "fp32"
    model = create_network(cfg, device="cpu", generator=torch.Generator().manual_seed(2))
    want = _bundle_members(model, cfg, tmp_path / "nchw.zip")
    model.to(memory_format=CL)
    assert any(not p.is_contiguous() for p in model.parameters())
    got = _bundle_members(model, cfg, tmp_path / "cl.zip")
    assert got.keys() == want.keys()
    for name, data in want.items():
        assert got[name] == data, name
    served = serving.load_serving_bundle(tmp_path / "cl.zip", device="cpu")
    assert all(leaf.is_contiguous() for leaf in served.leaves)


def _globals(source: str) -> list:
    return re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)\s*\(",
                      source)


@pytest.mark.parametrize("library, category", [("bn_stats", "bn_stats"),
                                               ("batch_norm", "bn/elementwise")])
def test_benchmark_files_every_kernel_under_its_category(library, category):
    """Every ``__global__`` kernel of the BatchNorm sources, the channels-last
    ones included, falls in the benchmark's category for its work, by its
    bare name and by the name a profiler trace gives it, so
    ``bn_stats_roofline`` reads the same work in either layout."""
    names = _globals((_build.CSRC / f"{library}.cu").read_text())
    assert len(names) == 4 and sum("nhwc" in n for n in names) == 2, names
    for name in names:
        for dtype in ("float", "__nv_bfloat16"):
            traced = (f"void (anonymous namespace)::{name}<{dtype}, true>({dtype} const*, "
                      f"float const*, {dtype}*, long long, int)")
            assert categorize(name) == category and categorize(traced) == category, name
