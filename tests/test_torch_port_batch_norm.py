"""Train-mode BatchNorm's elementwise kernels (``ops.batch_norm``) and the
module that calls them, with no JAX in the process.

This file imports only the port, torch and numpy, so it also runs on the
machine with the card:

    python -m pytest --noconftest -q tests/test_torch_port_batch_norm.py

The yardstick is the train-mode BatchNorm as it was before the kernels,
kept here literally (:class:`_FormerTrainBatchNorm`: its normalisation
five float32 passes, its ``dx`` eight). On the CPU the module, now routed
through ``batch_norm_apply`` / ``batch_norm_dx`` and their plain versions,
gives the former module's output, gradients and running statistics bit
for bit; the wrappers reject what the kernels do not take, and the vector
width divides every plane. On the card the ``cuda``-marked tests hold both
kernels bit-equal (``torch.equal``) to the plain versions at every U-Net
level of batch 8 and 16 and at ragged shapes, in bf16 and float32, also
inside a captured CUDA graph; every element of an output written, and a
width the plane does not take refused; the module bit-equal to the former module;
and count one launch of each kernel per BatchNorm call of a siameseunet
step. The channels-last kernels (the training step's layout on the card)
are held bit-equal to the NCHW kernels on the same values at the same
shapes, at channel counts that are no multiple of 8 and at views off the
16-byte alignment, also inside a captured CUDA graph; and one captured
siameseunet and whatevernet step at full width launches every BatchNorm
kernel in channels-last, makes no layout copy and leaves no cuDNN layout
transpose in its replay's profiler trace. Here, without a card, those skip
inside the test.
"""

import pytest
import torch

from multimodal_siamese_cd_tpu_torch.models.batchnorm import BatchNorm2d
from multimodal_siamese_cd_tpu_torch.ops import _build, batch_norm, bn_stats

torch.set_num_threads(1)

# every BatchNorm input of a full-width U-Net step at 256² crops: the
# stem and Up1, Down1-4, Up4..Up2
LEVELS = [(64, 256, 256), (128, 128, 128), (256, 64, 64), (512, 32, 32),
          (512, 16, 16), (256, 32, 32), (128, 64, 64), (64, 128, 128)]
# odd planes, one channel, planes a multiple of 4 but not of 8, one pixel
RAGGED = [(1, 3, 17, 19), (2, 1, 6, 6), (2, 3, 10, 10), (3, 5, 7, 9), (1, 3, 1, 1),
          (2, 2, 3, 4)]


def _per_channel(v):
    return v[None, :, None, None]


class _FormerTrainBatchNorm(torch.autograd.Function):
    """``models.batchnorm._TrainBatchNorm`` as it was before the kernels
    (one process, no reduction over ranks): the literal yardstick."""

    @staticmethod
    def forward(ctx, x, weight, bias, running_mean, running_var, momentum, eps):
        x = x.contiguous()
        n = x.numel() // x.shape[1]
        s1, s2 = bn_stats.bn_stats(x, x)
        mean = s1 / n
        var = torch.clamp_min(s2 / n - mean * mean, 0.0)
        rstd = torch.rsqrt(var + eps)
        y = x.to(torch.float32, copy=True)
        y.sub_(_per_channel(mean)).mul_(_per_channel(rstd * weight))
        y.add_(_per_channel(bias))
        with torch.no_grad():
            running_mean.mul_(1.0 - momentum).add_(mean, alpha=momentum)
            running_var.mul_(1.0 - momentum).add_(var, alpha=momentum)
        ctx.save_for_backward(x, weight, mean, rstd)
        ctx.n = n
        return y.to(x.dtype)

    @staticmethod
    def backward(ctx, dy):
        x, weight, mean, rstd = ctx.saved_tensors
        n = ctx.n
        dy = dy.contiguous()
        s1, s2 = bn_stats.bn_stats(dy, x)
        dbias = s1
        dweight = rstd * (s2 - mean * s1)
        t = x.to(torch.float32, copy=True)
        t.sub_(_per_channel(mean)).mul_(_per_channel(rstd * dweight / n))
        dx = dy.to(torch.float32, copy=True)
        dx.sub_(_per_channel(s1 / n)).sub_(t).mul_(_per_channel(weight * rstd))
        return dx.to(dy.dtype), dweight, dbias, None, None, None, None


class _FormerBatchNorm2d(BatchNorm2d):
    def forward(self, x):
        self.num_batches_tracked.add_(1)
        return _FormerTrainBatchNorm.apply(x, self.weight, self.bias, self.running_mean,
                                           self.running_var, self.momentum, self.eps)


def _run(module_cls, x, g, seed, device):
    """One train-mode call and its backward on ``x`` with output gradient
    ``g``: the output, the input, weight and bias gradients and the running
    statistics."""
    gen = torch.Generator().manual_seed(seed)
    bn = module_cls(x.shape[1]).to(device)
    with torch.no_grad():
        for p in (bn.weight, bn.bias, bn.running_mean):
            p.copy_(torch.rand(p.shape, generator=gen) - 0.5)
        bn.weight.add_(1.0)
        bn.running_var.copy_(torch.rand(x.shape[1], generator=gen) + 0.5)
    xd = x.to(device, copy=True).requires_grad_()
    y = bn(xd)
    (y * g.to(device)).sum().backward()
    return [y.detach(), xd.grad, bn.weight.grad, bn.bias.grad, bn.running_mean,
            bn.running_var]


def _activation(shape, dtype, seed, device="cpu"):
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(shape, generator=gen) * 1.7 + 0.3
    g = torch.randn(shape, generator=gen)
    return x.to(device, dtype), g.to(device, dtype)


def _vectors(channels, count, seed, device="cpu"):
    gen = torch.Generator().manual_seed(seed)
    return [(torch.randn(channels, generator=gen) * 0.7).to(device)
            for _ in range(count)]


@pytest.mark.parametrize("shape", [(2, 4, 8, 8), (1, 3, 5, 7), (3, 5, 7, 9),
                                   (2, 1, 6, 6), (4, 16, 16, 16)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_module_equals_the_former_float32_composition(shape, dtype):
    """On the CPU the module through the wrappers' plain versions gives the
    former module's output, gradients and running statistics bit for bit,
    and launches nothing."""
    x, g = _activation(shape, dtype, seed=sum(shape))
    before = batch_norm.batch_norm_apply.launches, batch_norm.batch_norm_dx.launches
    got = _run(BatchNorm2d, x, g, 7, "cpu")
    want = _run(_FormerBatchNorm2d, x, g, 7, "cpu")
    assert (batch_norm.batch_norm_apply.launches,
            batch_norm.batch_norm_dx.launches) == before
    assert got[0].dtype == dtype and got[1].dtype == dtype
    for name, a, b in zip(("y", "dx", "dweight", "dbias", "running_mean",
                           "running_var"), got, want):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cpu_wrappers_take_the_plain_versions_without_a_launch(dtype):
    x, dy = _activation((2, 3, 5, 6), dtype, seed=3)
    mean, scale, bias, a, b = _vectors(3, 5, seed=4)
    before = batch_norm.batch_norm_apply.launches, batch_norm.batch_norm_dx.launches
    y = batch_norm.batch_norm_apply(x, mean, scale, bias)
    dx = batch_norm.batch_norm_dx(dy, x, mean, a, b, scale)
    assert (batch_norm.batch_norm_apply.launches,
            batch_norm.batch_norm_dx.launches) == before
    assert y.dtype == dtype and dx.dtype == dtype
    assert torch.equal(y, batch_norm.batch_norm_apply_reference(x, mean, scale, bias))
    assert torch.equal(dx, batch_norm.batch_norm_dx_reference(dy, x, mean, a, b, scale))
    # the formulas, in float64 on the float32 values, to float32 round-off
    xf, dyf = x.double(), dy.double()
    m, s, o, av, bv = (_per_channel(v.double()) for v in (mean, scale, bias, a, b))
    tol = dict(atol=1e-5, rtol=1e-5) if dtype == torch.float32 else \
        dict(atol=1e-2, rtol=1e-2)
    torch.testing.assert_close(y.double(), (xf - m) * s + o, **tol)
    torch.testing.assert_close(dx.double(), ((dyf - bv) - (xf - m) * av) * s, **tol)


def _bad_calls():
    x, dy = _activation((2, 3, 4, 5), torch.float32, seed=0)
    v = _vectors(3, 5, seed=1)
    strided = torch.zeros(6)[::2]
    meta = torch.empty((2, 3, 4, 5), device="meta")
    return [
        ("mixed dtypes", lambda: batch_norm.batch_norm_dx(dy.bfloat16(), x, *v[:4]),
         "shape and dtype"),
        ("float16", lambda: batch_norm.batch_norm_apply(x.half(), *v[:3]),
         "bfloat16 or float32"),
        ("float64", lambda: batch_norm.batch_norm_dx(dy.double(), x.double(), *v[:4]),
         "bfloat16 or float32"),
        ("non-contiguous x", lambda: batch_norm.batch_norm_apply(
            x.transpose(2, 3), *v[:3]), "contiguous"),
        ("non-contiguous dy", lambda: batch_norm.batch_norm_dx(
            dy.transpose(0, 1).contiguous().transpose(0, 1), x, *v[:4]), "contiguous"),
        ("non-contiguous vector", lambda: batch_norm.batch_norm_apply(
            x, strided, *v[:2]), "contiguous"),
        ("vector dtype", lambda: batch_norm.batch_norm_apply(
            x, v[0].double(), *v[1:3]), "float32 vector"),
        ("vector length", lambda: batch_norm.batch_norm_dx(
            dy, x, v[0][:2], *v[1:4]), "float32 vector"),
        ("shape", lambda: batch_norm.batch_norm_dx(dy[:1], x, *v[:4]),
         "shape and dtype"),
        ("three dims", lambda: batch_norm.batch_norm_apply(x[0], *v[:3]),
         r"\(B, C, H, W\)"),
        ("another device", lambda: batch_norm.batch_norm_apply(
            x, v[0].to("meta"), *v[1:3]), "is on meta"),
        ("meta device", lambda: batch_norm.batch_norm_apply(
            meta, *(t.to("meta") for t in v[:3])), "no batch_norm kernel"),
    ]


@pytest.mark.parametrize("case", range(len(_bad_calls())),
                         ids=[c[0] for c in _bad_calls()])
def test_wrappers_reject_what_the_kernels_do_not_take(case):
    _, call, match = _bad_calls()[case]
    with pytest.raises(ValueError, match=match):
        call()


@pytest.mark.parametrize("batch", [8, 16])
@pytest.mark.parametrize("shape", LEVELS + [s[1:] for s in RAGGED])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plan_covers_every_plane_once(batch, shape, dtype):
    """The host's part of a launch's plan: vectors of 16 bytes where they
    divide the plane, one element at a time where not, so the C entry's
    chunks of whole vectors cover every plane (on the card
    :func:`test_cuda_kernels_write_every_element`); one pointer 2 bytes off
    16 turns the vectors off."""
    c, h, w = shape
    plane = h * w
    vector = 8 if dtype == torch.bfloat16 else 4
    width = batch_norm.vector_width((batch, c, h, w), dtype, [0, 512, 4096])
    assert width == (vector if plane % vector == 0 else 1)
    assert plane % width == 0
    assert batch_norm.vector_width((batch, c, h, w), dtype, [0, 514]) == 1


# --- on the card ---------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the batch_norm kernels run only there")
    return torch.device("cuda")


def _kernel_cases(shape, dtype, seed, dev):
    x, dy = _activation(shape, dtype, seed, dev)
    mean, scale, bias, a, b = _vectors(shape[1], 5, seed + 1, dev)
    return x, dy, mean, scale, bias, a, b


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(b, *s) for b in (8, 16) for s in LEVELS] + RAGGED)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cuda_kernels_are_bit_equal_to_the_plain_versions(shape, dtype):
    dev = _card()
    x, dy, mean, scale, bias, a, b = _kernel_cases(shape, dtype, sum(shape), dev)
    before = batch_norm.batch_norm_apply.launches, batch_norm.batch_norm_dx.launches
    y = batch_norm.batch_norm_apply(x, mean, scale, bias)
    dx = batch_norm.batch_norm_dx(dy, x, mean, a, b, scale)
    assert (batch_norm.batch_norm_apply.launches,
            batch_norm.batch_norm_dx.launches) == (before[0] + 1, before[1] + 1)
    assert torch.equal(y, batch_norm.batch_norm_apply_reference(x, mean, scale, bias))
    assert torch.equal(dx, batch_norm.batch_norm_dx_reference(dy, x, mean, a, b, scale))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(8, 64, 256, 256), (16, 512, 16, 16)] + RAGGED)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cuda_kernels_write_every_element(shape, dtype):
    """Outputs filled with NaN before the launch hold the plain versions'
    bits after it: the C entry's grid covers every plane. A vector width
    that does not divide the plane is refused, nothing launched."""
    dev = _card()
    x, dy, mean, scale, bias, a, b = _kernel_cases(shape, dtype, 31, dev)
    y = torch.full_like(x, float("nan"))
    dx = torch.full_like(x, float("nan"))
    batch_norm.launch_apply(x, mean, scale, bias, y)
    batch_norm.launch_dx(dy, x, mean, a, b, scale, dx)
    assert torch.equal(y, batch_norm.batch_norm_apply_reference(x, mean, scale, bias))
    assert torch.equal(dx, batch_norm.batch_norm_dx_reference(dy, x, mean, a, b, scale))
    plane = shape[2] * shape[3]
    vector = 16 // x.element_size()
    if plane % vector:
        y.fill_(float("nan"))
        with pytest.raises(RuntimeError, match="mscd_batch_norm_apply kernel launch "
                                               "failed: cudaError"):
            _build.launch("batch_norm", "mscd_batch_norm_apply",
                          batch_norm.APPLY_ARGTYPES, x.device,
                          *(t.data_ptr() for t in (x, mean, scale, bias, y)),
                          1 if dtype == torch.bfloat16 else 0, shape[0] * shape[1],
                          shape[1], plane, vector)
        torch.cuda.synchronize()
        assert torch.isnan(y).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cuda_kernels_take_views_off_the_vector_alignment(dtype):
    """Contiguous views one element into a buffer: the scalar path, still
    bit-equal."""
    dev = _card()
    shape = (2, 3, 16, 16)
    n = 2 * 3 * 16 * 16
    x, dy, mean, scale, bias, a, b = _kernel_cases(shape, dtype, 11, dev)
    xs, dys = (torch.empty(n + 1, dtype=dtype, device=dev) for _ in range(2))
    xs[1:].copy_(x.flatten())
    dys[1:].copy_(dy.flatten())
    xv, dyv = xs[1:].view(shape), dys[1:].view(shape)
    assert batch_norm.vector_width(shape, dtype, [xv.data_ptr()]) == 1
    assert torch.equal(batch_norm.batch_norm_apply(xv, mean, scale, bias),
                       batch_norm.batch_norm_apply_reference(x, mean, scale, bias))
    assert torch.equal(batch_norm.batch_norm_dx(dyv, xv, mean, a, b, scale),
                       batch_norm.batch_norm_dx_reference(dy, x, mean, a, b, scale))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cuda_kernels_are_bit_equal_inside_a_cuda_graph(dtype):
    """Both kernels captured in one CUDA graph and replayed on new inputs
    copied into the static ones give the plain versions' bits."""
    dev = _card()
    shape = (8, 64, 64, 64)
    static = _kernel_cases(shape, dtype, 21, dev)
    x, dy, mean, scale, bias, a, b = static
    batch_norm.batch_norm_apply(x, mean, scale, bias)        # the first calls,
    batch_norm.batch_norm_dx(dy, x, mean, a, b, scale)       # outside the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        y = batch_norm.batch_norm_apply(x, mean, scale, bias)
        dx = batch_norm.batch_norm_dx(dy, x, mean, a, b, scale)
    for seed in (22, 23):
        for dst, src in zip(static, _kernel_cases(shape, dtype, seed, dev)):
            dst.copy_(src)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(y, batch_norm.batch_norm_apply_reference(x, mean, scale, bias))
        assert torch.equal(dx, batch_norm.batch_norm_dx_reference(dy, x, mean, a, b,
                                                                  scale))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(8, 64, 64, 64), (16, 512, 16, 16), (3, 5, 7, 9)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cuda_module_is_bit_equal_to_the_former_module(shape, dtype):
    """On the card the module's output, gradients and running statistics
    equal the former float32 composition's bit for bit, one launch of each
    kernel forward and backward."""
    dev = _card()
    x, g = _activation(shape, dtype, sum(shape), dev)
    before = batch_norm.batch_norm_apply.launches, batch_norm.batch_norm_dx.launches
    got = _run(BatchNorm2d, x, g, 9, dev)
    assert (batch_norm.batch_norm_apply.launches,
            batch_norm.batch_norm_dx.launches) == (before[0] + 1, before[1] + 1)
    want = _run(_FormerBatchNorm2d, x, g, 9, dev)
    for name, a, b in zip(("y", "dx", "dweight", "dbias", "running_mean",
                           "running_var"), got, want):
        assert torch.equal(a, b), name


@pytest.mark.cuda
def test_cuda_siameseunet_step_launches_the_kernels_at_every_batchnorm():
    """One supervised siameseunet step (four levels, bf16 autocast): 28
    BatchNorm calls, so 56 bn_stats launches and 28 of each elementwise
    kernel."""
    dev = _card()
    from multimodal_siamese_cd_tpu_torch import train_lib
    from multimodal_siamese_cd_tpu_torch.config import load_cfg
    from multimodal_siamese_cd_tpu_torch.models.factory import create_network

    cfg = load_cfg("siamese")
    cfg.MODEL.TYPE = "siameseunet"
    cfg.MODEL.TOPOLOGY = [8, 16, 32, 64]
    model = create_network(cfg, device=dev, generator=torch.Generator().manual_seed(1))
    bns = [m for m in model.modules() if isinstance(m, BatchNorm2d)]
    step = train_lib.make_train_step(model, train_lib.make_optimizer(model, cfg), cfg,
                                     "supervised")
    stack = torch.rand((2, 15, 64, 64), generator=torch.Generator().manual_seed(2))
    stack[:, 12:] = (stack[:, 12:] > 0.7).float()
    stack, labs = stack.to(dev), torch.ones(2, device=dev)
    counts = lambda: (bn_stats.bn_stats.launches,  # noqa: E731
                      batch_norm.batch_norm_apply.launches,
                      batch_norm.batch_norm_dx.launches)
    before = counts()
    loss = step(stack, labs, 0)["loss"]
    torch.cuda.synchronize()
    after = counts()
    assert torch.isfinite(torch.as_tensor(loss)).all()
    assert len(bns) == 18      # 5 encoder and 4 decoder DoubleConvs, 2 each
    assert tuple(a - b for a, b in zip(after, before)) == (56, 28, 28)


# --- channels-last on the card -------------------------------------------------

CL = torch.channels_last
# channel counts that are no multiple of 8: the scalar path
NHWC_RAGGED = [(2, 12, 9, 7), (2, 20, 8, 8), (3, 5, 7, 9), (2, 3, 10, 10), (1, 3, 17, 19)]


def _nhwc_counts():
    return (batch_norm.batch_norm_apply.launches_nhwc,
            batch_norm.batch_norm_dx.launches_nhwc)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(b, *s) for b in (8, 16) for s in LEVELS] + NHWC_RAGGED)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cuda_nhwc_kernels_are_bit_equal_to_the_nchw_kernels(shape, dtype):
    """The channels-last kernels on the channels-last copy of the values
    give the NCHW kernels' bits, in channels-last, one channels-last launch
    each; outputs filled with NaN before a launch are written whole."""
    dev = _card()
    x, dy, mean, scale, bias, a, b = _kernel_cases(shape, dtype, sum(shape) + 1, dev)
    xc, dyc = x.contiguous(memory_format=CL), dy.contiguous(memory_format=CL)
    before = _nhwc_counts()
    y = batch_norm.batch_norm_apply(xc, mean, scale, bias)
    dx = batch_norm.batch_norm_dx(dyc, xc, mean, a, b, scale)
    assert _nhwc_counts() == (before[0] + 1, before[1] + 1)
    assert y.is_contiguous(memory_format=CL) and dx.is_contiguous(memory_format=CL)
    want_y = batch_norm.batch_norm_apply(x, mean, scale, bias)
    want_dx = batch_norm.batch_norm_dx(dy, x, mean, a, b, scale)
    assert torch.equal(y, want_y) and torch.equal(dx, want_dx)
    assert torch.equal(y, batch_norm.batch_norm_apply_reference(xc, mean, scale, bias))
    y.fill_(float("nan"))
    dx.fill_(float("nan"))
    batch_norm.launch_apply(xc, mean, scale, bias, y)
    batch_norm.launch_dx(dyc, xc, mean, a, b, scale, dx)
    assert torch.equal(y, want_y) and torch.equal(dx, want_dx)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cuda_nhwc_kernels_take_views_off_the_vector_alignment(dtype):
    """Channels-last views one element into a buffer: the scalar path,
    still bit-equal to the NCHW kernels."""
    dev = _card()
    shape = (2, 16, 8, 8)
    x, dy, mean, scale, bias, a, b = _kernel_cases(shape, dtype, 13, dev)
    views = []
    for t in (x, dy):
        buf = torch.empty(t.numel() + 1, dtype=dtype, device=dev)
        nhwc = buf[1:].view(shape[0], shape[2], shape[3], shape[1])
        nhwc.copy_(t.permute(0, 2, 3, 1))
        views.append(nhwc.permute(0, 3, 1, 2))
    xv, dyv = views
    assert xv.is_contiguous(memory_format=CL) and xv.data_ptr() % 16
    assert torch.equal(batch_norm.batch_norm_apply(xv, mean, scale, bias),
                       batch_norm.batch_norm_apply(x, mean, scale, bias))
    assert torch.equal(batch_norm.batch_norm_dx(dyv, xv, mean, a, b, scale),
                       batch_norm.batch_norm_dx(dy, x, mean, a, b, scale))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cuda_nhwc_kernels_are_bit_equal_inside_a_cuda_graph(dtype):
    """The channels-last kernels captured in one CUDA graph and replayed on
    new inputs copied into the static ones give the NCHW kernels' bits, and
    ``bn_stats``'s replays (its last block's counters put back each time)
    the bits of its launches outside the graph."""
    dev = _card()
    shape = (8, 64, 64, 64)
    static = list(_kernel_cases(shape, dtype, 25, dev))
    static[:2] = [t.contiguous(memory_format=CL) for t in static[:2]]
    x, dy, mean, scale, bias, a, b = static
    batch_norm.batch_norm_apply(x, mean, scale, bias)
    batch_norm.batch_norm_dx(dy, x, mean, a, b, scale)
    bn_stats.bn_stats(x, x)
    bn_stats.bn_stats(dy, x)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        y = batch_norm.batch_norm_apply(x, mean, scale, bias)
        dx = batch_norm.batch_norm_dx(dy, x, mean, a, b, scale)
        stats = bn_stats.bn_stats(x, x) + bn_stats.bn_stats(dy, x)
    for seed in (26, 27):
        fresh = _kernel_cases(shape, dtype, seed, dev)
        for dst, src in zip(static, fresh):
            dst.copy_(src)
        graph.replay()
        torch.cuda.synchronize()
        fx, fdy, *vectors = fresh
        fmean, fscale, fbias, fa, fb = vectors
        assert torch.equal(y, batch_norm.batch_norm_apply(fx, fmean, fscale, fbias))
        assert torch.equal(dx, batch_norm.batch_norm_dx(fdy, fx, fmean, fa, fb, fscale))
        fxc, fdyc = (t.contiguous(memory_format=CL) for t in (fx, fdy))
        want = bn_stats.bn_stats(fxc, fxc) + bn_stats.bn_stats(fdyc, fxc)
        assert all(torch.equal(g, w) for g, w in zip(stats, want))


@pytest.mark.cuda
@pytest.mark.parametrize("model_type, config, regime, per_step", [
    ("siameseunet", "siamese", "supervised", (56, 28, 28)),
    ("whatevernet", "siamese_mmcr_alpha0500", "semisupervised", (112, 56, 56)),
])
def test_cuda_captured_step_runs_channels_last_without_transposes(model_type, config,
                                                                  regime, per_step):
    """One step of the full-width model (topology [64, 128, 256, 512],
    batch 2, 64 px crops, bf16) through ``make_scanned_train_step`` on the
    card: the first call's eager step and capture launch every
    ``bn_stats``, ``batch_norm_apply`` and ``batch_norm_dx`` call through
    its channels-last kernel (2 x ``per_step``) and make no layout copy; the
    replayed step's profiler trace holds the channels-last kernels and no
    cuDNN ``nchwToNhwc`` / ``nhwcToNchw`` transpose."""
    dev = _card()
    from multimodal_siamese_cd_tpu_torch import profile_step, train_lib
    from multimodal_siamese_cd_tpu_torch.config import load_cfg
    from multimodal_siamese_cd_tpu_torch.models.factory import create_network

    cfg = load_cfg(config)
    cfg.MODEL.TYPE = model_type
    assert list(cfg.MODEL.TOPOLOGY) == [64, 128, 256, 512]
    model = create_network(cfg, device=dev, generator=torch.Generator().manual_seed(1))
    window = train_lib.make_scanned_train_step(model, train_lib.make_optimizer(model, cfg),
                                               cfg, regime)
    assert window.mode == "graph"
    stacks = torch.rand((2, 1, 2, 15, 64, 64), generator=torch.Generator().manual_seed(2))
    stacks[..., 12:, :, :] = (stacks[..., 12:, :, :] > 0.7).float()
    stacks, labs = stacks.to(dev), torch.tensor([[[1.0, 0.0]]] * 2, device=dev)
    counts = lambda: (bn_stats.bn_stats.launches_nhwc,  # noqa: E731
                      *_nhwc_counts(), bn_stats.bn_stats.launches,
                      batch_norm.batch_norm_apply.launches,
                      batch_norm.batch_norm_dx.launches)
    before, copies = counts(), BatchNorm2d.layout_copies
    window(stacks[0], labs[0], 0)
    torch.cuda.synchronize()
    made = tuple(a - b for a, b in zip(counts(), before))
    assert made == tuple(2 * n for n in per_step) * 2
    assert BatchNorm2d.layout_copies == copies
    kernels = profile_step.trace(lambda: window(stacks[1], labs[1], 1), dev)["kernels"]
    names = [n.lower() for n in kernels]
    assert any("bn_stats_partial_nhwc" in n for n in names)
    assert any("batch_norm_dx_nhwc" in n for n in names)
    transposes = [n for n in names if "nchwtonhwc" in n or "nhwctonchw" in n]
    assert not transposes, transposes
