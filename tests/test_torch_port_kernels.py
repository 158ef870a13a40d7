"""The kernel wrappers and kernels (confusion counts with both rules,
bn_stats, conv3x3), with no JAX in the process.

This file imports only the port, torch and numpy, so it also runs on the
machine with the card, where JAX is not used:

    python -m pytest --noconftest -q tests/test_torch_port_kernels.py

There the ``cuda``-marked tests hold each CUDA kernel against its plain
version (confusion: exact integer equality; bn_stats: within 1e-5 of
Σ|a·b| per channel; conv3x3: atol 1e-4 on float32 inputs, one bf16 ulp
plus 1e-4 on bf16 inputs; each bit-equal from launch to launch); here,
without a card, they skip inside the test. The other tests check the wrappers'
contracts on the CPU.
"""

import numpy as np
import pytest
import torch

from multimodal_siamese_cd_tpu_torch.models.batchnorm import BatchNorm2d
from multimodal_siamese_cd_tpu_torch.ops import bn_stats, confusion, conv3x3

torch.set_num_threads(1)


def _inputs(seed, n_scenes, n, thresholds):
    """Probabilities with exact ties at every threshold and their +-1 ulp
    neighbours, labels, and a valid mask with holes and a masked tail."""
    rng = np.random.default_rng(seed)
    probs = rng.uniform(0, 1, (n_scenes, n)).astype(np.float32)
    for thr in np.asarray(thresholds, np.float32):
        for val in (thr, np.nextafter(thr, np.float32(2)),
                    np.nextafter(thr, np.float32(-1))):
            idx = rng.integers(0, n, size=(n_scenes, max(1, n // 50)))
            np.put_along_axis(probs, idx, val, axis=1)
    y = (rng.uniform(size=(n_scenes, n)) > 0.7).astype(np.uint8)
    valid = (rng.uniform(size=(n_scenes, n)) > 0.1).astype(np.uint8)
    valid[:, int(n * 0.85):] = 0
    return probs, y, valid, np.asarray(thresholds, np.float32)


def _torch(*arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


def test_ties_round_half_to_even():
    """p == thr gives round(0.5) == 0 (no prediction); one ulp above
    predicts; one ulp below does not."""
    thr = np.float32(0.5)
    probs = np.array([[thr, np.nextafter(thr, np.float32(1)),
                       np.nextafter(thr, np.float32(0)), 1.0, 0.0]], np.float32)
    y = np.array([[1, 1, 1, 0, 0]], np.uint8)
    valid = np.ones_like(y)
    got = confusion.confusion_counts(*_torch(probs, y, valid, np.array([thr])))
    tp, tn, fp, fn = got[0, :, 0].tolist()
    assert (tp, tn, fp, fn) == (1, 1, 1, 2)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    probs, y, valid, thr = _torch(*_inputs(0, 2, 64, [0.5]))
    with pytest.raises(ValueError, match="uint8"):
        confusion.confusion_counts(probs, y.float(), valid, thr)
    with pytest.raises(ValueError, match="probs"):
        confusion.confusion_counts(probs.double(), y, valid, thr)
    with pytest.raises(ValueError, match="thresholds"):
        confusion.confusion_counts(probs, y, valid, thr[:0])
    with pytest.raises(ValueError, match="uint8"):
        confusion.confusion_counts(probs, y[:1], valid, thr)


def test_cpu_tensors_take_the_plain_version_without_a_launch():
    args = _torch(*_inputs(1, 3, 333, [0.2, 0.6]))
    before = confusion.confusion_counts.launches
    got = confusion.confusion_counts(*args)
    assert confusion.confusion_counts.launches == before
    assert torch.equal(got, confusion.confusion_counts_plain(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1_000_003, 1_024_000])
def test_cuda_kernel_matches_plain(n):
    """Needs the card (the kernel has no CPU mode): scalar path for ragged
    N, vector path for N % 4 == 0; T = 1, 5 and 11 (two chunks)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the confusion kernel runs only there")
    for thresholds in ([0.5], np.linspace(0.1, 0.9, 5), np.linspace(0.05, 0.95, 11)):
        args = tuple(t.cuda() for t in _torch(*_inputs(n, 3, n, thresholds)))
        before = confusion.confusion_counts.launches
        got = confusion.confusion_counts(*args)
        assert confusion.confusion_counts.launches == before + 1
        assert torch.equal(got, confusion.confusion_counts_plain(*args))


def test_failed_build_raises(tmp_path, monkeypatch):
    """A compiler failure is an error with the compiler's output, and leaves
    no library behind to load later."""
    from multimodal_siamese_cd_tpu_torch.ops import _build

    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'error: no sm_90a here' >&2\nexit 3\n")
    fake.chmod(0o755)
    monkeypatch.setattr(_build, "nvcc_path", lambda: str(fake))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "torch_ext")
    monkeypatch.setattr(_build, "_loaded", {})
    with pytest.raises(RuntimeError, match="no sm_90a here"):
        _build.load_library("confusion")
    assert not list((tmp_path / "torch_ext").glob("*.so*"))


def _bn_inputs(shape, dtype, seed=0):
    gen = torch.Generator().manual_seed(seed)
    a = torch.randn(shape, generator=gen).to(dtype)
    b = (torch.randn(shape, generator=gen) + 0.5).to(dtype)
    return a, b


def test_bn_stats_wrapper_rejects_what_the_kernel_does_not_take():
    a, b = _bn_inputs((2, 3, 4, 5), torch.float32)
    with pytest.raises(ValueError, match="bfloat16 or both float32"):
        bn_stats.bn_stats(a, b.double())
    with pytest.raises(ValueError, match="bfloat16 or both float32"):
        bn_stats.bn_stats(a.half(), b.half())
    with pytest.raises(ValueError, match="shape"):
        bn_stats.bn_stats(a, b[:1])
    with pytest.raises(ValueError, match="shape"):
        bn_stats.bn_stats(a[0], b[0])
    with pytest.raises(ValueError, match="contiguous"):
        bn_stats.bn_stats(a.transpose(2, 3), b.transpose(2, 3))


def test_bn_stats_cpu_tensors_take_the_plain_version_without_a_launch():
    a, b = _bn_inputs((2, 3, 5, 7), torch.bfloat16)
    before = bn_stats.bn_stats.launches
    got = bn_stats.bn_stats(a, b)
    assert bn_stats.bn_stats.launches == before
    want = bn_stats.bn_stats_reference(a, b)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == (3,)
        assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(8, 64, 256, 256), (8, 512, 16, 16),
                                   (1, 3, 17, 19), (2, 3, 10, 10)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cuda_bn_stats_matches_plain_and_is_deterministic(shape, dtype):
    """Needs the card: vector and scalar paths (H·W a multiple of 8, of 4
    only, odd), a is b and not; |kernel - float64 plain| <= 1e-5 · Σ|a·b|
    per channel; two launches give the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the bn_stats kernel runs only there")
    a, b = (t.cuda() for t in _bn_inputs(shape, dtype, seed=sum(shape)))
    for bb in (a, b):
        before = bn_stats.bn_stats.launches
        got = bn_stats.bn_stats(a, bb)
        assert bn_stats.bn_stats.launches == before + 1
        again = bn_stats.bn_stats(a, bb)
        ref = bn_stats.bn_stats_reference(a, bb, torch.float64)
        limits = (1e-5 * a.double().abs().sum(dim=(0, 2, 3)),
                  1e-5 * (a.double() * bb.double()).abs().sum(dim=(0, 2, 3)))
        for g, h, r, lim in zip(got, again, ref, limits):
            assert torch.equal(g, h)
            assert bool(((g.double() - r).abs() <= lim).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_train_batchnorm_launches_the_kernel_forward_and_backward(dtype):
    """Needs the card: one train-mode BN launches bn_stats once forward and
    once backward, and agrees with the same module on the CPU (plain sums)
    run in float32 on the same inputs. For bf16 the card takes the bf16
    tensors, as under autocast, and the CPU their float32 upcast: the
    output and the input gradient, rounded to bf16 on the card, agree to
    1e-2 (bf16 keeps 8 significant bits); the parameter gradients and
    running statistics, float32 on both, to 1e-4."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the bn_stats kernel runs only there")
    x, g = _bn_inputs((4, 16, 32, 32), dtype, seed=5)
    results = []
    for dev, dt in (("cpu", torch.float32), ("cuda", dtype)):
        bn = BatchNorm2d(16).to(dev)
        xd = x.to(dev, dt, copy=True).requires_grad_()
        before = bn_stats.bn_stats.launches
        y = bn(xd)
        assert y.dtype == dt
        (y * g.to(dev, dt)).sum().backward()
        if dev == "cuda":
            assert bn_stats.bn_stats.launches == before + 2
        results.append([t.detach().float().cpu() for t in
                        (y, xd.grad, bn.weight.grad, bn.bias.grad,
                         bn.running_mean, bn.running_var)])
    lowp = 1e-2 if dtype == torch.bfloat16 else 1e-4
    for i, (cpu, card) in enumerate(zip(*results)):
        tol = lowp if i < 2 else 1e-4
        torch.testing.assert_close(card, cpu, atol=tol, rtol=tol)


# --- the strict rule -----------------------------------------------------------

def test_strict_rule_at_ties_and_one_ulp_away():
    """Neither rule predicts at p == thr; both predict one ulp above 0.5;
    one ulp above 0.3 only the strict rule predicts (the rounding rule's
    ``+ 0.5`` absorbs the difference)."""
    for thr, differ in ((np.float32(0.5), 0), (np.float32(0.3), 1)):
        probs = np.array([[thr, np.nextafter(thr, np.float32(1)),
                           np.nextafter(thr, np.float32(0))]], np.float32)
        y = np.array([[1, 1, 0]], np.uint8)
        args = _torch(probs, y, np.ones_like(y), np.array([thr]))
        strict = confusion.strict_confusion_counts(*args)[0, :, 0].tolist()
        rounded = confusion.confusion_counts(*args)[0, :, 0].tolist()
        assert strict == [1, 1, 0, 1]           # tp, tn, fp, fn
        assert rounded == [1 - differ, 1, 0, 1 + differ]


def test_strict_cpu_tensors_take_the_plain_version_without_a_launch():
    args = _torch(*_inputs(2, 3, 333, [0.3, 0.5]))
    before = confusion.strict_confusion_counts.launches
    got = confusion.strict_confusion_counts(*args)
    assert confusion.strict_confusion_counts.launches == before
    assert torch.equal(got, confusion.strict_confusion_counts_plain(*args))
    assert int(got[:, :, 0].sum()) == int(args[2].sum())   # every valid pixel once


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1_000_003, 1_024_000])
def test_cuda_strict_kernel_matches_plain(n):
    """Needs the card: the strict variant equals its plain version, ties and
    +-1 ulp neighbours of every threshold included, on both paths; two
    launches give the same counts."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the confusion kernel runs only there")
    for thresholds in ([0.5], [0.3], np.linspace(0.05, 0.95, 11)):
        args = tuple(t.cuda() for t in _torch(*_inputs(n + 1, 3, n, thresholds)))
        before = confusion.strict_confusion_counts.launches
        got = confusion.strict_confusion_counts(*args)
        assert confusion.strict_confusion_counts.launches == before + 1
        assert torch.equal(got, confusion.strict_confusion_counts_plain(*args))
        assert torch.equal(got, confusion.strict_confusion_counts(*args))


# --- conv3x3 --------------------------------------------------------------------

def _conv_inputs(b, h, w, cin, cout, dtype, seed=0):
    """Images in [0, 1) and He-scaled weights, so outputs are of order 1."""
    gen = torch.Generator().manual_seed(seed)
    x = torch.rand((b, h, w, cin), generator=gen).to(dtype)
    wt = torch.randn((3, 3, cin, cout), generator=gen) * (2.0 / (9 * cin)) ** 0.5
    return x, wt.to(dtype)


def bf16_ulp(t: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp at each value of ``t`` (8 significant bits)."""
    e = torch.floor(torch.log2(t.float().abs().clamp_min(2.0 ** -126)))
    return torch.exp2(e - 7)


def test_conv3x3_wrapper_rejects_what_it_does_not_take():
    x, w = _conv_inputs(1, 5, 6, 8, 16, torch.float32)
    with pytest.raises(ValueError, match="x must be"):
        conv3x3.conv3x3(x.double(), w)
    with pytest.raises(ValueError, match="x must be"):
        conv3x3.conv3x3(x[0], w)
    with pytest.raises(ValueError, match="w must be"):
        conv3x3.conv3x3(x, w[:, :, :4])
    with pytest.raises(ValueError, match="w must be"):
        conv3x3.conv3x3(x, w[:2])


def test_conv3x3_cpu_tensors_take_the_plain_version_without_a_launch():
    x, w = _conv_inputs(2, 7, 9, 6, 8, torch.bfloat16)
    before = conv3x3.conv3x3.launches
    got = conv3x3.conv3x3(x, w)
    assert conv3x3.conv3x3.launches == before
    assert got.shape == (2, 7, 9, 8) and got.dtype == torch.bfloat16
    assert torch.equal(got, conv3x3.conv3x3_plain(x, w))


# conv3x3 (B, H, W, Cin, Cout) shapes of chip_smoke.py's phase 3c: the JAX
# test's, the Pallas tool's, every U-Net level at batch 8 and 256^2 crops,
# and a ragged one
CONV_SHAPES = [(2, 32, 64, 128, 16), (8, 256, 256, 128, 64),
               (8, 256, 256, 64, 64), (8, 128, 128, 128, 128),
               (8, 64, 64, 256, 256), (8, 32, 32, 512, 512), (1, 37, 29, 64, 64)]
# ragged ones: W below every tile width, H of 1, chunks of Cin cut short,
# channel tiles of 8 and 16, 1 x 1 images
CONV_RAGGED = [(2, 16, 17, 8, 24), (3, 1, 1, 40, 8), (2, 9, 5, 64, 64),
               (3, 1, 37, 64, 32), (2, 20, 24, 40, 16), (2, 12, 40, 256, 256)]


@pytest.mark.parametrize("shape", CONV_SHAPES + CONV_RAGGED)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv3x3_plan_fits_the_card(shape, dtype):
    """The kernel's tiling, from plain Python: shared memory within a
    block's 227 KB, a channel tile the kernel is built for that divides
    Cout, at most one persistent block per SM and no more blocks than
    tiles, tiles of 128 or 256 pixels (whole 64-pixel blocks of whole tile
    rows; 256 only where those still fill every SM) covering the image, TMA
    boxes of at most 256 elements a side, rows of 16 to 128 bytes."""
    b, h, w, cin, cout = shape
    p = conv3x3.plan(b, h, w, cin, cout, dtype)
    assert p.smem_bytes <= 227 * 1024
    assert p.smem_bytes == conv3x3.smem_bytes(p.tile_w, p.block_n, p.m_blocks,
                                              p.out_bytes, p.a_stages, p.b_stages)
    assert p.block_n in (conv3x3.BLOCK_NS if p.m_blocks == 1 else conv3x3.TWO_BLOCK_NS)
    assert conv3x3.staging_bytes(p.block_n, p.m_blocks, p.out_bytes) \
        <= conv3x3.MAX_STAGING
    assert p.m_blocks == 1 or p.tiles >= 132 * conv3x3.BLOCKS_PER_SM
    assert (8 * -(-cout // 8)) % p.block_n == 0
    assert 2 <= p.a_stages <= conv3x3.MAX_A_STAGES
    assert 2 <= p.b_stages <= conv3x3.MAX_B_STAGES
    assert 1 <= p.grid <= min(p.tiles, 132 * conv3x3.BLOCKS_PER_SM)
    assert p.tile_w * p.tile_h == 128 * p.m_blocks and 64 % p.tile_w == 0
    assert p.tiles == b * -(-h // p.tile_h) * -(-w // p.tile_w) * (cout // p.block_n)
    for box in p.boxes.values():
        assert all(1 <= n <= 256 for n in box)
    for name, elem in (("x", 2), ("w", 2), ("y", p.out_bytes)):
        assert p.boxes[name][0] * elem in (16, 32, 64, 128)


def test_conv3x3_plan_rejects_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="multiples of 8"):
        conv3x3.plan(1, 8, 8, 6, 16, torch.bfloat16)
    with pytest.raises(ValueError, match="multiples of 8"):
        conv3x3.plan(1, 8, 8, 16, 12, torch.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv3x3_prepare_gives_the_kernels_operands(dtype):
    """bf16 x, one cast and no copy of a contiguous bf16 input, and K-major
    (3, 3, Cout, Cin) bf16 weights, from a non-contiguous view too."""
    x, w = _conv_inputs(2, 5, 7, 16, 24, dtype)
    xv = x.transpose(1, 2).contiguous().transpose(1, 2)     # NHWC view, strided
    xb, wk = conv3x3.prepare(xv, w)
    assert xb.dtype == wk.dtype == torch.bfloat16
    assert xb.is_contiguous() and wk.is_contiguous()
    assert torch.equal(xb, x.to(torch.bfloat16))
    assert torch.equal(wk, w.to(torch.bfloat16).permute(0, 1, 3, 2))
    if dtype == torch.bfloat16:
        assert conv3x3.prepare(x, w)[0].data_ptr() == x.data_ptr()


def test_header_edit_gives_a_new_library(tmp_path, monkeypatch):
    """A library's name hashes its source and every shared ``*.cuh``
    header, so an edited header is rebuilt, not loaded stale; needs no
    nvcc."""
    from multimodal_siamese_cd_tpu_torch.ops import _build

    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "k.cu").write_text('#include "ptx.cuh"\nextern "C" int f() { return 0; }\n')
    (csrc / "ptx.cuh").write_text("#pragma once\n")
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "torch_ext")
    first = _build.library_path("k")
    assert first.parent == tmp_path / "torch_ext" and first.name.startswith("k_")
    assert _build.library_path("k") == first
    (csrc / "ptx.cuh").write_text("#pragma once\n// edited\n")
    second = _build.library_path("k")
    assert second != first
    (csrc / "other.cuh").write_text("#pragma once\n")
    assert _build.library_path("k") not in (first, second)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 32, 64, 128, 16), (8, 32, 32, 512, 512),
                                   (1, 37, 29, 64, 64), (2, 16, 17, 8, 24),
                                   (3, 1, 1, 40, 8), (2, 9, 5, 64, 64),
                                   (3, 1, 37, 64, 32), (2, 20, 24, 40, 16),
                                   (2, 12, 40, 256, 256), (1, 64, 64, 128, 128),
                                   (4, 128, 128, 64, 64)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_conv3x3_matches_plain(shape, dtype):
    """Needs the card: against the plain version in float32 without TF32,
    atol 1e-4 for float32 inputs; for bf16 inputs at most one bf16 ulp of
    the plain value plus 1e-4, the float32 summation difference, which
    exceeds an ulp where the sum cancels to near zero; two launches
    bit-equal. Shapes: the JAX test's, the U-Net's deepest level, ragged
    tiles, Cout 24 (channel tiles of 8) and 16, Cin 8 and 40 (a chunk of 64
    cut short), a 1 x 1 image, W below every tile width, H of 1 with three
    images (no box may read across images), channel tiles of 256 and 128,
    and two 64-pixel blocks per warpgroup (enough tiles at 64 channels)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the conv3x3 kernel runs only there")
    x, w = (t.cuda() for t in _conv_inputs(*shape, dtype, seed=sum(shape)))
    before = conv3x3.conv3x3.launches
    got = conv3x3.conv3x3(x, w)
    assert conv3x3.conv3x3.launches == before + 1
    assert got.shape == (*shape[:3], shape[4]) and got.dtype == dtype
    assert torch.equal(got, conv3x3.conv3x3(x, w))
    _assert_conv_close(got, x, w, dtype)


def _assert_conv_close(got, x, w, dtype):
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        want = conv3x3.conv3x3_plain(x, w)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    err = (got.float() - want.float()).abs()
    if dtype == torch.float32:
        assert float(err.max()) <= 1e-4
    else:
        assert bool((err <= bf16_ulp(want) + 1e-4).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_conv3x3_takes_a_non_contiguous_view(dtype):
    """Needs the card: an NHWC view with permuted strides and one that
    starts mid-vector (not 16-byte aligned) give the plain version's
    result."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the conv3x3 kernel runs only there")
    x, w = (t.cuda() for t in _conv_inputs(2, 19, 23, 72, 32, dtype, seed=7))
    strided = x.permute(0, 2, 1, 3).contiguous().permute(0, 2, 1, 3)
    flat = torch.empty(x.numel() + 1, dtype=dtype, device=x.device)
    flat[1:] = x.reshape(-1)
    offset = flat[1:].view(x.shape)
    for view in (strided, offset):
        assert not view.is_contiguous() or view.data_ptr() % 16
        got = conv3x3.conv3x3(view, w)
        _assert_conv_close(got, x, w, dtype)


@pytest.mark.cuda
def test_cuda_conv3x3_rejects_channels_the_kernel_cannot_load():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    x, w = (t.cuda() for t in _conv_inputs(1, 8, 8, 6, 16, torch.float32))
    with pytest.raises(ValueError, match="multiples of 8"):
        conv3x3.conv3x3(x, w)


# --- two ranks on the card ------------------------------------------------------

@pytest.mark.cuda
def test_cuda_two_ranks_share_the_card_over_gloo(tmp_path):
    """Needs the card: a world of two processes over gloo on CUDA tensors,
    both on the one card, takes one bf16 sync-BN step of a small
    siameseunet at global batch 4: each rank launches bn_stats 32 times
    (16 BatchNorm calls, forward and backward), the ranks' gradients and
    parameters are bit-equal, and the step agrees with the one-process
    step on the same global batch: loss rel 1e-2, gradient rel 5e-2 in L2
    over all parameters (bf16 convolutions at batch 2 and 4 may round
    differently)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the world's kernels run only there")
    from multimodal_siamese_cd_tpu_torch.parallel import cluster_check

    rng = np.random.default_rng(0)
    stack = rng.uniform(0, 1, (4, 15, 32, 32)).astype(np.float32)
    stack[:, 12:] = stack[:, 12:] > 0.8
    case = dict(name="step", kind="step", config="siamese", regime="supervised",
                overrides=["MODEL.TOPOLOGY", "[8, 16]", "TRAINER.BATCH_SIZE", "4"],
                stack=torch.from_numpy(stack), is_labeled=torch.ones(4))
    rcs, outs = cluster_check.launch_cluster(
        {"device": "cuda", "backend": "gloo", "cases": [case]}, tmp_path,
        timeout=300)
    assert rcs == [0, 0], "\n".join(o + e[-4000:] for o, e in outs)
    ranks = [torch.load(tmp_path / f"step.rank{r}.pt", weights_only=False)
             for r in range(2)]
    one = cluster_check.run_case(case, "cuda")
    assert [r["launches"] for r in ranks] == [32, 32] and one["launches"] == 32
    for name, g in ranks[0]["grads"].items():
        assert torch.equal(g, ranks[1]["grads"][name]), name
        assert torch.equal(ranks[0]["params"][name], ranks[1]["params"][name]), name
    loss, want = ranks[0]["metrics"]["loss"], one["metrics"]["loss"]
    assert abs(loss - want) <= 1e-2 * abs(want)
    diff = sum(float((g.double() - one["grads"][k].double()).square().sum())
               for k, g in ranks[0]["grads"].items())
    norm = sum(float(g.double().square().sum()) for g in one["grads"].values())
    assert diff <= (5e-2) ** 2 * norm


# --- the CUDA graph of the train step (TRAINER.STEPS_PER_EXECUTION) ------------

@pytest.mark.cuda
@pytest.mark.parametrize("model_type", ["siameseunet", "siamunet_diff"])
def test_cuda_graph_window_equals_the_eager_steps(model_type, monkeypatch):
    """Needs the card: two windows of k = 2 through ``make_scanned_train_step``
    (the first eager, then captured; the second replayed) equal four eager
    steps from the same weights bit for bit, metrics, parameters and
    buffers, at topology [8, 16], batch 2, 32 px crops, bf16, flips and
    rotations on (siamunet_diff: its dropout masks too), cuDNN
    deterministic."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the step is captured only there")
    from multimodal_siamese_cd_tpu_torch import train_lib
    from multimodal_siamese_cd_tpu_torch.config import load_cfg
    from multimodal_siamese_cd_tpu_torch.models.factory import create_network

    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    cfg = load_cfg("siamese")
    cfg.MODEL.TYPE = model_type
    cfg.MODEL.TOPOLOGY = [8, 16]
    gen = torch.Generator().manual_seed(3)
    stacks = torch.rand((2, 2, 2, 15, 32, 32), generator=gen)   # windows, k, B
    stacks[:, :, :, 12:] = (stacks[:, :, :, 12:] > 0.7).float()  # label planes
    stacks, labs = stacks.cuda(), torch.ones((2, 2, 2), device="cuda")
    results = []
    for graphed in (True, False):
        model = create_network(cfg, device="cuda",
                               generator=torch.Generator().manual_seed(1))
        optimizer = train_lib.make_optimizer(model, cfg)
        if graphed:
            window = train_lib.make_scanned_train_step(model, optimizer, cfg,
                                                       "supervised")
            assert window.mode == "graph"
            metrics = [window(stacks[j], labs[j], 2 * j)["loss"] for j in range(2)]
        else:
            step = train_lib.make_train_step(model, optimizer, cfg, "supervised")
            losses = [step(stacks[j, i], labs[j, i], 2 * j + i)["loss"]
                      for j in range(2) for i in range(2)]
            metrics = [torch.stack(losses[:2]).mean(), torch.stack(losses[2:]).mean()]
        results.append(([float(m) for m in metrics],
                        {k: v.clone() for k, v in model.state_dict().items()}))
    (graph_m, graph_sd), (eager_m, eager_sd) = results
    assert graph_m == eager_m
    for key, value in eager_sd.items():
        assert torch.equal(graph_sd[key], value), key
