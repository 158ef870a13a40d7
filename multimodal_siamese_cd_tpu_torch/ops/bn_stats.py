"""Per-channel BatchNorm statistics: the CUDA kernel and its plain version.

``bn_stats(a, b)`` returns ``(s1, s2)``, two ``(C,)`` float32 tensors with
``s1 = Σ_{b,h,w} a`` and ``s2 = Σ_{b,h,w} a·b`` for NCHW tensors ``a`` and
``b`` of one shape, both bf16 or both float32, accumulated in float32. A
training-mode BatchNorm (:mod:`..models.batchnorm`) calls it with ``a = b =
x`` in its forward (Σx, Σx²) and with ``(dy, x)`` in its backward (Σdy,
Σdy·x).

For CUDA tensors it launches the hand-written kernel ``csrc/bn_stats.cu``
(built at first use by :mod:`._build`); for CPU tensors it runs the plain
PyTorch version, :func:`bn_stats_reference`. There is no switch and no
fallback: a kernel that fails to build or launch raises.

The kernel replaces the JAX package's Pallas probe
``tools/bench_bn_reduce.py`` ``_kernel`` (launched by ``pallas_reduce``),
which computes the same two sums over an NHWC activation. It is
deterministic: two launches on the same inputs give the same bits.
"""

from __future__ import annotations

from ctypes import c_int, c_longlong, c_void_p

import torch

from . import _build

# elements of one channel that one block reduces (a multiple of the 16-byte
# vector width of both dtypes); csrc/bn_stats.cu's grid is (chunks, C)
CHUNK = 8192
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# mscd_bn_stats(a, b, dtype, batch, channels, plane, chunk, chunks, partial,
# s1, s2, stream)
ARGTYPES = (c_void_p, c_void_p, c_int, c_longlong, c_int, c_longlong, c_longlong,
            c_int, c_void_p, c_void_p, c_void_p, c_void_p)


def bn_stats_reference(a: torch.Tensor, b: torch.Tensor,
                       dtype: torch.dtype = torch.float32):
    """The plain PyTorch version: sums over (0, 2, 3) in ``dtype``
    (float32; the card's check also runs it in float64)."""
    af = a.to(dtype)
    return af.sum(dim=(0, 2, 3)), (af * b.to(dtype)).sum(dim=(0, 2, 3))


def _check(a: torch.Tensor, b: torch.Tensor) -> None:
    if a.dim() != 4 or b.shape != a.shape:
        raise ValueError(f"a and b must be one (B, C, H, W) shape, got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    if a.dtype not in _DTYPE_CODE or b.dtype != a.dtype:
        raise ValueError(f"a and b must be both bfloat16 or both float32, got "
                         f"{a.dtype} and {b.dtype}")
    if a.device != b.device:
        raise ValueError(f"a and b must share one device, got {a.device} and "
                         f"{b.device}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("a and b must be contiguous NCHW tensors")


def bn_stats(a: torch.Tensor, b: torch.Tensor):
    """``(Σa, Σa·b)`` per channel of NCHW ``a``, ``b`` as two ``(C,)``
    float32 tensors. CUDA tensors launch the kernel (and add one to
    ``bn_stats.launches``); CPU tensors take the plain version."""
    _check(a, b)
    if a.device.type == "cpu":
        return bn_stats_reference(a, b)
    if a.device.type != "cuda":
        raise ValueError(f"no bn_stats kernel for device {a.device}")
    channels = a.shape[1]
    if channels > 65535:
        raise ValueError(f"at most 65535 channels per launch, got {channels}")
    s1 = torch.empty(channels, dtype=torch.float32, device=a.device)
    s2 = torch.empty(channels, dtype=torch.float32, device=a.device)
    if a.numel() == 0:
        return s1.zero_(), s2.zero_()
    chunks = -(-a.shape[0] * a.shape[2] * a.shape[3] // CHUNK)
    partial = torch.empty(channels * chunks * 2, dtype=torch.float32,
                          device=a.device)
    launch(a, b, s1, s2, partial)
    bn_stats.launches += 1
    return s1, s2


def launch(a, b, s1, s2, partial) -> None:
    """Launch the two kernels on the current stream, writing ``s1``, ``s2``
    ((C,) float32) through the ``partial`` scratch (C · chunks · 2 float32).
    Arguments must already be checked, contiguous, non-empty CUDA tensors;
    ``bn_stats`` is the entry point."""
    batch, channels, h, w = a.shape
    chunks = partial.numel() // (2 * channels)
    _build.launch("bn_stats", "mscd_bn_stats", ARGTYPES, a.device, a.data_ptr(),
                  b.data_ptr(), _DTYPE_CODE[a.dtype], batch, channels, h * w, CHUNK,
                  chunks, partial.data_ptr(), s1.data_ptr(), s2.data_ptr())


bn_stats.launches = 0
