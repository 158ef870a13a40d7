"""Per-channel BatchNorm statistics: the CUDA kernels and their plain version.

``bn_stats(a, b)`` returns ``(s1, s2)``, two ``(C,)`` float32 tensors with
``s1 = Σ_{b,h,w} a`` and ``s2 = Σ_{b,h,w} a·b`` for ``(B, C, H, W)``
tensors ``a`` and ``b`` of one shape, both bf16 or both float32, both
contiguous NCHW or both contiguous channels-last, accumulated in float32. A
training-mode BatchNorm (:mod:`..models.batchnorm`) calls it with ``a = b =
x`` in its forward (Σx, Σx²) and with ``(dy, x)`` in its backward (Σdy,
Σdy·x).

For CUDA tensors it launches a hand-written kernel of ``csrc/bn_stats.cu``
(built at first use by :mod:`._build`), the one of the tensors' layout
(:func:`.layout.of`): the plane kernel for NCHW, the channels-last kernel
otherwise; for CPU tensors it runs the plain PyTorch version,
:func:`bn_stats_reference`, which takes any strides. There is no switch and
no fallback: a kernel that fails to build or launch raises.

The kernel replaces the JAX package's Pallas probe
``tools/bench_bn_reduce.py`` ``_kernel`` (launched by ``pallas_reduce``),
which computes the same two sums over an NHWC activation. It is
deterministic: two launches on the same inputs give the same bits.
"""

from __future__ import annotations

from ctypes import addressof, c_int, c_longlong, c_void_p

import torch

from . import _build, layout

# elements of one channel that one block of the NCHW kernels reduces (a
# multiple of the 16-byte vector width of both dtypes); csrc/bn_stats.cu's
# grid is (chunks, C). The channels-last kernel's grid is planned in C.
CHUNK = 8192
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# mscd_bn_stats(a, b, dtype, batch, channels, plane, chunk, chunks, partial,
# s1, s2, stream)
ARGTYPES = (c_void_p, c_void_p, c_int, c_longlong, c_int, c_longlong, c_longlong,
            c_int, c_void_p, c_void_p, c_void_p, c_void_p)
# mscd_bn_stats_nhwc_chunks(rows, channels, chunks, stream)
NHWC_CHUNKS_ARGTYPES = (c_longlong, c_int, c_void_p, c_void_p)
# mscd_bn_stats_nhwc(a, b, dtype, rows, channels, chunks, partial, s1, s2,
# stream)
NHWC_ARGTYPES = (c_void_p, c_void_p, c_int, c_longlong, c_int, c_int, c_void_p,
                 c_void_p, c_void_p, c_void_p)


def bn_stats_reference(a: torch.Tensor, b: torch.Tensor,
                       dtype: torch.dtype = torch.float32):
    """The plain PyTorch version: sums over (0, 2, 3) in ``dtype``
    (float32; the card's check also runs it in float64)."""
    af = a.to(dtype)
    return af.sum(dim=(0, 2, 3)), (af * b.to(dtype)).sum(dim=(0, 2, 3))


def _check(a: torch.Tensor, b: torch.Tensor) -> str:
    """Raise unless ``a`` and ``b`` are what a kernel takes; return their
    layout, ``"nchw"`` or ``"nhwc"``."""
    if a.dim() != 4 or b.shape != a.shape:
        raise ValueError(f"a and b must be one (B, C, H, W) shape, got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    if a.dtype not in _DTYPE_CODE or b.dtype != a.dtype:
        raise ValueError(f"a and b must be both bfloat16 or both float32, got "
                         f"{a.dtype} and {b.dtype}")
    if a.device != b.device:
        raise ValueError(f"a and b must share one device, got {a.device} and "
                         f"{b.device}")
    found = layout.of(a)
    if found is None or layout.of(b) != found:
        raise ValueError("a and b must be contiguous in one layout, NCHW or "
                         "channels-last")
    return found


def nhwc_chunks(a: torch.Tensor) -> int:
    """The chunks of rows the channels-last kernels' launch on tensors of
    ``a``'s shape (a non-empty CUDA tensor) takes on its device, as their C
    entry plans them: the launch's ``partial`` scratch holds C · chunks · 2
    float32."""
    chunks = c_int()
    _build.launch("bn_stats", "mscd_bn_stats_nhwc_chunks", NHWC_CHUNKS_ARGTYPES,
                  a.device, a.numel() // a.shape[1], a.shape[1], addressof(chunks))
    return chunks.value


def bn_stats(a: torch.Tensor, b: torch.Tensor):
    """``(Σa, Σa·b)`` per channel of ``a``, ``b`` as two ``(C,)`` float32
    tensors. CUDA tensors launch the kernel of their layout (and add one to
    ``bn_stats.launches``, and for channels-last one to
    ``bn_stats.launches_nhwc`` too); CPU tensors take the plain version."""
    found = _check(a, b)
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
    rows = a.shape[0] * a.shape[2] * a.shape[3]
    chunks = nhwc_chunks(a) if found == "nhwc" else -(-rows // CHUNK)
    partial = torch.empty(channels * chunks * 2, dtype=torch.float32,
                          device=a.device)
    if found == "nhwc":
        launch_nhwc(a, b, s1, s2, partial)
        bn_stats.launches_nhwc += 1
    else:
        launch(a, b, s1, s2, partial)
    bn_stats.launches += 1
    return s1, s2


def launch(a, b, s1, s2, partial) -> None:
    """Launch the two NCHW kernels on the current stream, writing ``s1``,
    ``s2`` ((C,) float32) through the ``partial`` scratch (C · chunks · 2
    float32). Arguments must already be checked, contiguous, non-empty CUDA
    tensors; ``bn_stats`` is the entry point."""
    batch, channels, h, w = a.shape
    chunks = partial.numel() // (2 * channels)
    _build.launch("bn_stats", "mscd_bn_stats", ARGTYPES, a.device, a.data_ptr(),
                  b.data_ptr(), _DTYPE_CODE[a.dtype], batch, channels, h * w, CHUNK,
                  chunks, partial.data_ptr(), s1.data_ptr(), s2.data_ptr())


def launch_nhwc(a, b, s1, s2, partial) -> None:
    """Launch the channels-last kernels on the current stream, as
    :func:`launch` (``partial``: C · chunks · 2 float32, chunks from
    :func:`nhwc_chunks`). Arguments must already be checked, dense
    channels-last, non-empty CUDA tensors."""
    channels = a.shape[1]
    _build.launch("bn_stats", "mscd_bn_stats_nhwc", NHWC_ARGTYPES, a.device,
                  a.data_ptr(), b.data_ptr(), _DTYPE_CODE[a.dtype],
                  a.numel() // channels, channels, partial.numel() // (2 * channels),
                  partial.data_ptr(), s1.data_ptr(), s2.data_ptr())


bn_stats.launches = 0
bn_stats.launches_nhwc = 0
