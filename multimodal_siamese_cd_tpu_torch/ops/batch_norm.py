"""Train-mode BatchNorm's elementwise halves: the CUDA kernels and their
plain versions.

For a ``(B, C, H, W)`` activation ``x`` (bf16 or float32; contiguous NCHW
or contiguous channels-last) and ``(C,)`` float32 per-channel vectors:

* ``batch_norm_apply(x, mean, scale, bias)`` is the forward's normalisation,
  ``y = ((x - mean) · scale + bias)`` in float32, cast to ``x``'s dtype;
* ``batch_norm_dx(dy, x, mean, a, b, g)`` is the input gradient,
  ``dx = ((dy - b) - (x - mean) · a) · g`` in float32, cast to ``dy``'s
  dtype (``dy`` and ``x`` share one dtype).

A training-mode BatchNorm (:mod:`..models.batchnorm`) computes the vectors
from its statistics (``scale = rstd · weight``; ``a = rstd · dweight / N``,
``b = Σdy / N``, ``g = weight · rstd``) and calls these for the per-element
work.

For CUDA tensors each launches a hand-written kernel in
``csrc/batch_norm.cu`` (built at first use by :mod:`._build`), the one of
its operands' layout (:func:`.layout.of`: a plane kernel for NCHW, a
channels-last kernel otherwise), one pass that reads its operands once and
writes its result once, in that layout; for CPU tensors each runs its plain
PyTorch version, :func:`batch_norm_apply_reference` and
:func:`batch_norm_dx_reference`, the float32 composition the kernels repeat
operation by operation (bit-equal on the card), which takes any strides.
There is no switch and no fallback: a kernel that fails to build or launch
raises.
"""

from __future__ import annotations

from ctypes import c_int, c_longlong, c_void_p

import torch

from . import _build, layout

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# after the tensors: dtype, rows, channels, plane, width, stream
_SHAPE_ARGTYPES = (c_int, c_longlong, c_int, c_longlong, c_int, c_void_p)
# mscd_batch_norm_apply(x, mean, scale, bias, y, ...)
APPLY_ARGTYPES = (c_void_p,) * 5 + _SHAPE_ARGTYPES
# mscd_batch_norm_dx(dy, x, mean, a, b, g, dx, ...)
DX_ARGTYPES = (c_void_p,) * 7 + _SHAPE_ARGTYPES
# the channels-last entries, mscd_batch_norm_{apply,dx}_nhwc: the same
# tensors, then dtype, rows (B·H·W), channels, stream (the C entry picks the
# vector path)
_NHWC_SHAPE_ARGTYPES = (c_int, c_longlong, c_int, c_void_p)
APPLY_NHWC_ARGTYPES = (c_void_p,) * 5 + _NHWC_SHAPE_ARGTYPES
DX_NHWC_ARGTYPES = (c_void_p,) * 7 + _NHWC_SHAPE_ARGTYPES


def _per_channel(v: torch.Tensor) -> torch.Tensor:
    return v[None, :, None, None]


def batch_norm_apply_reference(x, mean, scale, bias):
    """The plain version: a float32 copy, then in place ``- mean``,
    ``· scale``, ``+ bias``, and the cast back to ``x``'s dtype."""
    y = x.to(torch.float32, copy=True)
    y.sub_(_per_channel(mean)).mul_(_per_channel(scale))
    y.add_(_per_channel(bias))
    return y.to(x.dtype)


def batch_norm_dx_reference(dy, x, mean, a, b, g):
    """The plain version: ``t = (x - mean) · a`` and ``((dy - b) - t) · g``
    in float32 copies, cast back to ``dy``'s dtype."""
    t = x.to(torch.float32, copy=True)
    t.sub_(_per_channel(mean)).mul_(_per_channel(a))
    dx = dy.to(torch.float32, copy=True)
    dx.sub_(_per_channel(b)).sub_(t).mul_(_per_channel(g))
    return dx.to(dy.dtype)


def _check(tensors: dict, vectors: dict) -> str:
    """Raise unless the ``tensors`` are one shape and dtype (bf16 or
    float32), all contiguous in one layout (NCHW or channels-last), and the
    ``vectors`` contiguous ``(C,)`` float32, all on one device; return the
    layout, ``"nchw"`` or ``"nhwc"``."""
    (first, x), *rest = tensors.items()
    if x.dim() != 4:
        raise ValueError(f"{first} must be a (B, C, H, W) tensor, got shape "
                         f"{tuple(x.shape)}")
    if x.dtype not in _DTYPE_CODE:
        raise ValueError(f"{first} must be bfloat16 or float32, got {x.dtype}")
    for name, t in rest:
        if t.shape != x.shape or t.dtype != x.dtype:
            raise ValueError(f"{name} must have {first}'s shape and dtype "
                             f"{tuple(x.shape)} {x.dtype}, got {tuple(t.shape)} "
                             f"{t.dtype}")
    for name, v in vectors.items():
        if v.dtype != torch.float32 or v.shape != (x.shape[1],):
            raise ValueError(f"{name} must be a ({x.shape[1]},) float32 vector, got "
                             f"{tuple(v.shape)} {v.dtype}")
    for name, t in {**tensors, **vectors}.items():
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, {first} on {x.device}")
    for name, v in vectors.items():
        if not v.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    found = layout.of(x)
    for name, t in tensors.items():
        if found is None or layout.of(t) != found:
            raise ValueError(f"{name} must be contiguous in {first}'s layout, NCHW "
                             f"or channels-last")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no batch_norm kernel for device {x.device}")
    return found


def vector_width(shape, dtype: torch.dtype, pointers) -> int:
    """The elements a thread of the NCHW kernels moves at once in a launch
    on tensors of ``shape`` and ``dtype`` at the addresses ``pointers``: 16
    bytes' worth when H·W is a multiple of that and every pointer is 16-byte
    aligned, else one. The C entry shapes the grid from it."""
    vector = 16 * 8 // torch.finfo(dtype).bits
    aligned = all(p % 16 == 0 for p in pointers)
    return vector if shape[2] * shape[3] % vector == 0 and aligned else 1


def _launch(kind: str, out: torch.Tensor, tensors: tuple) -> None:
    """Launch the ``kind`` ("apply" or "dx") kernel of ``out``'s layout on
    the current stream: ``tensors`` (the inputs, the vectors, then ``out``)
    and the C entry's shape arguments, dtype, rows, channels and, for NCHW,
    plane and vector width."""
    batch, channels, h, w = out.shape
    if layout.of(out) == "nhwc":
        symbol = f"mscd_batch_norm_{kind}_nhwc"
        argtypes = APPLY_NHWC_ARGTYPES if kind == "apply" else DX_NHWC_ARGTYPES
        shape = [batch * h * w, channels]
    else:
        symbol = f"mscd_batch_norm_{kind}"
        argtypes = APPLY_ARGTYPES if kind == "apply" else DX_ARGTYPES
        width = vector_width(out.shape, out.dtype,
                             [t.data_ptr() for t in tensors if t.dim() == 4])
        shape = [batch * channels, channels, h * w, width]
    _build.launch("batch_norm", symbol, argtypes, out.device,
                  *(t.data_ptr() for t in tensors), _DTYPE_CODE[out.dtype], *shape)


def launch_apply(x, mean, scale, bias, y) -> None:
    """Launch the forward kernel of ``y``'s layout on the current stream,
    writing ``y``. Arguments must already be checked, non-empty CUDA
    tensors; ``batch_norm_apply`` is the entry point."""
    _launch("apply", y, (x, mean, scale, bias, y))


def launch_dx(dy, x, mean, a, b, g, dx) -> None:
    """Launch the input-gradient kernel of ``dx``'s layout on the current
    stream, writing ``dx``. Arguments must already be checked, non-empty
    CUDA tensors; ``batch_norm_dx`` is the entry point."""
    _launch("dx", dx, (dy, x, mean, a, b, g, dx))


def batch_norm_apply(x, mean, scale, bias):
    """``((x - mean) · scale + bias)`` per channel of ``x``, in ``x``'s
    dtype and layout. CUDA tensors launch the kernel of their layout (and
    add one to ``batch_norm_apply.launches``, and for channels-last one to
    ``batch_norm_apply.launches_nhwc`` too); CPU tensors take the plain
    version."""
    found = _check({"x": x}, {"mean": mean, "scale": scale, "bias": bias})
    if x.device.type == "cpu":
        return batch_norm_apply_reference(x, mean, scale, bias)
    y = torch.empty_like(x)
    if x.numel():
        launch_apply(x, mean, scale, bias, y)
        batch_norm_apply.launches += 1
        batch_norm_apply.launches_nhwc += found == "nhwc"
    return y


def batch_norm_dx(dy, x, mean, a, b, g):
    """``((dy - b) - (x - mean) · a) · g`` per channel of ``dy``, ``x``, in
    their dtype and layout. CUDA tensors launch the kernel of their layout
    (and add one to ``batch_norm_dx.launches``, and for channels-last one to
    ``batch_norm_dx.launches_nhwc`` too); CPU tensors take the plain
    version."""
    found = _check({"dy": dy, "x": x}, {"mean": mean, "a": a, "b": b, "g": g})
    if x.device.type == "cpu":
        return batch_norm_dx_reference(dy, x, mean, a, b, g)
    dx = torch.empty_like(dy)
    if dy.numel():
        launch_dx(dy, x, mean, a, b, g, dx)
        batch_norm_dx.launches += 1
        batch_norm_dx.launches_nhwc += found == "nhwc"
    return dx


batch_norm_apply.launches = 0
batch_norm_apply.launches_nhwc = 0
batch_norm_dx.launches = 0
batch_norm_dx.launches_nhwc = 0
