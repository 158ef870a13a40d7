"""Train-mode BatchNorm's elementwise halves: the CUDA kernels and their
plain versions.

For an NCHW activation ``x`` (bf16 or float32) and ``(C,)`` float32
per-channel vectors:

* ``batch_norm_apply(x, mean, scale, bias)`` is the forward's normalisation,
  ``y = ((x - mean) · scale + bias)`` in float32, cast to ``x``'s dtype;
* ``batch_norm_dx(dy, x, mean, a, b, g)`` is the input gradient,
  ``dx = ((dy - b) - (x - mean) · a) · g`` in float32, cast to ``dy``'s
  dtype (``dy`` and ``x`` share one dtype).

A training-mode BatchNorm (:mod:`..models.batchnorm`) computes the vectors
from its statistics (``scale = rstd · weight``; ``a = rstd · dweight / N``,
``b = Σdy / N``, ``g = weight · rstd``) and calls these for the per-element
work.

For CUDA tensors each launches its hand-written kernel in
``csrc/batch_norm.cu`` (built at first use by :mod:`._build`), one pass
that reads its operands once and writes its result once; for CPU tensors
each runs its plain PyTorch version, :func:`batch_norm_apply_reference`
and :func:`batch_norm_dx_reference`, the float32 composition the kernels
repeat operation by operation (bit-equal on the card). There is no switch
and no fallback: a kernel that fails to build or launch raises.
"""

from __future__ import annotations

from ctypes import c_int, c_longlong, c_void_p

import torch

from . import _build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# after the tensors: dtype, rows, channels, plane, width, stream
_SHAPE_ARGTYPES = (c_int, c_longlong, c_int, c_longlong, c_int, c_void_p)
# mscd_batch_norm_apply(x, mean, scale, bias, y, ...)
APPLY_ARGTYPES = (c_void_p,) * 5 + _SHAPE_ARGTYPES
# mscd_batch_norm_dx(dy, x, mean, a, b, g, dx, ...)
DX_ARGTYPES = (c_void_p,) * 7 + _SHAPE_ARGTYPES


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


def _check(tensors: dict, vectors: dict) -> None:
    """Raise unless the ``tensors`` are one contiguous NCHW shape and dtype
    (bf16 or float32) and the ``vectors`` contiguous ``(C,)`` float32, all
    on one device."""
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
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous (NCHW)")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no batch_norm kernel for device {x.device}")


def vector_width(shape, dtype: torch.dtype, pointers) -> int:
    """The elements a thread moves at once in a launch on tensors of
    ``shape`` and ``dtype`` at the addresses ``pointers``: 16 bytes' worth
    when H·W is a multiple of that and every pointer is 16-byte aligned,
    else one. The C entry shapes the grid from it."""
    plane = shape[2] * shape[3]
    vector = 16 * 8 // torch.finfo(dtype).bits
    aligned = all(p % 16 == 0 for p in pointers)
    return vector if plane % vector == 0 and aligned else 1


def _launch_shape(out: torch.Tensor, *tensors) -> list:
    """The C entry's shape arguments for a checked, non-empty CUDA launch
    writing ``out``: dtype, rows, channels, plane and vector width."""
    batch, channels, h, w = out.shape
    width = vector_width(out.shape, out.dtype,
                         [t.data_ptr() for t in (out, *tensors)])
    return [_DTYPE_CODE[out.dtype], batch * channels, channels, h * w, width]


def launch_apply(x, mean, scale, bias, y) -> None:
    """Launch the forward kernel on the current stream, writing ``y``.
    Arguments must already be checked, non-empty CUDA tensors;
    ``batch_norm_apply`` is the entry point."""
    _build.launch("batch_norm", "mscd_batch_norm_apply", APPLY_ARGTYPES, x.device,
                  *(t.data_ptr() for t in (x, mean, scale, bias, y)),
                  *_launch_shape(y, x))


def launch_dx(dy, x, mean, a, b, g, dx) -> None:
    """Launch the input-gradient kernel on the current stream, writing
    ``dx``. Arguments must already be checked, non-empty CUDA tensors;
    ``batch_norm_dx`` is the entry point."""
    _build.launch("batch_norm", "mscd_batch_norm_dx", DX_ARGTYPES, x.device,
                  *(t.data_ptr() for t in (dy, x, mean, a, b, g, dx)),
                  *_launch_shape(dx, dy, x))


def batch_norm_apply(x, mean, scale, bias):
    """``((x - mean) · scale + bias)`` per channel of NCHW ``x``, in
    ``x``'s dtype. CUDA tensors launch the kernel (and add one to
    ``batch_norm_apply.launches``); CPU tensors take the plain version."""
    _check({"x": x}, {"mean": mean, "scale": scale, "bias": bias})
    if x.device.type == "cpu":
        return batch_norm_apply_reference(x, mean, scale, bias)
    y = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    if x.numel():
        launch_apply(x, mean, scale, bias, y)
        batch_norm_apply.launches += 1
    return y


def batch_norm_dx(dy, x, mean, a, b, g):
    """``((dy - b) - (x - mean) · a) · g`` per channel of NCHW ``dy``,
    ``x``, in their dtype. CUDA tensors launch the kernel (and add one to
    ``batch_norm_dx.launches``); CPU tensors take the plain version."""
    _check({"dy": dy, "x": x}, {"mean": mean, "a": a, "b": b, "g": g})
    if x.device.type == "cpu":
        return batch_norm_dx_reference(dy, x, mean, a, b, g)
    dx = torch.empty(dy.shape, dtype=dy.dtype, device=dy.device)
    if dy.numel():
        launch_dx(dy, x, mean, a, b, g, dx)
        batch_norm_dx.launches += 1
    return dx


batch_norm_apply.launches = 0
batch_norm_dx.launches = 0
