"""3x3 stride-1 SAME convolution: the CUDA kernel and its plain version.

``conv3x3(x, w)`` takes ``x`` (B, H, W, Cin) NHWC and ``w`` (3, 3, Cin,
Cout) HWIO and returns ``y`` (B, H, W, Cout) in ``x``'s dtype. Both operands
are rounded to bf16 (round to nearest even), the products are accumulated in
float32, and the padding is one zero pixel on every side. For CUDA tensors
it launches the hand-written kernel ``csrc/conv3x3.cu`` (built at first use
by :mod:`._build`); for CPU tensors it runs the plain PyTorch version,
:func:`conv3x3_plain`. There is no switch and no fallback: a kernel that
fails to build or launch raises.

The kernel replaces the JAX package's Pallas kernel
``tools/pallas_conv3x3_experiment.py`` ``_kernel`` (launched by
``conv3x3_pallas``), with the same interface as that module: ``conv3x3``
and its reference. Like the JAX module, it is an op of its own; no model of
either package calls it.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# the kernel loads 8 channels (16 bytes of bf16) at a time
CHANNEL_MULTIPLE = 8

_fn = None


def _kernel():
    """The loaded C entry point, with its ctypes signature declared."""
    global _fn
    if _fn is None:
        from ._build import load_library

        lib = load_library("conv3x3")
        fn = lib.mscd_conv3x3
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def conv3x3_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version: ``x`` and ``w`` rounded to bf16, upcast to
    float32, ``F.conv2d(padding=1)`` in NCHW / OIHW, back to NHWC in
    ``x``'s dtype (the JAX module's ``conv3x3_reference`` on bf16
    operands). On the card it is compared with the kernel with
    ``torch.backends.cudnn.allow_tf32 = False``, so its float32 convolution
    is float32."""
    xb = x.to(torch.bfloat16).float().permute(0, 3, 1, 2)
    wb = w.to(torch.bfloat16).float().permute(3, 2, 0, 1)
    y = F.conv2d(xb, wb, padding=1)
    return y.permute(0, 2, 3, 1).to(x.dtype).contiguous()


def _check(x: torch.Tensor, w: torch.Tensor) -> None:
    if x.dim() != 4 or x.dtype not in _DTYPE_CODE:
        raise ValueError(f"x must be (B, H, W, Cin) float32 or bfloat16, got "
                         f"{tuple(x.shape)} {x.dtype}")
    if w.dim() != 4 or tuple(w.shape[:3]) != (3, 3, x.shape[3]) \
            or w.dtype not in _DTYPE_CODE:
        raise ValueError(f"w must be (3, 3, {x.shape[3]}, Cout) float32 or "
                         f"bfloat16, got {tuple(w.shape)} {w.dtype}")
    if x.device != w.device:
        raise ValueError(f"x and w must share one device, got {x.device} and "
                         f"{w.device}")


def conv3x3(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``y = conv3x3_same(x, w)``: NHWC ``x``, HWIO ``w`` -> NHWC ``y`` in
    ``x``'s dtype. CUDA tensors launch the kernel (and add one to
    ``conv3x3.launches``); CPU tensors take the plain version. The kernel
    takes any B, H and W, and Cin and Cout that are multiples of 8."""
    _check(x, w)
    if x.device.type == "cpu":
        return conv3x3_plain(x, w)
    if x.device.type != "cuda":
        raise ValueError(f"no conv3x3 kernel for device {x.device}")
    batch, height, width, cin = x.shape
    cout = w.shape[3]
    if cin % CHANNEL_MULTIPLE or cout % CHANNEL_MULTIPLE:
        raise ValueError(f"the conv3x3 kernel needs Cin and Cout that are "
                         f"multiples of {CHANNEL_MULTIPLE}, got Cin {cin}, "
                         f"Cout {cout}")
    if batch > 65535:
        raise ValueError(f"at most 65535 images per launch, got {batch}")
    x = x.contiguous()
    w = w.to(torch.bfloat16).contiguous()
    # a view that starts mid-vector: the kernel loads 16 bytes at a time
    x = x.clone() if x.data_ptr() % 16 else x
    w = w.clone() if w.data_ptr() % 16 else w
    y = torch.empty((batch, height, width, cout), dtype=x.dtype,
                    device=x.device)
    if y.numel() == 0:
        return y
    if x.numel() == 0:       # Cin == 0: an empty sum
        return y.zero_()
    launch(x, w, y)
    conv3x3.launches += 1
    return y


def launch(x: torch.Tensor, w: torch.Tensor, y: torch.Tensor) -> None:
    """Launch the kernel on the current stream, writing ``y``. Arguments
    must already be checked, contiguous, 16-byte aligned, non-empty CUDA
    tensors with ``w`` in bfloat16; ``conv3x3`` is the entry point."""
    batch, height, width, cin = x.shape
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _kernel()(x.data_ptr(), w.data_ptr(), y.data_ptr(),
                        _DTYPE_CODE[x.dtype], batch, height, width, cin,
                        w.shape[3], stream)
    if err != 0:
        raise RuntimeError(f"conv3x3 kernel launch failed: cudaError {err}")


conv3x3.launches = 0
