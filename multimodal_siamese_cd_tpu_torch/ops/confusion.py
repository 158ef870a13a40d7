"""Per-scene confusion counts: the CUDA kernel and its plain versions.

``confusion_counts(probs, y, valid, thresholds)`` returns ``(B, 4, T)``
int64 counts in the row order tp, tn, fp, fn for ``B`` flat scenes, with the
training metric's rule ``round(p - thr + 0.5) >= 1``;
``strict_confusion_counts`` returns the same counts with the offline
assessment's rule ``p > thr``. For CUDA tensors both launch the hand-written
kernel ``csrc/confusion.cu`` (the rule is a compile-time flag there, with
one C entry point per rule; built at first use by :mod:`._build`); for CPU
tensors they run the plain PyTorch versions, :func:`confusion_counts_plain`
and :func:`strict_confusion_counts_plain`. There is no switch and no
fallback: a kernel that fails to build or launch raises.

The kernel replaces the JAX package's Pallas kernel
(``multimodal_siamese_cd_tpu/ops/confusion.py`` ``_kernel``, launched by
``_confusion_pallas``) and the XLA formula the JAX eval path runs by default
(``metrics.confusion_at_thresholds``); all of them agree bit for bit. Its
counts are integers, so they stay exact past float32's 2^24 limit.
"""

from __future__ import annotations

from ctypes import c_int, c_longlong, c_void_p

import torch

from ..metrics import confusion_at_thresholds, strict_confusion_counts as _strict
from . import _build

# the kernel keeps the thresholds in (dynamic) shared memory
MAX_THRESHOLDS = 4096
# mscd_confusion_counts and mscd_strict_confusion_counts(probs, labels,
# valid, thresholds, n_thresholds, n_scenes, n_pixels, out, stream)
ARGTYPES = (c_void_p, c_void_p, c_void_p, c_void_p, c_int, c_longlong, c_longlong,
            c_void_p, c_void_p)


def confusion_counts_plain(probs: torch.Tensor, y: torch.Tensor,
                           valid: torch.Tensor,
                           thresholds: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version: :func:`..metrics.confusion_at_thresholds`
    per scene, ``(B, 4, T)`` int64."""
    rows = [torch.stack(confusion_at_thresholds(y[b], probs[b], thresholds,
                                                valid[b]))
            for b in range(probs.shape[0])]
    if not rows:
        return torch.zeros((0, 4, thresholds.numel()), dtype=torch.int64,
                           device=probs.device)
    return torch.stack(rows).round().to(torch.int64)


def strict_confusion_counts_plain(probs: torch.Tensor, y: torch.Tensor,
                                  valid: torch.Tensor,
                                  thresholds: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of the strict rule:
    :func:`..metrics.strict_confusion_counts` per scene and threshold (tp,
    fp, fn), with tn = valid - tp - fp - fn; ``(B, 4, T)`` int64."""
    out = torch.zeros((probs.shape[0], 4, thresholds.numel()),
                      dtype=torch.int64, device=probs.device)
    for b in range(probs.shape[0]):
        n_valid = (valid[b] != 0).sum()
        for k, thr in enumerate(thresholds.tolist()):
            tp, fp, fn = (v.round().to(torch.int64)
                          for v in _strict(y[b], probs[b], valid[b], thr))
            out[b, :, k] = torch.stack([tp, n_valid - tp - fp - fn, fp, fn])
    return out


def _check(probs, y, valid, thresholds) -> None:
    if probs.dim() != 2 or probs.dtype != torch.float32:
        raise ValueError(f"probs must be (B, N) float32, got "
                         f"{tuple(probs.shape)} {probs.dtype}")
    for name, t in (("y", y), ("valid", valid)):
        if t.shape != probs.shape or t.dtype != torch.uint8:
            raise ValueError(f"{name} must be {tuple(probs.shape)} uint8, got "
                             f"{tuple(t.shape)} {t.dtype}")
    if thresholds.dim() != 1 or thresholds.dtype != torch.float32:
        raise ValueError(f"thresholds must be (T,) float32, got "
                         f"{tuple(thresholds.shape)} {thresholds.dtype}")
    if not 1 <= thresholds.numel() <= MAX_THRESHOLDS:
        raise ValueError(f"1 <= T <= {MAX_THRESHOLDS} thresholds, got "
                         f"{thresholds.numel()}")
    devices = {t.device for t in (probs, y, valid, thresholds)}
    if len(devices) != 1:
        raise ValueError(f"all inputs must share one device, got {devices}")


def confusion_counts(probs: torch.Tensor, y: torch.Tensor, valid: torch.Tensor,
                     thresholds: torch.Tensor) -> torch.Tensor:
    """``(B, 4, T)`` int64 tp/tn/fp/fn of ``B`` flat scenes.

    ``probs`` (B, N) float32; ``y`` (B, N) uint8 (truth is ``y != 0``, i.e.
    ``y > 0.5``); ``valid`` (B, N) uint8 {0,1} mask; ``thresholds`` (T,)
    float32. Prediction is ``round(p - thr + 0.5) >= 1`` with round half to
    even. CUDA tensors launch the kernel (and add one to
    ``confusion_counts.launches``); CPU tensors take the plain version."""
    _check(probs, y, valid, thresholds)
    if probs.device.type == "cpu":
        return confusion_counts_plain(probs, y, valid, thresholds)
    out = _run(probs, y, valid, thresholds, strict=False)
    if probs.shape[0]:
        confusion_counts.launches += 1
    return out


def strict_confusion_counts(probs: torch.Tensor, y: torch.Tensor,
                            valid: torch.Tensor,
                            thresholds: torch.Tensor) -> torch.Tensor:
    """:func:`confusion_counts` with the strict rule ``pred = p > thr``
    (the JAX package's ``metrics.strict_confusion_counts``, behind the
    dual-task assessment). CUDA tensors launch the kernel's strict variant
    (and add one to ``strict_confusion_counts.launches``); CPU tensors take
    :func:`strict_confusion_counts_plain`."""
    _check(probs, y, valid, thresholds)
    if probs.device.type == "cpu":
        return strict_confusion_counts_plain(probs, y, valid, thresholds)
    out = _run(probs, y, valid, thresholds, strict=True)
    if probs.shape[0]:
        strict_confusion_counts.launches += 1
    return out


def _run(probs, y, valid, thresholds, strict: bool) -> torch.Tensor:
    """Allocate the zeroed counts and launch one rule's kernel on checked
    non-CPU tensors."""
    if probs.device.type != "cuda":
        raise ValueError(f"no confusion kernel for device {probs.device}")
    if probs.shape[0] > 65535:
        raise ValueError(f"at most 65535 scenes per launch, got {probs.shape[0]}")
    probs, y, valid = probs.contiguous(), y.contiguous(), valid.contiguous()
    thresholds = thresholds.contiguous()
    out = torch.zeros((probs.shape[0], 4, thresholds.numel()),
                      dtype=torch.int64, device=probs.device)
    if probs.shape[0]:
        launch(probs, y, valid, thresholds, out, strict)
    return out


def launch(probs, y, valid, thresholds, out, strict: bool = False) -> None:
    """Launch one rule's kernel on the current stream, adding into ``out``
    ((B, 4, T) int64). Arguments must already be checked, contiguous CUDA
    tensors; ``confusion_counts`` and ``strict_confusion_counts`` are the
    entry points. The C entry plans the grid."""
    symbol = "mscd_strict_confusion_counts" if strict else "mscd_confusion_counts"
    _build.launch("confusion", symbol, ARGTYPES, probs.device, probs.data_ptr(),
                  y.data_ptr(), valid.data_ptr(), thresholds.data_ptr(),
                  thresholds.numel(), *probs.shape, out.data_ptr())


confusion_counts.launches = 0
strict_confusion_counts.launches = 0
