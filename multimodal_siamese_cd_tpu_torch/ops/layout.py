"""The two dense layouts of a ``(B, C, H, W)`` activation that the
BatchNorm kernels take, told apart by strides.

NCHW (``torch.contiguous_format``) keeps each (b, c) plane contiguous;
channels-last (``torch.channels_last``) keeps the C channels of each pixel
contiguous, the layout cuDNN's convolutions compute in. :func:`of` names a
tensor's layout; a tensor dense in both (one channel, or one pixel a
plane) counts as NCHW. :func:`memory_format` is the format to make a tensor
dense in: its own, NCHW for a view dense in neither.
"""

from __future__ import annotations

import torch


def of(t: torch.Tensor) -> str | None:
    """``"nchw"`` for a contiguous tensor, ``"nhwc"`` for a dense
    channels-last one that is not contiguous, else None."""
    if t.is_contiguous():
        return "nchw"
    if t.dim() == 4 and t.is_contiguous(memory_format=torch.channels_last):
        return "nhwc"
    return None


def memory_format(t: torch.Tensor) -> torch.memory_format:
    """``torch.channels_last`` for a dense channels-last tensor, else
    ``torch.contiguous_format``."""
    return torch.channels_last if of(t) == "nhwc" else torch.contiguous_format
