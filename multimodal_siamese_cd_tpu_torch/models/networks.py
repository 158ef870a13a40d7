"""Change-detection networks (PyTorch, NCHW): 'siameseunet' and
'dtsiameseunet'.

``SiameseUNet`` is the counterpart of the JAX package's ``SiameseUNet``
(reference networks.py:123-154): a shared-weight stem and encoder applied to
both dates, per-level feature differences ``f_t2 - f_t1``, one decoder and a
1x1 head. ``DualTaskSiameseUNet`` (the JAX package's networks.py:149-200)
adds a semantic decoder shared by both dates and an auxiliary head.

Fresh initialization is chosen on purpose to match the JAX package, not
torch's defaults: every conv and transposed-conv kernel is drawn
``lecun_normal`` (truncated normal, variance 1 / fan_in with fan_in =
in_channels * kh * kw, cut at two standard deviations — flax's default
kernel init) and every bias is zero (flax's default bias init); BatchNorm
starts at scale 1, bias 0, mean 0, var 1 in both frameworks. Torch's own
default (kaiming_uniform(a=√5) with uniform biases) trains differently from
flax's, which the reference-parity report (VERDICT.md, Weak #1) names as one
of two protocol gaps between the frameworks; matching flax here keeps that
gap out of the port. The draws come from an explicit ``torch.Generator``,
so a seed fixes the weights; they are not the JAX package's draws for the
same seed (move weights with :mod:`..weights` for that).
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn

from .blocks import Decoder, Encoder, InConv, OutConv

# flax lecun_normal: truncated_normal over [-2, 2] rescaled to unit
# variance, i.e. stddev / 0.87962566103423978 before truncation
_TRUNC_STD_CORRECTION = 0.87962566103423978


def _diff(features_t1: list, features_t2: list) -> list:
    """Per-level bitemporal feature difference f_t2 - f_t1
    (reference networks.py:147-150)."""
    return [f2 - f1 for f1, f2 in zip(features_t1, features_t2)]


def lecun_normal_(module: nn.Module, generator: torch.Generator | None) -> None:
    """flax-default init for every conv / transposed conv in ``module``:
    lecun_normal kernels, zero biases."""
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
            w = m.weight
            # Conv2d [O, I, kh, kw]; ConvTranspose2d [I, O, kh, kw]: flax's
            # fan_in is the INPUT channel count times the taps either way
            in_ch = w.shape[1] if isinstance(m, nn.Conv2d) else w.shape[0]
            std = math.sqrt(1.0 / (in_ch * w.shape[2] * w.shape[3]))
            std /= _TRUNC_STD_CORRECTION
            with torch.no_grad():
                nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std,
                                      generator=generator)
                nn.init.zeros_(m.bias)


class SiameseUNet(nn.Module):
    """Shared-weight Siamese U-Net on feature differences
    (reference networks.py:123-154). ``compute_dtype`` is the precision
    :func:`..train_lib.eval_forward` runs it at on the card (bf16 autocast
    or fp32); parameters are always fp32."""

    def __init__(self, topology: Sequence[int], in_channels: int,
                 out_channels: int = 1,
                 compute_dtype: torch.dtype = torch.bfloat16,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.inc = InConv(in_channels, topology[0])
        self.encoder = Encoder(topology)
        self.decoder = Decoder(topology)
        self.outc = OutConv(topology[0], out_channels)
        lecun_normal_(self, generator)

    def forward(self, x_t1: torch.Tensor, x_t2: torch.Tensor) -> torch.Tensor:
        f_t1 = self.encoder(self.inc(x_t1))
        f_t2 = self.encoder(self.inc(x_t2))
        return self.outc(self.decoder(_diff(f_t1, f_t2)))


class DualTaskSiameseUNet(nn.Module):
    """Siamese encoder with a change decoder and a semantic decoder shared by
    both dates (reference networks.py:157-197). ``forward`` returns the
    logits ``(change, sem_t1, sem_t2)``. The auxiliary change-from-semantics
    head ``outc_sem_change`` takes no part in ``forward``; it is a trained
    parameter set that the offline assessment applies through
    :meth:`sem_change_head`."""

    def __init__(self, topology: Sequence[int], in_channels: int,
                 out_channels: int = 1,
                 compute_dtype: torch.dtype = torch.bfloat16,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.inc = InConv(in_channels, topology[0])
        self.encoder = Encoder(topology)
        self.decoder_change = Decoder(topology)
        self.decoder_sem = Decoder(topology)
        self.outc_change = OutConv(topology[0], out_channels)
        self.outc_sem = OutConv(topology[0], out_channels)
        self.outc_sem_change = OutConv(2 * out_channels, 1)
        lecun_normal_(self, generator)

    def forward(self, x_t1: torch.Tensor, x_t2: torch.Tensor):
        f_t1 = self.encoder(self.inc(x_t1))
        f_t2 = self.encoder(self.inc(x_t2))
        out_change = self.outc_change(self.decoder_change(_diff(f_t1, f_t2)))
        # t2 before t1, as the JAX package calls them: in train mode each
        # call updates the shared decoder's BatchNorm running statistics
        out_sem_t2 = self.outc_sem(self.decoder_sem(f_t2))
        out_sem_t1 = self.outc_sem(self.decoder_sem(f_t1))
        return out_change, out_sem_t1, out_sem_t2

    def sem_change_head(self, logits_sem_t1: torch.Tensor,
                        logits_sem_t2: torch.Tensor) -> torch.Tensor:
        """The auxiliary head on the concatenated semantic logits
        (assessment_semantics.py:117)."""
        return self.outc_sem_change(torch.cat([logits_sem_t1, logits_sem_t2],
                                              dim=1))
