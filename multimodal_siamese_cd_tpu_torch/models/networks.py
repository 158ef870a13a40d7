"""Change-detection networks (PyTorch, NCHW): every type of the reference
factory (reference networks.py:12-27), each the counterpart of the JAX
package's class of the same name.

  'unet'            ``UNet``: early fusion, concat(t1, t2) -> U-Net
                    (the JAX package's networks.py:64-86)
  'dualstreamunet'  ``DualStreamUNet``: one early-fusion U-Net per modality,
                    a 1x1 head on both decoders' output (:89-120)
  'siameseunet'     ``SiameseUNet``: a shared-weight stem and encoder on both
                    dates, per-level differences ``f_t2 - f_t1``, one decoder
                    and a 1x1 head (:123-146)
  'dtsiameseunet'   ``DualTaskSiameseUNet``: adds a semantic decoder shared by
                    both dates and an auxiliary head (:149-200)
  'whatevernet'     ``WhateverNet``: one Siamese-difference U-Net per
                    modality with its own head, plus a fusion head (:203-242)
  'whatevernet2'    ``WhateverNet2``: as whatevernet, each stream early
                    fusion (:245-281)
  'siamunet_diff'   ``SiamUnetDiff``: FC-Siam-diff at its fixed published
                    widths, in the reference's flat layer names, with
                    spatial dropout (:284-373)

The two-stream models split the channels of each date at ``n_s1_bands``
(every constructor takes it, so the factory calls them all alike; the
single-stream ones ignore it): stream 1 is S1 and stream 2 is S2, the order of
:func:`..train_lib.split_stack`. Their top-level attribute names are the
flax modules' (``inc_stream1``, ``encoder_stream1``, ..., ``outc_fusion``),
so the reference ``state_dict`` grammar holds for every U-Net type
(``SiamUnetDiff`` keeps the reference's flat names instead).

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
import torch.nn.functional as F
from torch import nn

from ..parallel import halo
from .batchnorm import BatchNorm2d
from .blocks import (Decoder, Encoder, HaloConv2d, HaloConvTranspose2d, InConv,
                     OutConv, pad_to_skip, whole_below)

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
                 generator: torch.Generator | None = None,
                 n_s1_bands: int | None = None):
        del n_s1_bands                   # one stream: every band together
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
                 generator: torch.Generator | None = None,
                 n_s1_bands: int | None = None):
        del n_s1_bands                   # one stream: every band together
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


class UNet(nn.Module):
    """Early-fusion U-Net on ``concat(x_t1, x_t2)`` (reference
    networks.py:59-79)."""

    def __init__(self, topology: Sequence[int], in_channels: int,
                 out_channels: int = 1,
                 compute_dtype: torch.dtype = torch.bfloat16,
                 generator: torch.Generator | None = None,
                 n_s1_bands: int | None = None):
        del n_s1_bands                   # one stream: every band together
        super().__init__()
        self.compute_dtype = compute_dtype
        self.inc = InConv(2 * in_channels, topology[0])
        self.encoder = Encoder(topology)
        self.decoder = Decoder(topology)
        self.outc = OutConv(topology[0], out_channels)
        lecun_normal_(self, generator)

    def forward(self, x_t1: torch.Tensor, x_t2: torch.Tensor) -> torch.Tensor:
        x = self.inc(torch.cat([x_t1, x_t2], dim=1))
        return self.outc(self.decoder(self.encoder(x)))


class _TwoStreams(nn.Module):
    """The stems, encoders and decoders of the two modality streams, named
    ``{inc,encoder,decoder}_stream{1,2}``. ``siamese`` streams run the stem
    and encoder on each date and decode the feature differences; the others
    run them once on ``concat(t1, t2)``. ``stream_heads`` adds a 1x1 head per
    stream (``outc_stream{1,2}``)."""

    def __init__(self, topology: Sequence[int], in_channels: int,
                 n_s1_bands: int, out_channels: int, siamese: bool,
                 stream_heads: bool):
        super().__init__()
        self.n_s1_bands = n_s1_bands
        self.siamese = siamese
        per_date = (n_s1_bands, in_channels - n_s1_bands)
        for name, ch in zip(("stream1", "stream2"), per_date):
            setattr(self, f"inc_{name}", InConv(ch if siamese else 2 * ch,
                                                topology[0]))
            setattr(self, f"encoder_{name}", Encoder(topology))
            setattr(self, f"decoder_{name}", Decoder(topology))
            if stream_heads:
                setattr(self, f"outc_{name}", OutConv(topology[0], out_channels))

    def _stream(self, name: str, a: torch.Tensor, b: torch.Tensor):
        inc = getattr(self, f"inc_{name}")
        enc = getattr(self, f"encoder_{name}")
        if self.siamese:
            # a's stem and encoder before b's: in train mode each call
            # updates their BatchNorm running statistics, in flax's order
            feats = _diff(enc(inc(a)), enc(inc(b)))
        else:
            feats = enc(inc(torch.cat([a, b], dim=1)))
        return getattr(self, f"decoder_{name}")(feats)

    def streams(self, x_t1: torch.Tensor, x_t2: torch.Tensor):
        """Both streams' decoder outputs ``(d1, d2)``, stream 1 first."""
        k = self.n_s1_bands
        d1 = self._stream("stream1", x_t1[:, :k], x_t2[:, :k])
        d2 = self._stream("stream2", x_t1[:, k:], x_t2[:, k:])
        return d1, d2


class DualStreamUNet(_TwoStreams):
    """Late fusion of per-modality early-fusion U-Nets (reference
    networks.py:82-120): the head ``outc`` on ``concat(d1, d2)``."""

    def __init__(self, topology: Sequence[int], in_channels: int,
                 n_s1_bands: int, out_channels: int = 1,
                 compute_dtype: torch.dtype = torch.bfloat16,
                 generator: torch.Generator | None = None):
        super().__init__(topology, in_channels, n_s1_bands, out_channels,
                         siamese=False, stream_heads=False)
        self.compute_dtype = compute_dtype
        self.outc = OutConv(2 * topology[0], out_channels)
        lecun_normal_(self, generator)

    def forward(self, x_t1: torch.Tensor, x_t2: torch.Tensor) -> torch.Tensor:
        return self.outc(torch.cat(self.streams(x_t1, x_t2), dim=1))


class WhateverNet(_TwoStreams):
    """Per-modality Siamese-difference streams with their own heads and a
    fusion head on ``concat(d1, d2)``: the semi-supervised consistency model
    (reference networks.py:200-263). In train mode ``forward`` returns the
    logits ``(fusion, stream1, stream2)``; in eval mode the fusion logits
    alone, as the JAX package does with ``train=True/False``."""

    _SIAMESE = True

    def __init__(self, topology: Sequence[int], in_channels: int,
                 n_s1_bands: int, out_channels: int = 1,
                 compute_dtype: torch.dtype = torch.bfloat16,
                 generator: torch.Generator | None = None):
        super().__init__(topology, in_channels, n_s1_bands, out_channels,
                         siamese=self._SIAMESE, stream_heads=True)
        self.compute_dtype = compute_dtype
        self.outc_fusion = OutConv(2 * topology[0], out_channels)
        lecun_normal_(self, generator)

    def forward(self, x_t1: torch.Tensor, x_t2: torch.Tensor):
        d1, d2 = self.streams(x_t1, x_t2)
        out_fusion = self.outc_fusion(torch.cat([d1, d2], dim=1))
        if self.training:
            return out_fusion, self.outc_stream1(d1), self.outc_stream2(d2)
        return out_fusion


class WhateverNet2(WhateverNet):
    """Like :class:`WhateverNet`, each stream early fusion (concat t1, t2)
    instead of a Siamese difference (reference networks.py:266-310)."""

    _SIAMESE = False


# FC-Siam-diff in the reference's flat layer names (the JAX package's
# torch_port._siamunet_diff_key_map): encoder stage s runs conv{s}{i} and
# bn{s}{i} for i = 1..n; decoder stage s runs upconv{s}, then conv{s}{j}d and
# bn{s}{j}d for the listed j, in that (descending) order; conv11d, the
# logits head, has no BatchNorm.
SIAMUNET_DIFF_ENCODER = ((16, 2), (32, 2), (64, 3), (128, 3))  # width, convs
SIAMUNET_DIFF_DECODER = (                 # stage, upconv width, (j, width)
    (4, 128, ((3, 128), (2, 128), (1, 64))),
    (3, 64, ((3, 64), (2, 64), (1, 32))),
    (2, 32, ((2, 32), (1, 16))),
    (1, 16, ((2, 16), (1, None))),        # (1, None): conv11d
)
SIAMUNET_DIFF_DROPOUT = 0.2


def siamunet_diff_flax_names() -> dict:
    """The JAX package's ``SiamUnetDiff`` module paths -> this package's flat
    attribute names: ``enc{s}_{i}/{conv,bn}``, ``dec{s}_{k}/{conv,bn}`` (the
    k-th unit the stage applies), ``upconv{s}`` and ``outc`` (conv11d)."""
    names = {}
    for s, (_, n) in enumerate(SIAMUNET_DIFF_ENCODER, start=1):
        for i in range(1, n + 1):
            names[(f"enc{s}_{i}", "conv")] = f"conv{s}{i}"
            names[(f"enc{s}_{i}", "bn")] = f"bn{s}{i}"
    for s, _, convs in SIAMUNET_DIFF_DECODER:
        names[(f"upconv{s}",)] = f"upconv{s}"
        for k, (j, width) in enumerate(convs, start=1):
            if width is None:
                names[("outc",)] = f"conv{s}{j}d"
            else:
                names[(f"dec{s}_{k}", "conv")] = f"conv{s}{j}d"
                names[(f"dec{s}_{k}", "bn")] = f"bn{s}{j}d"
    return names


def spatial_dropout(x: torch.Tensor, p: float, generator: torch.Generator,
                    rows: tuple[int, int] | None = None) -> torch.Tensor:
    """flax's ``nn.Dropout(p, broadcast_dims=(1, 2))`` on NHWC (the JAX
    package's networks.py:304) for NCHW: one keep draw per (sample,
    channel), ``uniform < 1 - p`` from ``generator`` (on ``x``'s device);
    kept channels divided by ``1 - p``, dropped ones zero. ``rows = (start,
    total)``: ``x`` holds rows ``[start, start + B)`` of a global batch of
    ``total`` (one data column's share); the draw is the global batch's,
    and ``x`` takes its rows of it — every space rank of the column the
    same mask, whatever height block it holds."""
    keep = 1.0 - p
    start, total = (0, x.shape[0]) if rows is None else rows
    mask = torch.rand((total, x.shape[1], 1, 1), generator=generator,
                      device=x.device)[start:start + x.shape[0]] < keep
    return torch.where(mask, x / keep, x.new_zeros(()))


class SiamUnetDiff(nn.Module):
    """FC-Siam-diff (Daudt, Le Saux & Boulch, ICIP 2018; reference
    networks.py:466-658, the JAX package's networks.py:309-373).

    Fixed stage widths 16/32/64/128 (2/2/3/3 convs; ``topology`` is
    ignored), each unit conv -> BN -> ReLU -> spatial dropout 0.2. Both
    dates run the shared encoder, t1 first; the decoder starts from the
    **t2** bottleneck and concatenates each upsampled map with ``|skip_t1 -
    skip_t2|``, the upsampled map edge-padded on the bottom/right where the
    skip is larger. Every decoder conv and the logits head are transposed
    3x3 convs (stride 1, padding 1); ``upconv{s}`` is ``ConvTranspose2d(k3,
    s2, padding=1, output_padding=1)``, the flax padding ``((1, 2), (1,
    2))``. Returns float32 logits.

    In train mode ``forward`` needs ``generator``, the explicit generator of
    the dropout draws (the train step passes its per-step generator, see
    :func:`..train_lib.augment_generator`); torch's global generator is
    never used.

    Height sharding (:mod:`..parallel.halo`): encoder stage ``s`` computes
    pyramid level ``s - 1``, its 3x3 convs and the decoder's stride-1
    transposed ones attach a row of each neighbour, ``upconv{s}`` the next
    shard's first row (:class:`.blocks.HaloConvTranspose2d`); the pool into
    the first level whose rows do not halve evenly makes its input whole,
    and the decoder's replicate pad-to-skip takes the rank's rows back
    (:func:`.blocks.pad_to_skip`)."""

    draws_dropout = True    # the train step passes its generator to forward

    def __init__(self, topology: Sequence[int], in_channels: int,
                 out_channels: int = 1,
                 compute_dtype: torch.dtype = torch.bfloat16,
                 generator: torch.Generator | None = None,
                 n_s1_bands: int | None = None):
        del topology, n_s1_bands    # fixed published widths, one stream
        super().__init__()
        self.compute_dtype = compute_dtype
        ch = in_channels
        for s, (width, n) in enumerate(SIAMUNET_DIFF_ENCODER, start=1):
            for i in range(1, n + 1):
                setattr(self, f"conv{s}{i}", HaloConv2d(ch, width, 3, padding=1))
                setattr(self, f"bn{s}{i}", BatchNorm2d(width, eps=1e-5,
                                                      momentum=0.1))
                ch = width
        for s, up_width, convs in SIAMUNET_DIFF_DECODER:
            setattr(self, f"upconv{s}", HaloConvTranspose2d(
                ch, up_width, 3, stride=2, padding=1, output_padding=1))
            ch = up_width + SIAMUNET_DIFF_ENCODER[s - 1][0]     # + the skip
            for j, width in convs:
                out = out_channels if width is None else width
                setattr(self, f"conv{s}{j}d",
                        HaloConvTranspose2d(ch, out, 3, padding=1))
                if width is not None:
                    setattr(self, f"bn{s}{j}d", BatchNorm2d(width, eps=1e-5,
                                                           momentum=0.1))
                ch = out
        lecun_normal_(self, generator)

    def _unit(self, x: torch.Tensor, name: str, generator, rows) -> torch.Tensor:
        """conv{name} -> bn{name} -> ReLU -> spatial dropout (train mode)."""
        x = torch.relu(getattr(self, f"bn{name}")(getattr(self, f"conv{name}")(x)))
        if self.training:
            x = spatial_dropout(x, SIAMUNET_DIFF_DROPOUT, generator, rows)
        return x

    def _encode(self, x: torch.Tensor, generator, rows):
        skips = []
        for s, (_, n) in enumerate(SIAMUNET_DIFF_ENCODER, start=1):
            with halo.level(s - 1):
                for i in range(1, n + 1):
                    x = self._unit(x, f"{s}{i}", generator, rows)
            skips.append(x)
            x = F.max_pool2d(whole_below(x, s), 2)
        return x, skips

    def forward(self, x_t1: torch.Tensor, x_t2: torch.Tensor,
                generator: torch.Generator | None = None,
                rows: tuple[int, int] | None = None) -> torch.Tensor:
        """``rows``: the inputs are one rank's rows of a global batch
        (:func:`spatial_dropout`)."""
        if self.training and generator is None:
            raise ValueError("SiamUnetDiff in train mode draws its dropout "
                             "masks from an explicit generator; pass one")
        _, skips1 = self._encode(x_t1, generator, rows)
        x, skips2 = self._encode(x_t2, generator, rows)   # the t2 bottleneck
        for s, _, convs in SIAMUNET_DIFF_DECODER:
            with halo.level(s):
                x = getattr(self, f"upconv{s}")(x)
            skip = (skips1[s - 1] - skips2[s - 1]).abs()
            x = torch.cat([pad_to_skip(x, skip, s - 1, mode="replicate"), skip],
                          dim=1)
            with halo.level(s - 1):
                for j, width in convs:
                    if width is None:
                        x = getattr(self, f"conv{s}{j}d")(x)
                    else:
                        x = self._unit(x, f"{s}{j}d", generator, rows)
        return x.float()
