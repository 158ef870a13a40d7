"""U-Net building blocks (PyTorch, NCHW).

The counterparts of the JAX package's ``models/blocks.py`` (the unpacked
graph, ``MODEL.PACKED_FULLRES: False``) and of the reference blocks
(utils/networks.py: DoubleConv :386-402, InConv :405-412, Down :415-426,
Up :429-451, OutConv :454-461, Encoder :313-343, Decoder :346-382).
Attribute names reproduce the reference ``state_dict`` grammar, so one set
of weights drives the reference, this package and (through
:mod:`..weights`) the JAX package:

  * ``inc.conv.conv.{0,1,3,4}.*``           InConv -> DoubleConv Sequential
  * ``encoder.down_seq.downN.mpconv.1.conv.{j}.*``
  * ``decoder.up_seq.upN.up.*``             ConvTranspose2d(k=2, s=2)
  * ``decoder.up_seq.upN.conv.conv.{j}.*``
  * ``outc.conv.*``                         1x1 Conv2d

BatchNorm is :class:`.batchnorm.BatchNorm2d` (eps 1e-5, torch momentum 0.1
== flax momentum 0.9): ``nn.BatchNorm2d``'s names and eval mode, flax's
training semantics, its statistics through the ``bn_stats`` kernel.

``MODEL.REMAT`` (:func:`set_remat`) checkpoints every stem, Down and Up
stage, the stages the JAX package wraps in ``nn.remat`` (its blocks.py:197,
:227, networks.py:55-59).

Height sharding (``TRAINER.SPATIAL_SHARDS``, :mod:`..parallel.halo`): each
stage declares the pyramid level it computes, and inside a
``halo.height_sharded`` context the 3x3 convolutions (:class:`HaloConv2d`)
attach one row of each neighbouring space rank and convolve with height
padding 0. ``Down`` pools locally while the rank's rows are even; at the
first level where they are not it makes its input whole on every space rank
and the deeper levels run unsharded. ``Up``'s transposed conv (k2, s2) is
local; where it meets a sharded skip from an unsharded level it pads the
whole map to the skip's global height (the top rows on space rank 0, the
odd one after on the last) and keeps this rank's rows. The unsharded graph
and the parameter names are unchanged.
"""

from __future__ import annotations

import contextlib
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..parallel import halo
from .batchnorm import BatchNorm2d


class _Stage(nn.Module):
    """A U-Net stage that ``MODEL.REMAT`` may checkpoint: in train mode with
    ``remat`` set, ``forward`` keeps only the stage's inputs, and the
    backward runs :meth:`stage` again to rebuild its activations
    (``torch.utils.checkpoint``, non-reentrant). The second forward runs
    with the stage's BatchNorms marked ``recomputing``, so their running
    statistics and ``num_batches_tracked`` move once a step, as in the plain
    step; its ``bn_stats`` launches are the cost (84 a ``siameseunet`` step
    instead of 56). Subclasses define :meth:`stage`."""

    remat = False

    def forward(self, *xs: torch.Tensor) -> torch.Tensor:
        if self.remat and self.training and torch.is_grad_enabled():
            # the stages draw no random numbers: no RNG state to stash
            return checkpoint(self.stage, *xs, use_reentrant=False,
                              preserve_rng_state=False,
                              context_fn=self._contexts)
        return self.stage(*xs)

    def _contexts(self):
        return contextlib.nullcontext(), self._recompute()

    @contextlib.contextmanager
    def _recompute(self):
        bns = [m for m in self.modules() if isinstance(m, BatchNorm2d)]
        for m in bns:
            m.recomputing = True
        try:
            yield
        finally:
            for m in bns:
                m.recomputing = False


def set_remat(model: nn.Module) -> None:
    """Checkpoint every stage of ``model`` (``MODEL.REMAT: True``)."""
    for m in model.modules():
        if isinstance(m, _Stage):
            m.remat = True


class HaloConv2d(nn.Conv2d):
    """``nn.Conv2d`` (stride 1, height padding ``p``) that, on a sharded
    level (:func:`..parallel.halo.sharded`), attaches ``p`` rows of each
    neighbouring space rank and convolves with height padding 0."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        p = self.padding[0]
        if not p or not halo.sharded():
            return super().forward(x)
        return F.conv2d(halo.halo(x, p, p), self.weight, self.bias, self.stride,
                        (0, self.padding[1]), self.dilation, self.groups)


class HaloConvTranspose2d(nn.ConvTranspose2d):
    """``nn.ConvTranspose2d`` whose output height is ``stride`` times its
    input's (``k + output_padding - 2p == stride``) that, on a sharded level,
    computes this rank's ``stride · h`` output rows from its input rows and
    the neighbours' rows they reach: output row ``o = stride·i - p + t``
    needs input rows ``(k - 1 - p) // stride`` above the rank's and ``(p +
    stride - 1) // stride`` below it (a stride-1 3x3 with padding 1: one
    each side; stride 2, k3, p1: the next shard's first row; k2, s2, p0:
    none)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not halo.sharded():
            return super().forward(x)
        (k, _), (s, _), (p, pw) = self.kernel_size, self.stride, self.padding
        top, bottom = (k - 1 - p) // s, (p + s - 1) // s
        out = F.conv_transpose2d(halo.halo(x, top, bottom), self.weight, self.bias,
                                 self.stride, (0, pw), (0, self.output_padding[1]),
                                 self.groups, self.dilation)
        first = s * top + p
        return out[:, :, first:first + s * x.shape[2]]


class DoubleConv(nn.Module):
    """(3x3 conv -> BN -> ReLU) * 2 (reference networks.py:386-402);
    Sequential indices 0, 1, 3, 4 hold the conv/BN weights."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.conv = nn.Sequential(
            HaloConv2d(in_ch, out_ch, 3, padding=1),
            BatchNorm2d(out_ch, eps=1e-5, momentum=0.1),
            nn.ReLU(inplace=True),
            HaloConv2d(out_ch, out_ch, 3, padding=1),
            BatchNorm2d(out_ch, eps=1e-5, momentum=0.1),
            nn.ReLU(inplace=True),
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


class InConv(_Stage):
    """Stem block (reference networks.py:405-412), pyramid level 0."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.conv = DoubleConv(in_ch, out_ch)

    def stage(self, x: torch.Tensor) -> torch.Tensor:
        with halo.level(0):
            return self.conv(x)


def whole_below(x: torch.Tensor, level: int) -> torch.Tensor:
    """The input of the pooling into ``level``: made whole on every space
    rank when its own level is sharded and ``level`` is not (its rows do
    not pool evenly), else as it is."""
    if halo.sharded(level - 1) and not halo.sharded(level):
        return halo.whole(x)
    return x


class Down(_Stage):
    """maxpool(2) + DoubleConv (reference networks.py:415-426), computing
    pyramid level ``level``. MaxPool2d(2) floors odd sizes, like the JAX
    package's VALID pool."""

    def __init__(self, in_ch: int, out_ch: int, level: int = 1):
        super().__init__()
        self.level = level
        self.mpconv = nn.Sequential(nn.MaxPool2d(2), DoubleConv(in_ch, out_ch))

    def stage(self, x: torch.Tensor) -> torch.Tensor:
        x = whole_below(x, self.level)
        with halo.level(self.level):
            return self.mpconv(x)


def pad_to_skip(x: torch.Tensor, skip: torch.Tensor, level: int,
                mode: str = "constant") -> torch.Tensor:
    """Pad the upsampled map ``x`` to the size of ``skip`` at ``level``:
    ``constant`` zeros split as the JAX package's jnp.pad splits them (the
    odd pixel after, bottom/right), ``replicate`` all after. Where ``x``
    comes from an unsharded level and ``skip`` is sharded, ``x`` is whole:
    it is padded to the skip's global height and this rank keeps its
    rows."""
    h = skip.shape[2]
    reshard = halo.sharded(level) and not halo.sharded(level + 1)
    if reshard:
        h *= halo.active().space_size
    dh, dw = h - x.shape[2], skip.shape[3] - x.shape[3]
    if dh or dw:
        pads = ((dw // 2, dw - dw // 2, dh // 2, dh - dh // 2) if mode == "constant"
                else (0, dw, 0, dh))
        x = F.pad(x, pads, mode=mode)
    return halo.own_rows(x) if reshard else x


class Up(_Stage):
    """ConvTranspose(k=2, s=2) upsample + pad-to-skip + concat + DoubleConv
    (reference networks.py:429-451): ``Up(in_ch, out_ch)`` upsamples
    ``in_ch // 2`` channels and convolves the ``in_ch``-wide concat at the
    skip's pyramid level ``level``."""

    def __init__(self, in_ch: int, out_ch: int, level: int = 0):
        super().__init__()
        self.level = level
        self.up = nn.ConvTranspose2d(in_ch // 2, in_ch // 2, 2, stride=2)
        self.conv = DoubleConv(in_ch, out_ch)

    def stage(self, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
        # the k2 s2 upsample is local: output rows 2i, 2i+1 read row i alone
        x1 = pad_to_skip(self.up(x1), x2, self.level)
        with halo.level(self.level):
            return self.conv(torch.cat([x2, x1], dim=1))  # skip first


class OutConv(nn.Module):
    """1x1 projection head (reference networks.py:454-461). Logits are
    returned in fp32 whatever the compute dtype."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.conv = nn.Conv2d(in_ch, out_ch, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x).float()


def encoder_widths(topology: Sequence[int]) -> list[int]:
    """Output width of each Down stage. The last stage keeps its input width
    (reference networks.py:326-329)."""
    n = len(topology)
    return [topology[i + 1] if i != n - 1 else topology[i] for i in range(n)]


class Encoder(nn.Module):
    """Down-ladder over TOPOLOGY; returns features deepest-first
    (reference networks.py:313-343)."""

    def __init__(self, topology: Sequence[int]):
        super().__init__()
        widths = encoder_widths(topology)
        self.down_seq = nn.ModuleDict({
            f"down{idx + 1}": Down(topology[idx], out_ch, level=idx + 1)
            for idx, out_ch in enumerate(widths)})

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        feats = [x]
        for down in self.down_seq.values():
            feats.append(down(feats[-1]))
        return feats[::-1]


def decoder_up_topology(topology: Sequence[int]) -> list[int]:
    """The reference's ``up_topo`` (networks.py:355-361): stage widths from
    shallow to deep, with the extra stem width prepended."""
    return [topology[0]] + encoder_widths(topology)


class Decoder(nn.Module):
    """Up-ladder consuming a deepest-first feature list
    (reference networks.py:346-382). Stages are named ``up{idx+1}`` over
    ``reversed(range(n))`` and applied in that order."""

    def __init__(self, topology: Sequence[int]):
        super().__init__()
        up_topo = decoder_up_topology(topology)
        stages = {}
        for idx in reversed(range(len(topology))):
            x2_idx = idx - 1 if idx != 0 else idx
            stages[f"up{idx + 1}"] = Up(up_topo[idx] * 2, up_topo[x2_idx],
                                        level=idx)
        self.up_seq = nn.ModuleDict(stages)

    def forward(self, features: list[torch.Tensor]) -> torch.Tensor:
        x1 = features[0]
        for i, up in enumerate(self.up_seq.values()):
            x1 = up(x1, features[i + 1])
        return x1
