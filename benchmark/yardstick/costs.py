"""Operations and bytes from layer shapes, counted on the reference model
(never on the program's modules, which later changes may replace).

* Convolution FLOPs of one forward: ``2 · Cin · Cout · kh · kw · B · Hout ·
  Wout`` per 2-D convolution (each output pixel meets every tap once) and
  ``2 · Cin · Cout · kh · kw · B · Hin · Win`` per transposed convolution
  (each input pixel meets every tap once). Nothing else is counted:
  BatchNorm, activations, pooling and the losses are left out, so a share
  of the peak built on these counts is a lower bound.
* The bytes train-mode BatchNorm's statistics need: the forward reads its
  input once, the backward reads the output gradient and the input once,
  each in the compute dtype; each writes two float32 sums a channel.

The shapes come from one forward of the reference model on the ``meta``
device: no memory, no arithmetic.
"""

from __future__ import annotations

import json
from pathlib import Path

import torch
from torch import nn

from ..reference import models

PEAKS = json.loads((Path(__file__).with_name("peaks.json")).read_text())


def peak(device_name: str) -> dict | None:
    """The card's row of ``peaks.json``; None for a card it lacks."""
    return PEAKS.get(device_name)


def layer_shapes(model: dict, batch: int, side: int, width: int | None = None) -> dict:
    """One forward of the reference model at ``(batch, C, side, width)``
    (``width`` default ``side``) per date on the meta device: the
    convolutions' FLOPs and the input shape of every BatchNorm call, in
    call order."""
    with torch.device("meta"):
        net = models.build(model)
    flops, bn = [], []

    def conv(m, inputs, out):
        if isinstance(m, nn.ConvTranspose2d):
            b, _, h, w = inputs[0].shape
        else:
            b, _, h, w = out.shape
        kh, kw = m.kernel_size
        flops.append(2 * m.in_channels * m.out_channels * kh * kw * b * h * w)

    def norm(m, inputs, out):
        bn.append(tuple(inputs[0].shape))

    hooks = []
    for m in net.modules():
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
            hooks.append(m.register_forward_hook(conv))
        elif isinstance(m, nn.BatchNorm2d):
            hooks.append(m.register_forward_hook(norm))
    x = torch.empty((batch, model["in_channels"], side, width or side), device="meta")
    net.train()
    net(x, x.clone())
    for h in hooks:
        h.remove()
    return {"flops": sum(flops), "bn_calls": bn}


def forward_flops(model: dict, batch: int, side: int, width: int | None = None) -> int:
    return layer_shapes(model, batch, side, width)["flops"]


def bn_stats_bytes(model: dict, batch: int, side: int, itemsize: int = 2) -> int:
    """Bytes one training step's BatchNorm statistics need: per call
    ``itemsize · N`` read in the forward, ``2 · itemsize · N`` in the
    backward, and ``2 · 2C`` float32 sums written."""
    total = 0
    for b, c, h, w in layer_shapes(model, batch, side)["bn_calls"]:
        n = b * c * h * w
        total += 3 * itemsize * n + 2 * 2 * c * 4
    return total

