"""Plain float32 PyTorch versions of the benchmark's models, written from the
published description of the multimodal Siamese change-detection networks
(Hafner et al.; the upstream ``utils/networks.py``): U-Net blocks of
(3x3 conv, BatchNorm, ReLU) x 2, 2x2 max-pool downs, 2x2 stride-2
transposed-conv ups padded to the skip and concatenated after it, a 1x1
head. ``siameseunet`` runs one stem and encoder on both dates and decodes
the per-level differences ``f_t2 - f_t1``; ``whatevernet`` does so per
modality stream (the first ``n_s1`` bands, then the rest), with a head per
stream and a fusion head on the two decoders' outputs. Parameter names
follow the upstream ``state_dict``, so one set of weights loads into both
sides.

``Quantized`` is the control's precision: float8 where the program's
bf16 autocast rounds to bf16. Every convolution's input, weight and output
is rounded to e4m3 and the gradient of its output to e5m2, each with a
per-tensor scale (its largest magnitude to the format's largest), the
rounding passed straight through.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

FORMATS = {torch.float8_e4m3fn: 448.0, torch.float8_e5m2: 57344.0}


class Quantized:
    """Float8 rounding on/off (off: the reference's own precision)."""

    on = False


def _round(x: torch.Tensor, fmt: torch.dtype) -> torch.Tensor:
    scale = x.abs().amax().float().clamp_min(1e-30) / FORMATS[fmt]
    return ((x.float() / scale).to(fmt).float() * scale).to(x.dtype)


def _fp8(x: torch.Tensor) -> torch.Tensor:
    if not Quantized.on:
        return x
    return x + (_round(x.detach(), torch.float8_e4m3fn) - x).detach()


class _GradFp8(torch.autograd.Function):
    """Identity forward; the backward rounds the gradient to e5m2."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _round(g, torch.float8_e5m2)


def _out(y: torch.Tensor) -> torch.Tensor:
    if not Quantized.on:
        return y
    y = _fp8(y)
    return _GradFp8.apply(y) if y.requires_grad else y


class Conv2d(nn.Conv2d):
    def forward(self, x):
        return _out(self._conv_forward(_fp8(x), _fp8(self.weight), self.bias))


class ConvTranspose2d(nn.ConvTranspose2d):
    def forward(self, x):
        return _out(F.conv_transpose2d(_fp8(x), _fp8(self.weight), self.bias, self.stride,
                                       self.padding, self.output_padding, self.groups,
                                       self.dilation))


class DoubleConv(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.conv = nn.Sequential(
            Conv2d(cin, cout, 3, padding=1), nn.BatchNorm2d(cout), nn.ReLU(),
            Conv2d(cout, cout, 3, padding=1), nn.BatchNorm2d(cout), nn.ReLU())

    def forward(self, x):
        return self.conv(x)


class InConv(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.conv = DoubleConv(cin, cout)

    def forward(self, x):
        return self.conv(x)


class Down(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.mpconv = nn.Sequential(nn.MaxPool2d(2), DoubleConv(cin, cout))

    def forward(self, x):
        return self.mpconv(x)


class Up(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.up = ConvTranspose2d(cin // 2, cin // 2, 2, stride=2)
        self.conv = DoubleConv(cin, cout)

    def forward(self, x1, x2):
        x1 = self.up(x1)
        dh, dw = x2.shape[2] - x1.shape[2], x2.shape[3] - x1.shape[3]
        x1 = F.pad(x1, (dw // 2, dw - dw // 2, dh // 2, dh - dh // 2))
        return self.conv(torch.cat([x2, x1], dim=1))


def _widths(topology):
    n = len(topology)
    return [topology[i + 1] if i < n - 1 else topology[i] for i in range(n)]


class Encoder(nn.Module):
    def __init__(self, topology):
        super().__init__()
        self.down_seq = nn.ModuleDict({
            f"down{i + 1}": Down(topology[i], c) for i, c in enumerate(_widths(topology))})

    def forward(self, x):
        feats = [x]
        for down in self.down_seq.values():
            feats.append(down(feats[-1]))
        return feats[::-1]


class Decoder(nn.Module):
    def __init__(self, topology):
        super().__init__()
        up = [topology[0]] + _widths(topology)
        self.up_seq = nn.ModuleDict({
            f"up{i + 1}": Up(up[i] * 2, up[max(i - 1, 0)])
            for i in reversed(range(len(topology)))})

    def forward(self, feats):
        x = feats[0]
        for stage, skip in zip(self.up_seq.values(), feats[1:]):
            x = stage(x, skip)
        return x


class OutConv(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.conv = Conv2d(cin, cout, 1)

    def forward(self, x):
        return self.conv(x)


def _diff(a, b):
    return [fb - fa for fa, fb in zip(a, b)]


class SiameseUNet(nn.Module):
    """Returns the change logits."""

    def __init__(self, topology, in_channels, n_s1_bands=None):
        super().__init__()
        self.inc = InConv(in_channels, topology[0])
        self.encoder = Encoder(topology)
        self.decoder = Decoder(topology)
        self.outc = OutConv(topology[0], 1)

    def forward(self, x1, x2):
        return self.outc(self.decoder(_diff(self.encoder(self.inc(x1)),
                                            self.encoder(self.inc(x2)))))


class WhateverNet(nn.Module):
    """Returns ``(fusion, stream1, stream2)`` logits; in eval use the
    first."""

    def __init__(self, topology, in_channels, n_s1_bands):
        super().__init__()
        self.k = n_s1_bands
        for name, ch in (("stream1", n_s1_bands), ("stream2", in_channels - n_s1_bands)):
            setattr(self, f"inc_{name}", InConv(ch, topology[0]))
            setattr(self, f"encoder_{name}", Encoder(topology))
            setattr(self, f"decoder_{name}", Decoder(topology))
            setattr(self, f"outc_{name}", OutConv(topology[0], 1))
        self.outc_fusion = OutConv(2 * topology[0], 1)

    def _stream(self, name, a, b):
        inc, enc = getattr(self, f"inc_{name}"), getattr(self, f"encoder_{name}")
        return getattr(self, f"decoder_{name}")(_diff(enc(inc(a)), enc(inc(b))))

    def forward(self, x1, x2):
        d1 = self._stream("stream1", x1[:, :self.k], x2[:, :self.k])
        d2 = self._stream("stream2", x1[:, self.k:], x2[:, self.k:])
        return (self.outc_fusion(torch.cat([d1, d2], dim=1)),
                self.outc_stream1(d1), self.outc_stream2(d2))


MODELS = {"siameseunet": SiameseUNet, "whatevernet": WhateverNet}


def build(model: dict) -> nn.Module:
    """The model a config file's ``model`` entry describes."""
    return MODELS[model["type"]](model["topology"], model["in_channels"],
                                 model["n_s1_bands"])


def change_logits(net: nn.Module, x1, x2) -> torch.Tensor:
    out = net(x1, x2)
    return out[0] if isinstance(out, tuple) else out
