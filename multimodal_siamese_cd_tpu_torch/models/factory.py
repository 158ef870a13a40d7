"""Model factory: ``create_network(cfg)`` keyed by ``cfg.MODEL.TYPE``
(reference utils/networks.py:12-27; the JAX package's ``models/factory.py``).

Builds every type of the JAX package's factory: the reference's 'unet',
'dualstreamunet', 'siameseunet', 'dtsiameseunet', 'whatevernet' and
'whatevernet2', and 'siamunet_diff' (FC-Siam-diff at its fixed published
widths; ``MODEL.TOPOLOGY`` does not apply to it), which the JAX package
adds. An unknown type raises ``NotImplementedError``.
``MODEL.PACKED_FULLRES`` is accepted and ignored: packing is a layout
trick for the TPU's matrix units, and the port always builds the
reference-shaped graph. ``MODEL.REMAT: True`` checkpoints every stem, Down
and Up stage (:func:`.blocks.set_remat`) of every type but
``siamunet_diff``, which does not take the flag, as in the JAX package's
factory.py:62-64. ``MODEL.SYNC_BN`` (default True) sets every BatchNorm's
``sync``: in a multi-process world, statistics over the global batch.
"""

from __future__ import annotations

import torch

from ..device import resolve_device
from . import networks
from .batchnorm import BatchNorm2d
from .blocks import set_remat


def compute_dtype(cfg) -> torch.dtype:
    """Model compute dtype from ``cfg.TRAINER.PRECISION`` (default bf16).
    Params are always fp32."""
    prec = str(cfg.TRAINER.get("PRECISION", "bf16")).lower()
    if prec in ("bf16", "bfloat16"):
        return torch.bfloat16
    if prec in ("fp32", "float32", "f32"):
        return torch.float32
    raise ValueError(f"Unknown TRAINER.PRECISION {prec!r}")


def input_channels(cfg) -> int:
    """Per-timestamp input channel count from DATALOADER.INPUT_MODE and the
    band lists (``MODEL.IN_CHANNELS`` is 3 in base.yaml, wrong for s1s2)."""
    mode = cfg.DATALOADER.INPUT_MODE
    n_s1 = len(cfg.DATALOADER.S1_BANDS)
    n_s2 = len(cfg.DATALOADER.S2_BANDS)
    if mode == 's1':
        return n_s1
    if mode == 's2':
        return n_s2
    return n_s1 + n_s2


def create_network(cfg, device=None, generator: torch.Generator | None = None):
    """Build the model for ``cfg.MODEL.TYPE`` on ``device`` (default: the
    card). Weights are drawn on the CPU from ``generator`` (a CPU
    ``torch.Generator``; None draws from torch's global generator), then
    moved, so one seed gives the same weights on every device."""
    device = resolve_device(device)
    model_type = cfg.MODEL.TYPE
    if model_type not in _MODELS:
        raise NotImplementedError(
            f"unknown MODEL.TYPE {model_type!r}; this package builds "
            f"{sorted(_MODELS)}")
    model = _MODELS[model_type](
        tuple(cfg.MODEL.TOPOLOGY), input_channels(cfg),
        out_channels=cfg.MODEL.OUT_CHANNELS, compute_dtype=compute_dtype(cfg),
        generator=generator, n_s1_bands=len(cfg.DATALOADER.S1_BANDS))
    if remat_applies(cfg):
        set_remat(model)
    sync = bool(cfg.MODEL.get("SYNC_BN", True))
    for m in model.modules():
        if isinstance(m, BatchNorm2d):
            m.sync = sync
    return model.to(device)


def param_count(model: torch.nn.Module) -> int:
    """Trainable parameter count (the JAX package's ``param_count`` of
    ``variables['params']``): BatchNorm running statistics are buffers, left
    out as flax leaves out ``batch_stats``."""
    return sum(p.numel() for p in model.parameters() if p.requires_grad)


def remat_applies(cfg) -> bool:
    """``MODEL.REMAT`` is set and the model type takes it."""
    return bool(cfg.MODEL.get("REMAT", False)) and cfg.MODEL.TYPE != "siamunet_diff"


_MODELS = {
    'unet': networks.UNet,
    'dualstreamunet': networks.DualStreamUNet,
    'siameseunet': networks.SiameseUNet,
    'dtsiameseunet': networks.DualTaskSiameseUNet,
    'whatevernet': networks.WhateverNet,
    'whatevernet2': networks.WhateverNet2,
    'siamunet_diff': networks.SiamUnetDiff,
}
