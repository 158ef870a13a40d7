"""Checkpoint save/load (the JAX package's ``checkpoints.py``).

The reference's on-disk contract: files named
``{OUTPUT}/networks/{NAME}_checkpoint{epoch}.pt`` holding a torch-serialized
``{'step', 'network', 'optimizer'}`` (utils/networks.py:30-56). ``network``
is the model's ``state_dict`` in the reference key grammar with the
``module.`` prefix of the reference's ``nn.DataParallel`` wrapper, so the
reference's ``load_checkpoint`` and the JAX package's
``torch_port.load_reference_checkpoint`` read the file as it is;
``optimizer`` is the AdamW ``state_dict``.
"""

from __future__ import annotations

import os
import pickle
from pathlib import Path

import torch

from .device import resolve_device
from .models.factory import create_network
from .train_lib import make_optimizer

_PREFIX = "module."


def checkpoint_file(cfg, epoch) -> Path:
    return Path(cfg.PATHS.OUTPUT) / 'networks' / f'{cfg.NAME}_checkpoint{epoch}.pt'


def latest_checkpoint_epoch(cfg):
    """Highest epoch with a ``{NAME}_checkpoint{epoch}.pt`` on disk, or None
    (``TRAINER.RESUME_CHECKPOINT: latest``). Only integer epoch tags count;
    partial ``.tmp{pid}`` files never match the ``.pt`` suffix."""
    net_dir = Path(cfg.PATHS.OUTPUT) / 'networks'
    if not net_dir.is_dir():
        return None
    prefix, best = f'{cfg.NAME}_checkpoint', None
    for f in net_dir.iterdir():
        if not (f.name.startswith(prefix) and f.name.endswith('.pt')):
            continue
        try:
            epoch = int(f.name[len(prefix):-3])
        except ValueError:
            continue
        if best is None or epoch > best:
            best = epoch
    return best


def save_checkpoint(model, optimizer, epoch, step: int, cfg) -> Path:
    """reference networks.py:30-38; atomic: a crash mid-write leaves the
    canonical name absent or pointing at the previous complete file."""
    save_file = checkpoint_file(cfg, epoch)
    save_file.parent.mkdir(parents=True, exist_ok=True)
    network = {_PREFIX + k: v.detach().cpu()
               for k, v in model.state_dict().items()}
    tmp = save_file.with_name(save_file.name + f".tmp{os.getpid()}")
    torch.save({'step': int(step), 'network': network,
                'optimizer': optimizer.state_dict()}, tmp)
    os.replace(tmp, save_file)
    return save_file


def load_checkpoint(epoch, cfg, net_file: Path | None = None, device=None):
    """Rebuild model + AdamW on ``device`` (default: the card) and restore
    them (reference networks.py:41-56) from ``net_file``, by default the
    epoch's :func:`checkpoint_file`. Accepts the reference's
    ``module.``-prefixed ``network`` and a bare ``state_dict``. Returns
    ``(model, optimizer, step)``. A missing file raises
    ``FileNotFoundError``; one that ``torch.load`` refuses, or whose keys
    or shapes the model or AdamW refuse, raises ``ValueError`` naming the
    file (the JAX package's contract). Errors of the device while the
    weights are copied onto it (out of memory, a CUDA fault) pass through
    unchanged.

    The file is read onto the host: ``load_state_dict`` moves the weights
    and AdamW's moments to the parameters' device and leaves AdamW's step
    counters on the host, where ``torch.optim.AdamW`` reads them. Read onto
    the card, each counter would cost a device-to-host copy and a wait per
    parameter tensor at every step."""
    device = resolve_device(device)
    model = create_network(cfg, device=device)
    optimizer = make_optimizer(model, cfg)
    file = checkpoint_file(cfg, epoch) if net_file is None else Path(net_file)
    try:                         # a missing file keeps its FileNotFoundError
        ckpt = torch.load(file, map_location="cpu", weights_only=True)
        network = {k[len(_PREFIX):] if k.startswith(_PREFIX) else k: v
                   for k, v in ckpt['network'].items()}
        _check_network(model, network)
        optimizer_state, step = ckpt['optimizer'], int(ckpt['step'])
    except (RuntimeError, KeyError, TypeError, ValueError, AttributeError,
            EOFError, pickle.UnpicklingError) as e:     # all on the host
        raise _corrupt(file, e) from e
    model.load_state_dict(network, strict=True)
    try:           # AdamW checks the groups before it copies onto the device
        optimizer.load_state_dict(optimizer_state)
    except (KeyError, TypeError, ValueError) as e:
        raise _corrupt(file, e) from e
    return model, optimizer, step


def _check_network(model, network: dict) -> None:
    """Raise ``ValueError`` unless ``network`` has exactly the model's
    state-dict keys, each tensor of the model's shape."""
    own = model.state_dict()
    missing, unexpected = own.keys() - network.keys(), network.keys() - own.keys()
    if missing or unexpected:
        raise ValueError(f"missing keys {sorted(missing)}, unexpected keys "
                         f"{sorted(unexpected)}")
    for key, value in network.items():
        if tuple(value.shape) != tuple(own[key].shape):
            raise ValueError(f"{key}: shape {tuple(value.shape)}, the model's "
                             f"is {tuple(own[key].shape)}")


def _corrupt(file: Path, e: Exception) -> ValueError:
    return ValueError(f"Corrupt or incompatible checkpoint {file}: "
                      f"{type(e).__name__}: {e}")
