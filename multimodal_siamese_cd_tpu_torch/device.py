"""The package's default-device policy, in one place.

Every entry point takes ``device=None``; ``None`` means the CUDA card — in a
multi-process run (:mod:`.parallel.distributed`) this rank's card,
``cuda:LOCAL_RANK``. On a host without one that is an error, never a silent
run on the CPU: a caller who wants the CPU (the tests) asks for it with
``device="cpu"``.
"""

from __future__ import annotations

import subprocess

import torch

from .parallel.distributed import local_device


def resolve_device(device=None) -> torch.device:
    """``None`` -> this rank's card, ``cuda`` outside a process group
    (raises ``RuntimeError`` when no CUDA device exists); anything else ->
    ``torch.device(device)``."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the default device is the card; pass "
            "device='cpu' explicitly to run on the CPU")
    local = local_device()
    return torch.device("cuda") if local is None else local


def describe(device: torch.device) -> dict:
    """What a measurement ran on, for its printed line: on the card its name
    (``torch.cuda.get_device_name``), the device count and the power limit
    ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` reports
    for it (``"not measured"`` where nvidia-smi cannot say); elsewhere the
    platform alone, so no CPU number reads as a card's."""
    if device.type != "cuda":
        return {"platform": device.type, "name": device.type, "count": 0,
                "power_limit": "not measured"}
    index = torch.cuda.current_device() if device.index is None else device.index
    try:
        rows = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60).stdout.splitlines()
        limit = rows[index].rsplit(",", 1)[1].strip()
    except (OSError, subprocess.SubprocessError, IndexError):
        limit = "not measured"
    return {"platform": "gpu", "name": torch.cuda.get_device_name(index),
            "count": torch.cuda.device_count(), "power_limit": limit}
