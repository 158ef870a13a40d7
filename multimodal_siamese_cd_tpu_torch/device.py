"""The package's default-device policy, in one place.

Every entry point takes ``device=None``; ``None`` means the CUDA card — in a
multi-process run (:mod:`.parallel.distributed`) this rank's card,
``cuda:LOCAL_RANK``. On a host without one that is an error, never a silent
run on the CPU: a caller who wants the CPU (the tests) asks for it with
``device="cpu"``.
"""

from __future__ import annotations

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
