"""Multi-process initialisation (the JAX package's ``parallel/distributed.py``).

The port runs one process per GPU, PyTorch's own idiom::

    MSCD_DISTRIBUTED=1 torchrun --nproc_per_node=N \\
        -m multimodal_siamese_cd_tpu_torch.train_supervised -c siamese ...

Initialisation is env-gated, as in the JAX package: without
``MSCD_DISTRIBUTED=1`` nothing happens and the process trains alone on one
card. With it, the process joins the group that torch's standard variables
describe (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``,
``LOCAL_RANK``; ``torchrun`` sets all five). A partial set, an init that
fails, or a ``LOCAL_RANK`` with no card raises: a run that asked for a
world never trains quietly on one rank.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

from . import group

_ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK")
_local_device: torch.device | None = None


def maybe_initialize_distributed(backend: str | None = None,
                                 init_method: str | None = None) -> bool:
    """Join the process group when ``MSCD_DISTRIBUTED=1``. Returns True when
    the world has more than one process after the call.

    ``backend`` defaults to ``nccl`` on a host with CUDA and ``gloo``
    without; a caller may ask for ``gloo`` on CUDA tensors, which runs the
    three collectives the port uses (all_reduce, broadcast, barrier) with
    several ranks on one card. ``init_method`` defaults to ``env://``
    (``MASTER_ADDR`` / ``MASTER_PORT``); another one (e.g. a ``file://``
    rendezvous) needs only ``WORLD_SIZE``, ``RANK`` and ``LOCAL_RANK``.
    On CUDA each rank's device is ``cuda:LOCAL_RANK``
    (``torch.cuda.set_device``), which :func:`..device.resolve_device`
    then returns."""
    global _local_device
    if group.initialized():
        return dist.get_world_size() > 1
    if os.environ.get("MSCD_DISTRIBUTED") != "1":
        return False
    keys = _ENV if init_method is None else _ENV[2:]
    values = {k: os.environ.get(k) for k in keys}
    missing = [k for k, v in values.items() if not v]
    if missing:
        # all-or-nothing: defaulting the missing ones would make every
        # process claim a world of its own — N independent trainings
        state = "a partial" if len(missing) < len(keys) else "no"
        raise ValueError(
            f"MSCD_DISTRIBUTED=1 with {state} coordinator spec: set ALL of "
            f"{' / '.join(keys)} (torchrun sets them); missing "
            f"{', '.join(missing)}")
    world, rank = int(values["WORLD_SIZE"]), int(values["RANK"])
    local = int(values["LOCAL_RANK"])
    cuda = torch.cuda.is_available()
    if backend is None:
        backend = "nccl" if cuda else "gloo"
    if cuda:
        if local >= torch.cuda.device_count():
            raise ValueError(f"LOCAL_RANK={local}, but this host has "
                             f"{torch.cuda.device_count()} CUDA device(s)")
        torch.cuda.set_device(local)
        _local_device = torch.device("cuda", local)
    dist.init_process_group(backend, init_method=init_method or "env://",
                            world_size=world, rank=rank)
    return world > 1


def local_device() -> torch.device | None:
    """This rank's card once :func:`maybe_initialize_distributed` joined a
    group on a CUDA host, else None."""
    if group.initialized():
        return _local_device
    return None


def shutdown() -> None:
    """Leave the process group, if this process joined one."""
    global _local_device
    if group.initialized():
        dist.destroy_process_group()
    group._columns.clear()
    _local_device = None


def process_shard(n_items: int) -> slice:
    """This rank's contiguous shard of a length-``n_items`` work list, with
    balanced ``np.array_split`` semantics: shard sizes differ by at most
    one, and every rank gets work whenever ``n_items >= world`` (a ceil
    split could hand trailing ranks EMPTY shards, and an idle rank
    deadlocks any collective the others enter)."""
    n, p, i = n_items, group.world_size(), group.rank()
    base, extra = divmod(n, p)
    start = i * base + min(i, extra)
    return slice(start, start + base + (1 if i < extra else 0))
