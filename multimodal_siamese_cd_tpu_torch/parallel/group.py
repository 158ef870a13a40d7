"""The rank's view of the process group (what a torch reader needs of the
JAX package's ``parallel/mesh.py``).

The JAX package shards the batch over a 1-D device mesh and lets GSPMD
insert the collectives; the port runs one process per card and makes them
explicitly. Where the JAX package speaks of the data axis, the port speaks
of the world: :func:`world_size` is ``data_axis_size``, each rank one
shard. Differences from ``nn.DataParallel``, by design, as in the JAX
package: gradients are all-reduced (every rank updates identically) and
BatchNorm statistics are global over the batch (sync-BN) unless
``MODEL.SYNC_BN: False``.

The port uses three collectives only — ``all_reduce``, ``broadcast`` and
``barrier`` — because gloo runs exactly these on CUDA tensors: two ranks
can then share one card, which is how the one-card check runs a world of
two. Without a process group every function here is the one-process
identity.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist


def initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    """Ranks in the process group (1 without one): the data axis size."""
    return dist.get_world_size() if initialized() else 1


def rank() -> int:
    """This process's rank (0 without a process group)."""
    return dist.get_rank() if initialized() else 0


def batch_rows(batch: int, accum: int = 1, rank_: int | None = None,
               world: int | None = None) -> np.ndarray:
    """The rows of a global batch of ``batch`` that rank ``rank_`` (default:
    this one) holds, in order: with ``TRAINER.GRAD_ACCUM accum`` the batch is
    ``accum`` contiguous micro-batches, and each micro-batch is split into
    ``world`` contiguous shares, one per rank — the layout of the JAX
    package's micro-batch sharding (``train_lib.py:261-281``). Raises the
    JAX package's ``ValueError`` when ``accum`` does not divide the batch
    or the micro-batch does not split over the ranks."""
    rank_ = rank() if rank_ is None else rank_
    world = world_size() if world is None else world
    if batch % accum:
        raise ValueError(f"TRAINER.GRAD_ACCUM={accum} must divide the "
                         f"batch size {batch}")
    mb = batch // accum
    if mb % world:
        if accum > 1:
            raise ValueError(
                f"TRAINER.GRAD_ACCUM={accum} makes the micro-batch {mb}, "
                f"which does not split over the {world}-shard data mesh axis "
                f"(one shard per rank). Use a batch size with micro-batch a "
                f"multiple of {world}.")
        raise ValueError(f"the batch {batch} does not split over {world} "
                         f"ranks")
    share = mb // world
    return np.concatenate([np.arange(j * mb + rank_ * share,
                                     j * mb + (rank_ + 1) * share)
                           for j in range(accum)])


def all_reduce_(tensor: torch.Tensor) -> torch.Tensor:
    """Sum ``tensor`` over the ranks, in place, when the world has more
    than one rank; returns it."""
    if world_size() > 1:
        dist.all_reduce(tensor)
    return tensor


def _flat_groups(tensors):
    """``tensors`` grouped by dtype, each group with its flat copy."""
    groups: dict = {}
    for t in tensors:
        groups.setdefault(t.dtype, []).append(t)
    return [(ts, torch.cat([t.reshape(-1) for t in ts])) for ts in groups.values()]


def _unflatten(tensors, flat) -> None:
    offset = 0
    with torch.no_grad():
        for t in tensors:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()


def all_reduce_flat_(tensors) -> None:
    """Sum every tensor of ``tensors`` over the ranks, in place, through one
    flat all-reduce per dtype (gradients: one for the whole model)."""
    if world_size() <= 1:
        return
    for ts, flat in _flat_groups(tensors):
        dist.all_reduce(flat)
        _unflatten(ts, flat)


def broadcast_(tensors, src: int = 0) -> None:
    """Overwrite ``tensors`` on every rank with rank ``src``'s, one flat
    broadcast per dtype, whenever a process group exists (a world of one
    too)."""
    if not initialized():
        return
    for ts, flat in _flat_groups(tensors):
        dist.broadcast(flat, src)
        _unflatten(ts, flat)


def barrier() -> None:
    """Wait for every rank, whenever a process group exists."""
    if initialized():
        dist.barrier()


def global_rows(tensors, start: int, total: int) -> list:
    """Global-shaped float32 copies of per-rank row blocks: each tensor of
    ``tensors`` holds this rank's rows ``[start, start + k)`` of a global
    ``(total, ...)`` tensor; every rank fills its rows of zeroed global
    buffers and one flat float32 all-reduce sums them (exactly: every
    element has one non-zero term). The results are detached and equal on
    every rank."""
    total_sizes = [total * t[0].numel() for t in tensors]
    flat = torch.zeros(sum(total_sizes), dtype=torch.float32,
                       device=tensors[0].device)
    views, offset = [], 0
    for t, size in zip(tensors, total_sizes):
        view = flat[offset:offset + size].view((total,) + tuple(t.shape[1:]))
        view[start:start + t.shape[0]] = t.detach()
        views.append(view)
        offset += size
    all_reduce_(flat)
    return views
