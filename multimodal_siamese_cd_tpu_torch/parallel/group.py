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

``TRAINER.SPATIAL_SHARDS n`` (the JAX package's ``data_space_mesh``,
parallel/mesh.py:36-50) lays the world out as a ``(data, space)`` grid,
:class:`Grid`: rank ``r`` has data index ``r // n`` and space index ``r %
n``, the row-major order of the JAX package's ``reshape(W // n, n)``. The
``n`` space ranks of a data column hold the same rows of the global batch,
each a contiguous ``1/n`` of every crop's height (:mod:`.halo` exchanges
the rows a convolution needs across them); :func:`batch_rows` then takes
the data index and the data size, not the rank and the world.
:func:`space_shards` is the JAX package's rule for accepting a grid
(trainers.py:55-66); a grid it refuses runs data-parallel.

The port uses three collectives only — ``all_reduce``, ``broadcast`` and
``barrier`` — because gloo runs exactly these on CUDA tensors: two ranks
can then share one card, which is how the one-card check runs a world of
two. Without a process group every function here is the one-process
identity.
"""

from __future__ import annotations

from dataclasses import dataclass

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
    package's micro-batch sharding (``train_lib.py:261-281``). On a
    :class:`Grid` pass its data index and data size: every space rank of a
    data column holds the column's rows. Raises the
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


@dataclass(frozen=True)
class Grid:
    """This rank's place in the ``(data, space)`` grid of the world (the
    port's counterpart of the JAX package's 2-D mesh): ``space_size`` ranks
    split each crop's height, ``data_size`` columns of them split the
    batch. ``column`` is the process group of this rank's data column (its
    ``space_size`` space ranks; None: the default group, the whole world);
    ``space_size == 1`` is the plain data-parallel world."""
    space_size: int
    space_index: int
    data_size: int
    data_index: int
    column: object = None


# the process group of every data column, by SPATIAL_SHARDS (every rank
# creates every group, in the same order, the first time it asks)
_columns: dict = {}


def space_shards(cfg, world: int | None = None) -> int:
    """``TRAINER.SPATIAL_SHARDS`` when the world of ``world`` ranks (default:
    this one) accepts the grid, else 1: the JAX package's rule
    (trainers.py:55-66) — the world divides into columns of ``n``, the
    batch over the ``world // n`` columns, and the crop height over the
    ``n`` space ranks."""
    n = int(cfg.TRAINER.get('SPATIAL_SHARDS', 1))
    world = world_size() if world is None else world
    if (n > 1 and world % n == 0 and cfg.TRAINER.BATCH_SIZE % (world // n) == 0
            and cfg.AUGMENTATION.CROP_SIZE % n == 0):
        return n
    return 1


def grid(n: int = 1) -> Grid:
    """This rank's :class:`Grid` with ``n`` space shards (``n`` divides the
    world; 1: data-parallel). The columns' process groups are created on
    the first call for ``n``, by every rank: every rank must call it."""
    world, r = world_size(), rank()
    if world % n:
        raise ValueError(f"{world} ranks not divisible by SPATIAL_SHARDS={n}")
    column = None
    if 1 < n < world:
        if n not in _columns:
            _columns[n] = [dist.new_group(list(range(d * n, (d + 1) * n)))
                           for d in range(world // n)]
        column = _columns[n][r // n]
    return Grid(n, r % n, world // n, r // n, column)


def scene_grid(process_group=None) -> Grid:
    """The grid that splits one scene's height over every rank of
    ``process_group`` (default: the world), one data column
    (:func:`..evaluation.sharded_scene_probabilities`)."""
    if not initialized():
        return Grid(1, 0, 1, 0)
    return Grid(dist.get_world_size(process_group), dist.get_rank(process_group),
                1, 0, process_group)


def all_reduce_(tensor: torch.Tensor, process_group=None) -> torch.Tensor:
    """Sum ``tensor`` over the ranks of ``process_group`` (default: the
    world), in place, when the world has more than one rank; returns it."""
    if world_size() > 1:
        dist.all_reduce(tensor, group=process_group)
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


def global_rows(tensors, start: int, total: int, grid: Grid | None = None) -> list:
    """Global-shaped float32 copies of per-rank blocks: each tensor of
    ``tensors`` holds this rank's rows ``[start, start + k)`` of a global
    ``(total, ...)`` tensor; every rank fills its block of zeroed global
    buffers and one flat float32 all-reduce sums them (exactly: every
    element has one non-zero term). The results are detached and equal on
    every rank.

    On a ``grid`` of ``n > 1`` space shards a tensor of three or more
    dimensions holds this rank's height block ``[i·h, (i + 1)·h)`` of axis 2
    (``i`` its space index), and its global copy is ``n·h`` high; a tensor
    of fewer dimensions (a per-row label mask) is the same on every space
    rank of the column and is filled by space index 0 alone."""
    n = 1 if grid is None else grid.space_size
    shapes = [(total,) + tuple(t.shape[1:]) for t in tensors]
    if n > 1:
        shapes = [s[:2] + (n * s[2],) + s[3:] if len(s) >= 3 else s for s in shapes]
    sizes = [int(np.prod(s)) for s in shapes]
    flat = torch.zeros(sum(sizes), dtype=torch.float32, device=tensors[0].device)
    views, offset = [], 0
    for t, shape, size in zip(tensors, shapes, sizes):
        view = flat[offset:offset + size].view(shape)
        rows = view[start:start + t.shape[0]]
        if n > 1 and t.dim() >= 3:
            h0 = grid.space_index * t.shape[2]
            rows[:, :, h0:h0 + t.shape[2]] = t.detach()
        elif n == 1 or grid.space_index == 0:
            rows[...] = t.detach()
        views.append(view)
        offset += size
    all_reduce_(flat)
    return views
