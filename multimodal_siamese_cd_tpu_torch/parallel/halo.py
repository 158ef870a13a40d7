"""Height sharding over the space ranks of a :class:`.group.Grid`: the halo
exchange, and the sharding context the models read.

The JAX package shards the wire stack's height over its mesh's ``space``
axis and lets GSPMD insert the convolutions' halo exchanges and the
cross-shard reductions (parallel/mesh.py ``wire_sharding``, train_lib.py
``_jit_step``). The port makes them itself, with the collectives it limits
itself to (:mod:`.group`): each exchange is one all-reduce over the data
column's process group of a zeroed buffer that every space rank fills with
its own rows, exact because every element has one non-zero term.

The context (:func:`height_sharded`) is set by whoever runs a model on a
rank's rows of a height-sharded batch — the train step around the forward
and the backward (``MODEL.REMAT``'s recompute runs in the backward), the
grid evaluations around their forwards. Inside it the model's stages
declare the pyramid level they compute (:func:`level`); a level is sharded
while the rank's rows at level 0 halve evenly down to it
(:func:`sharded`). From the first level whose rows cannot pool evenly the
encoder makes its input whole on every space rank (:func:`whole`) and
computes the deeper levels redundantly; the decoder takes its rows back
(:func:`own_rows`) where it meets the first sharded skip. The layers read
the context at call time: a 3x3 convolution attaches a halo of one row of
each neighbour (zeros at the scene's top and bottom, the convolution's
zero padding) and convolves with height padding 0; BatchNorm reduces its
sums over the ranks that share them (:mod:`..models.batchnorm`). Without
the context every layer is the unsharded one.
"""

from __future__ import annotations

import contextlib

import torch
import torch.distributed as dist

from .group import Grid

# the active context: the grid, the rank's rows at level 0, the level the
# running stage computes (module state, not thread-local: on the card the
# backward, and REMAT's recompute in it, runs on autograd's device thread)
_grid: Grid | None = None
_rows = 0
_level = 0


@contextlib.contextmanager
def height_sharded(grid: Grid | None, rows: int):
    """Run the model on this rank's ``rows`` rows of level 0 of a map whose
    height is split over ``grid``'s space ranks; a grid of one space shard
    (or None) is the unsharded model."""
    global _grid, _rows, _level
    saved = _grid, _rows, _level
    if grid is not None and grid.space_size > 1:
        _grid, _rows, _level = grid, int(rows), 0
    try:
        yield
    finally:
        _grid, _rows, _level = saved


def active() -> Grid | None:
    """The grid of the active context, or None."""
    return _grid


@contextlib.contextmanager
def level(k: int):
    """The running stage computes pyramid level ``k`` (``k`` poolings below
    the input)."""
    global _level
    saved = _level
    _level = k
    try:
        yield
    finally:
        _level = saved


def sharded(k: int | None = None) -> bool:
    """Whether level ``k`` (default: the running stage's) is height-sharded:
    a context is active and the rank's rows at level 0 halve evenly ``k``
    times. Every deeper level of an unsharded one is unsharded."""
    if _grid is None:
        return False
    k = _level if k is None else k
    return _rows % (1 << k) == 0


def exchange_(buf: torch.Tensor, process_group) -> None:
    """The all-reduce of every halo exchange and :func:`whole` (one name, so
    an instrumented run can time them apart from the other all-reduces)."""
    dist.all_reduce(buf, group=process_group)


def _buffer_dtype(dtype: torch.dtype) -> torch.dtype:
    # float32 for the half types (exact for them); float64 stays float64
    return torch.promote_types(dtype, torch.float32)


class _Halo(torch.autograd.Function):
    """``x`` (this rank's rows of a height-sharded NCHW map) with ``top``
    rows of the space rank above attached on top and ``bottom`` rows of the
    one below at the bottom; zeros beyond the first and last space rank."""

    @staticmethod
    def forward(ctx, x, top: int, bottom: int, grid: Grid):
        ctx.top, ctx.bottom, ctx.grid = top, bottom, grid
        n, i, h = grid.space_size, grid.space_index, x.shape[2]
        k = max(top, bottom)
        if h < k:
            raise ValueError(f"a halo of {k} rows needs at least {k} rows per "
                             f"space rank, this rank holds {h}")
        # slot 0: my first rows (the halo of the rank above), slot 1: my last
        # rows, right-aligned (the halo of the rank below)
        buf = x.new_zeros((n, 2) + x.shape[:2] + (k, x.shape[3]),
                          dtype=_buffer_dtype(x.dtype))
        buf[i, 0, :, :, :bottom] = x[:, :, :bottom]
        buf[i, 1, :, :, k - top:] = x[:, :, h - top:]
        exchange_(buf, grid.column)
        parts = []
        if top:
            parts.append(buf[i - 1, 1, :, :, k - top:] if i > 0
                         else buf.new_zeros(x.shape[:2] + (top, x.shape[3])))
        parts.append(x)
        if bottom:
            parts.append(buf[i + 1, 0, :, :, :bottom] if i < n - 1
                         else buf.new_zeros(x.shape[:2] + (bottom, x.shape[3])))
        return torch.cat([p.to(x.dtype) for p in parts], dim=2)

    @staticmethod
    def backward(ctx, g):
        """The adjoint: the gradient of the attached rows goes back to the
        neighbour they came from and is added into its edge rows."""
        top, bottom, grid = ctx.top, ctx.bottom, ctx.grid
        n, i = grid.space_size, grid.space_index
        h = g.shape[2] - top - bottom
        k = max(top, bottom)
        buf = g.new_zeros((n, 2) + g.shape[:2] + (k, g.shape[3]),
                          dtype=_buffer_dtype(g.dtype))
        buf[i, 0, :, :, :top] = g[:, :, :top]
        buf[i, 1, :, :, :bottom] = g[:, :, top + h:]
        exchange_(buf, grid.column)
        dx = g[:, :, top:top + h].to(buf.dtype, copy=True)
        if top and i < n - 1:       # the rank below's top halo: my last rows
            dx[:, :, h - top:] += buf[i + 1, 0, :, :, :top]
        if bottom and i > 0:        # the rank above's bottom halo: my first rows
            dx[:, :, :bottom] += buf[i - 1, 1, :, :, :bottom]
        return dx.to(g.dtype), None, None, None


def halo(x: torch.Tensor, top: int, bottom: int) -> torch.Tensor:
    """:class:`_Halo` over the active context's space ranks (the identity
    without rows to attach)."""
    if not top and not bottom:
        return x
    return _Halo.apply(x, top, bottom, _grid)


class _Whole(torch.autograd.Function):
    """The whole height of a map whose rows are split evenly over the space
    ranks, on every space rank; the backward sums the gradients of the
    copies over the space ranks and keeps this rank's rows."""

    @staticmethod
    def forward(ctx, x, grid: Grid):
        ctx.grid = grid
        n, i, h = grid.space_size, grid.space_index, x.shape[2]
        buf = x.new_zeros(x.shape[:2] + (n * h, x.shape[3]),
                          dtype=_buffer_dtype(x.dtype))
        buf[:, :, i * h:(i + 1) * h] = x
        exchange_(buf, grid.column)
        return buf.to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        grid = ctx.grid
        h = g.shape[2] // grid.space_size
        buf = g.to(_buffer_dtype(g.dtype), copy=True).contiguous()
        exchange_(buf, grid.column)
        i = grid.space_index
        return buf[:, :, i * h:(i + 1) * h].to(g.dtype), None


def whole(x: torch.Tensor, grid: Grid | None = None) -> torch.Tensor:
    """:class:`_Whole` over ``grid`` (default: the active context's)."""
    return _Whole.apply(x, _grid if grid is None else grid)


def own_rows(x: torch.Tensor) -> torch.Tensor:
    """This rank's rows of a map that every space rank holds whole."""
    n, i = _grid.space_size, _grid.space_index
    h = x.shape[2] // n
    return x[:, :, i * h:(i + 1) * h]
