"""BatchNorm2d with flax's training semantics, its statistics through the
``bn_stats`` kernel.

The counterpart of the JAX package's ``nn.BatchNorm(momentum=0.9,
epsilon=1e-5)`` (``models/blocks.py`` DoubleConv). Parameter and buffer
names are ``nn.BatchNorm2d``'s (``weight``, ``bias``, ``running_mean``,
``running_var``, ``num_batches_tracked``), so the reference ``state_dict``
grammar and :func:`..weights.state_dict_from_jax` are unchanged.

* Eval mode is ``F.batch_norm`` over the running statistics, exactly what
  ``nn.BatchNorm2d`` does.
* Train mode differs from ``nn.BatchNorm2d`` where flax does: the running
  variance is updated with the BIASED batch variance (flax
  ``normalization.py``: ``ra_var = momentum * ra_var + (1 - momentum) *
  var``), where torch uses the unbiased one, n / (n - 1) larger. The batch
  statistics are flax's fast variance: ``mean = Σx / N``, ``var = max(0,
  Σx² / N - mean²)``, N = B·H·W, in float32 whatever the input dtype; the
  output is ``(x - mean) · (rsqrt(var + eps) · weight) + bias`` in that
  order, cast to the input dtype.

The forward sums come from ``bn_stats(x, x)``, the backward's from
``bn_stats(dy, x)``; the per-element work, the normalisation and ``dx``,
from ``batch_norm_apply`` and ``batch_norm_dx`` (:mod:`..ops.batch_norm`)
over per-channel vectors computed here. On the card all three launch their
CUDA kernels, one launch of each kernel per call. The module keeps its
input's layout (:mod:`..ops.layout`): an input dense in NCHW or in
channels-last (the training step's layout on the card) is normalised in
that layout, through the kernels of that layout, and its gradient is made
dense in it too; a view dense in neither is first copied to NCHW.
Each copy of ``x`` or ``dy`` that this makes is counted in
``BatchNorm2d.layout_copies``: 0 in a step whose activations are all in
one layout. A module
called twice in one step (the Siamese encoder runs on both dates) updates
its running statistics twice, in call order, as flax does. While
``recomputing`` is set (the backward's second forward of a checkpointed
stage, ``MODEL.REMAT``) the module normalises as before but leaves
``running_mean``, ``running_var`` and ``num_batches_tracked`` alone, so a
step moves them once, as the plain step does.

Sync-BN (``sync``, the default, as ``MODEL.SYNC_BN: True`` in the JAX
package): in a world of more than one rank (:mod:`..parallel`) the
forward's ``(Σx, Σx²)`` and the backward's ``(Σdy, Σdy·x)`` are summed over
the ranks, each as one flat ``2C`` float32 all-reduce, and N is the global
count (every rank holds an equal share of the batch, so N is the world
size times the local count). Mean, variance, running statistics and
``dx`` then follow the formulas above over the global batch; the weight
and bias gradients stay the rank's own share, which the step's gradient
all-reduce sums. Under ``MODEL.REMAT`` the recompute runs the forward's
all-reduce again, in the same order on every rank. With ``sync`` off each
rank normalises over its own rows and nothing is reduced.

On a height-sharded level (``TRAINER.SPATIAL_SHARDS``,
:mod:`..parallel.halo`) every rank holds an equal (rows × height) share:
sync-BN reduces over the world as above, and with ``sync`` off the sums
are reduced over the rank's data column (its space ranks share the
statistics, as the JAX package's ``bn_group_count`` groups by the data
axis), N the local count times the column's size. On a level the space
ranks compute redundantly (whole on each) the forward's sums come from
space index 0 alone (N counts the data columns, or the column alone
without ``sync``), so nothing is counted ``n`` times; each space rank's
backward holds its own part of the gradient, which the reduction sums,
and the sums are divided by the ``n`` copies, so the parts of ``dx`` add
up to the gradient of the whole.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import layout
from ..ops.batch_norm import batch_norm_apply, batch_norm_dx
from ..ops.bn_stats import bn_stats
from ..parallel import group, halo


class _TrainBatchNorm(torch.autograd.Function):
    """Batch-statistics normalisation; saves the input (not the output), so
    the ReLU after it may run in place."""

    @staticmethod
    @torch.amp.custom_fwd(device_type="cuda")
    def forward(ctx, x, weight, bias, running_mean, running_var, momentum, eps,
                reduce):
        """``running_mean`` / ``running_var`` None: no running update;
        ``reduce``: None, or how the statistics are summed over the ranks
        (:func:`_reduction`)."""
        x = _dense(x, layout.memory_format(x))
        n = x.numel() // x.shape[1]
        s1, s2 = bn_stats(x, x)
        if reduce is not None:
            process_group, count, contributes, _ = reduce
            if not contributes:
                s1, s2 = torch.zeros_like(s1), torch.zeros_like(s2)
            s1, s2 = _summed_over_ranks(s1, s2, process_group)
            n *= count
        mean = s1 / n
        var = torch.clamp_min(s2 / n - mean * mean, 0.0)
        rstd = torch.rsqrt(var + eps)
        y = batch_norm_apply(x, mean, rstd * weight, bias)
        if running_mean is not None:
            with torch.no_grad():
                running_mean.mul_(1.0 - momentum).add_(mean, alpha=momentum)
                running_var.mul_(1.0 - momentum).add_(var, alpha=momentum)
        ctx.save_for_backward(x, weight, mean, rstd)
        ctx.n = n
        ctx.reduce = reduce
        return y

    @staticmethod
    @torch.amp.custom_bwd(device_type="cuda")
    def backward(ctx, dy):
        x, weight, mean, rstd = ctx.saved_tensors
        n = ctx.n
        dy = _dense(dy, layout.memory_format(x))
        s1, s2 = bn_stats(dy, x)
        dbias = s1
        dweight = rstd * (s2 - mean * s1)
        if ctx.reduce is not None:  # this rank's dweight, dbias; dx needs the
            process_group, _, _, copies = ctx.reduce    # global sums
            s1, s2 = _summed_over_ranks(s1, s2, process_group)
            if copies > 1:
                s1, s2 = s1 / copies, s2 / copies
            dw_all = rstd * (s2 - mean * s1)
        else:
            dw_all = dweight
        # dx = weight·rstd·(dy - Σdy/N - x̂·dweight/N), x̂ = (x - mean)·rstd
        dx = batch_norm_dx(dy, x, mean, rstd * dw_all / n, s1 / n, weight * rstd)
        return dx, dweight, dbias, None, None, None, None, None


def _dense(t: torch.Tensor, memory_format) -> torch.Tensor:
    """``t`` dense in ``memory_format``, counting a copy in
    ``BatchNorm2d.layout_copies``."""
    if t.is_contiguous(memory_format=memory_format):
        return t
    BatchNorm2d.layout_copies += 1
    return t.contiguous(memory_format=memory_format)


def _summed_over_ranks(s1: torch.Tensor, s2: torch.Tensor, process_group=None):
    """``(s1, s2)`` summed over the ranks of ``process_group`` (default: the
    world) through one flat ``2C`` float32 all-reduce."""
    flat = group.all_reduce_(torch.cat([s1, s2]), process_group)
    return flat[:s1.numel()], flat[s1.numel():]


def _reduction(sync: bool):
    """How a train-mode BatchNorm sums its statistics over the ranks:
    None (not at all), or ``(process group, N factor, this rank's forward
    sums count, copies of the backward's)`` (module docstring)."""
    world = group.world_size()
    grid = halo.active()
    if grid is None:
        return (None, world, True, 1) if sync and world > 1 else None
    process_group = None if sync else grid.column
    if halo.sharded():
        return process_group, world if sync else grid.space_size, True, 1
    return (process_group, grid.data_size if sync else 1, grid.space_index == 0,
            grid.space_size)


class BatchNorm2d(nn.Module):
    """``nn.BatchNorm2d(num_features, eps, momentum)`` with flax's training
    semantics (module docstring). ``momentum`` is torch's: the weight of
    the new batch statistic (0.1 == flax momentum 0.9). ``sync`` (default
    True; the factory sets ``MODEL.SYNC_BN``) reduces the statistics over
    the ranks of a multi-process world. ``BatchNorm2d.layout_copies``
    counts the copies train mode made to bring an input or its gradient
    into one layout (module docstring)."""

    layout_copies = 0

    def __init__(self, num_features: int, eps: float = 1e-5,
                 momentum: float = 0.1):
        super().__init__()
        self.num_features = num_features
        self.eps = eps
        self.momentum = momentum
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))
        self.register_buffer("num_batches_tracked",
                             torch.tensor(0, dtype=torch.long))
        self.recomputing = False
        self.sync = True

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0, self.eps)
        reduce = _reduction(self.sync)
        if self.recomputing:
            return _TrainBatchNorm.apply(x, self.weight, self.bias, None, None,
                                         self.momentum, self.eps, reduce)
        self.num_batches_tracked.add_(1)
        return _TrainBatchNorm.apply(x, self.weight, self.bias,
                                     self.running_mean, self.running_var,
                                     self.momentum, self.eps, reduce)
