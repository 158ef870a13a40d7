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
``bn_stats(dy, x)``; on the card both launch the CUDA kernel. A module
called twice in one step (the Siamese encoder runs on both dates) updates
its running statistics twice, in call order, as flax does. While
``recomputing`` is set (the backward's second forward of a checkpointed
stage, ``MODEL.REMAT``) the module normalises as before but leaves
``running_mean``, ``running_var`` and ``num_batches_tracked`` alone, so a
step moves them once, as the plain step does.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.bn_stats import bn_stats


def _per_channel(v: torch.Tensor) -> torch.Tensor:
    return v[None, :, None, None]


class _TrainBatchNorm(torch.autograd.Function):
    """Batch-statistics normalisation; saves the input (not the output), so
    the ReLU after it may run in place."""

    @staticmethod
    @torch.amp.custom_fwd(device_type="cuda")
    def forward(ctx, x, weight, bias, running_mean, running_var, momentum, eps):
        """``running_mean`` / ``running_var`` None: no running update."""
        x = x.contiguous()
        n = x.numel() // x.shape[1]
        s1, s2 = bn_stats(x, x)
        mean = s1 / n
        var = torch.clamp_min(s2 / n - mean * mean, 0.0)
        rstd = torch.rsqrt(var + eps)
        y = x.to(torch.float32, copy=True)
        y.sub_(_per_channel(mean)).mul_(_per_channel(rstd * weight))
        y.add_(_per_channel(bias))
        if running_mean is not None:
            with torch.no_grad():
                running_mean.mul_(1.0 - momentum).add_(mean, alpha=momentum)
                running_var.mul_(1.0 - momentum).add_(var, alpha=momentum)
        ctx.save_for_backward(x, weight, mean, rstd)
        ctx.n = n
        return y.to(x.dtype)

    @staticmethod
    @torch.amp.custom_bwd(device_type="cuda")
    def backward(ctx, dy):
        x, weight, mean, rstd = ctx.saved_tensors
        n = ctx.n
        dy = dy.contiguous()
        s1, s2 = bn_stats(dy, x)
        dbias = s1
        dweight = rstd * (s2 - mean * s1)
        # dx = weight·rstd·(dy - Σdy/N - x̂·dweight/N), x̂ = (x - mean)·rstd
        t = x.to(torch.float32, copy=True)
        t.sub_(_per_channel(mean)).mul_(_per_channel(rstd * dweight / n))
        dx = dy.to(torch.float32, copy=True)
        dx.sub_(_per_channel(s1 / n)).sub_(t).mul_(_per_channel(weight * rstd))
        return dx.to(dy.dtype), dweight, dbias, None, None, None, None


class BatchNorm2d(nn.Module):
    """``nn.BatchNorm2d(num_features, eps, momentum)`` with flax's training
    semantics (module docstring). ``momentum`` is torch's: the weight of
    the new batch statistic (0.1 == flax momentum 0.9)."""

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

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0, self.eps)
        if self.recomputing:
            return _TrainBatchNorm.apply(x, self.weight, self.bias, None, None,
                                         self.momentum, self.eps)
        self.num_batches_tracked.add_(1)
        return _TrainBatchNorm.apply(x, self.weight, self.bias,
                                     self.running_mean, self.running_var,
                                     self.momentum, self.eps)
