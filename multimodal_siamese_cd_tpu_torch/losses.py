"""Segmentation loss functions (the JAX package's ``losses.py``, NCHW).

Same registry strings and formulas as the reference
(utils/loss_functions.py:6-198) and the JAX package: every criterion takes
an optional per-sample ``mask`` over the leading (batch) axis with values
in {0, 1} and reduces through masked sums, which is numerically identical
to the reference's row selection ``logits[is_labeled]`` for these ratio
losses.

All criteria take logits and apply the sigmoid inside, except the MSE /
'L2' criterion, which is applied to whatever it is given (the consistency
trainer feeds it probabilities). Multi-class criteria take the softmax over
the channel axis, dim 1 (the JAX package is NHWC and uses the last axis).
"""

from __future__ import annotations

import torch

EPS = 1e-6


def _expand(mask: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``mask`` over the leading axes of ``like``, broadcast over the rest,
    in ``like``'s dtype."""
    return mask.reshape(mask.shape + (1,) * (like.dim() - mask.dim())).to(like.dtype)


def _flat_masked(y: torch.Tensor, mask: torch.Tensor | None) -> torch.Tensor:
    """Flatten; if mask given, zero out unselected samples."""
    if mask is None:
        return y.reshape(-1)
    return (y * _expand(mask, y)).reshape(-1)


def _mask_count(shape, mask, device) -> torch.Tensor:
    """Number of selected elements (for mean-type losses) on ``device``:
    each mask entry counts the elements of the axes it does not span. The
    count is made on the device, not copied there from the host, so a step
    captured as a CUDA graph holds it."""
    per_entry = 1
    if mask is None:
        for d in shape:
            per_entry *= d
        return torch.full((), float(per_entry), device=device)
    for d in shape[mask.dim():]:
        per_entry *= d
    return mask.to(torch.float32).sum() * per_entry


# --- binary criteria (sigmoid inside) ----------------------------------------

def bce_with_logits_loss(y_logit, y_true, mask=None):
    """Mean binary cross entropy on logits (torch BCEWithLogitsLoss parity),
    in the stable form max(x, 0) - x·z + log1p(exp(-|x|))."""
    x, z = y_logit, y_true
    elem = torch.clamp_min(x, 0) - x * z + torch.log1p(torch.exp(-x.abs()))
    elem = _flat_masked(elem, mask)
    count = _mask_count(y_logit.shape, mask, elem.device)
    return elem.sum() / torch.clamp_min(count, 1.0)


def soft_dice_loss(y_logit, y_true, mask=None):
    """reference loss_functions.py:36-44."""
    p = _flat_masked(torch.sigmoid(y_logit), mask)
    t = _flat_masked(y_true, mask)
    intersection = (p * t).sum()
    return 1.0 - (2.0 * intersection + EPS) / (p.sum() + t.sum() + EPS)


def soft_dice_squared_sum_loss(y_logit, y_true, mask=None):
    """reference loss_functions.py:48-56 — author-flagged as broken and
    identical to soft_dice_loss; the identity is kept for parity."""
    return soft_dice_loss(y_logit, y_true, mask)


def jaccard_like_loss(y_logit, y_true, mask=None):
    """reference loss_functions.py:117-126."""
    p = _flat_masked(torch.sigmoid(y_logit), mask)
    t = _flat_masked(y_true, mask)
    intersection = (p * t).sum()
    denom = (p * p).sum() + (t * t).sum() - intersection + EPS
    return 1.0 - (2.0 * intersection) / denom


def dice_like_loss(y_logit, y_true, mask=None):
    """reference loss_functions.py:129-138."""
    p = _flat_masked(torch.sigmoid(y_logit), mask)
    t = _flat_masked(y_true, mask)
    intersection = (p * t).sum()
    denom = (p * p).sum() + (t * t).sum() + EPS
    return 1.0 - (2.0 * intersection) / denom


def power_jaccard_loss(y_logit, y_true, mask=None):
    """The default training loss (reference loss_functions.py:141-150;
    base.yaml MODEL.LOSS_TYPE)."""
    p = _flat_masked(torch.sigmoid(y_logit), mask)
    t = _flat_masked(y_true, mask)
    intersection = (p * t).sum()
    denom = (p * p).sum() + (t * t).sum() - intersection + EPS
    return 1.0 - intersection / denom


def iou_loss(y_logit, y_true, mask=None):
    """reference loss_functions.py:153-162."""
    p = _flat_masked(torch.sigmoid(y_logit), mask)
    t = _flat_masked(y_true, mask)
    intersection = (p * t).sum()
    union = p.sum() + t.sum() - intersection + EPS
    return 1.0 - intersection / union


def jaccard_like_balanced_loss(y_logit, y_true, mask=None):
    """reference loss_functions.py:165-181. With masking, the negative term
    treats unselected elements as (1-p) = (1-t) = 0, matching row
    selection."""
    p = _flat_masked(torch.sigmoid(y_logit), mask)
    t = _flat_masked(y_true, mask)
    one = _flat_masked(torch.ones_like(y_true), mask)
    intersection = (p * t).sum()
    denom = (p * p).sum() + (t * t).sum() - intersection + EPS
    piccard = 2.0 * intersection / denom
    np_, nt = one - p, one - t
    neg_intersection = (np_ * nt).sum()
    neg_denom = (np_ * np_).sum() + (nt * nt).sum() - neg_intersection
    n_piccard = 2.0 * neg_intersection / neg_denom
    return 1.0 - piccard - n_piccard


def soft_dice_loss_balanced(y_logit, y_true, mask=None):
    """reference loss_functions.py:184-198."""
    p = _flat_masked(torch.sigmoid(y_logit), mask)
    t = _flat_masked(y_true, mask)
    one = _flat_masked(torch.ones_like(y_true), mask)
    intersection = (p * t).sum()
    dice_pos = 2.0 * intersection / (p.sum() + t.sum() + EPS)
    neg_intersection = ((one - p) * (one - t)).sum()
    dice_neg = 2.0 * neg_intersection / ((one - p).sum() + (one - t).sum() + EPS)
    return 1.0 - dice_pos - dice_neg


def mean_square_error_loss(y_pred, y_true, mask=None):
    """torch nn.MSELoss parity ('MeanSquareErrorLoss' and 'L2' registry keys,
    reference loss_functions.py:22-29). Applied to inputs as they are (no
    sigmoid)."""
    d = _flat_masked((y_pred - y_true) ** 2, mask)
    count = _mask_count(y_pred.shape, mask, d.device)
    return d.sum() / torch.clamp_min(count, 1.0)


# --- multi-class criteria (softmax over the channel axis, dim 1) -------------

def _sum_dims(y_logit) -> tuple:
    return (0,) + tuple(range(2, y_logit.dim()))


def cross_entropy_loss(y_logit, y_true, mask=None,
                       negative_weight: float = 1.0, positive_weight: float = 1.0):
    """Weighted multi-class cross entropy (torch nn.CrossEntropyLoss parity,
    reference loss_functions.py:9-13). ``y_logit``: (B, C, ...);
    ``y_true``: integer class indices (B, ...) or a (B, 1, ...) label plane.
    Weighted mean as torch: Σ w[t]·nll / Σ w[t]."""
    n_cls = y_logit.shape[1]
    if n_cls < 2:
        raise ValueError(
            "CrossEntropyLoss needs multi-class logits (C >= 2, got "
            f"{n_cls}); the binary change heads use BCEWithLogitsLoss / "
            "the Jaccard-family losses")
    weights = torch.ones(n_cls, dtype=y_logit.dtype, device=y_logit.device)
    weights[0], weights[1] = negative_weight, positive_weight
    logp = torch.log_softmax(y_logit, dim=1)
    if y_true.dim() == y_logit.dim() and y_true.shape[1] == 1:
        y_true = y_true[:, 0]  # accept the trainers' (B, 1, ...) label plane
    y_idx = y_true.to(torch.int64)
    nll = -torch.gather(logp, 1, y_idx[:, None])[:, 0]
    w = weights[y_idx]
    if mask is not None:
        w = w * _expand(mask, nll)
    return (w * nll).sum() / torch.clamp_min(w.sum(), EPS)


def _softmax_masked(y_logit, y_true, mask):
    p = torch.softmax(y_logit, dim=1)
    if mask is not None:
        m = _expand(mask, p)
        p, y_true = p * m, y_true * m
    return p, y_true


def _soft_dice_multi_class_terms(y_logit, y_true, mask):
    """Per-class dice terms shared by the two multi-class dice losses."""
    p, y_true = _softmax_masked(y_logit, y_true, mask)
    dims = _sum_dims(y_logit)
    intersection = (y_true * p).sum(dim=dims)
    denom = torch.clamp_min(y_true.sum(dim=dims) + p.sum(dim=dims), EPS)
    return 2.0 * intersection / denom


def soft_dice_loss_multi_class(y_logit, y_true, mask=None):
    """reference loss_functions.py:59-69 (sums over batch and space)."""
    return 1.0 - _soft_dice_multi_class_terms(y_logit, y_true, mask).mean()


def soft_dice_loss_multi_class_debug(y_logit, y_true, mask=None):
    """reference loss_functions.py:72-83 — also returns per-class terms."""
    dice = _soft_dice_multi_class_terms(y_logit, y_true, mask)
    return 1.0 - dice.mean(), 1.0 - dice


def generalized_soft_dice_loss_multi_class(y_logit, y_true, mask=None):
    """reference loss_functions.py:86-99."""
    p, y_true = _softmax_masked(y_logit, y_true, mask)
    dims = _sum_dims(y_logit)
    ysum = y_true.sum(dim=dims)
    wc = 1.0 / (ysum ** 2 + 1e-12)
    intersection = ((y_true * p).sum(dim=dims) * wc).sum()
    denom = ((ysum + p.sum(dim=dims)) * wc).sum()
    return 1.0 - 2.0 * intersection / denom


def jaccard_like_loss_multi_class(y_logit, y_true, mask=None):
    """reference loss_functions.py:102-114."""
    p, y_true = _softmax_masked(y_logit, y_true, mask)
    dims = _sum_dims(y_logit)
    intersection = (y_true * p).sum(dim=dims)
    denom = ((y_true ** 2 + p ** 2).sum(dim=dims)
             + (y_true * p).sum(dim=dims) + EPS)
    return 1.0 - (2.0 * intersection / denom).mean()


# --- registry -----------------------------------------------------------------

def get_criterion(loss_type: str, negative_weight: float = 1.0,
                  positive_weight: float = 1.0):
    """Loss registry keyed by the reference's config strings
    (loss_functions.py:6-33)."""
    if loss_type == 'BCEWithLogitsLoss':
        return bce_with_logits_loss
    if loss_type == 'CrossEntropyLoss':
        def weighted_ce(y_logit, y_true, mask=None):
            return cross_entropy_loss(y_logit, y_true, mask,
                                      negative_weight, positive_weight)
        return weighted_ce
    if loss_type == 'SoftDiceLoss':
        return soft_dice_loss
    if loss_type == 'SoftDiceSquaredSumLoss':
        return soft_dice_squared_sum_loss
    if loss_type == 'SoftDiceBalancedLoss':
        return soft_dice_loss_balanced
    if loss_type == 'PowerJaccardLoss':
        return power_jaccard_loss
    if loss_type in ('MeanSquareErrorLoss', 'L2'):
        return mean_square_error_loss
    if loss_type == 'IoULoss':
        return iou_loss
    if loss_type == 'DiceLikeLoss':
        return dice_like_loss
    raise Exception(f'unknown loss {loss_type}')
