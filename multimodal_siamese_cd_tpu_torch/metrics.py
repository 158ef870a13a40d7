"""Evaluation metrics (the JAX package's ``metrics.py``).

  * :class:`MultiThresholdMetric` — TP/TN/FP/FN per threshold accumulated
    over samples as float64 on the host. The reference's FP/FN formulas are
    swapped (its metrics.py:30-31 counts ``y_true & ~pred`` as FP); this
    uses the correct definitions, like the JAX package, so F1 matches the
    reference while precision and recall are swapped relative to its logs.
  * :func:`confusion_at_thresholds` — the plain PyTorch formula for one
    sample's counts; :mod:`.ops.confusion` holds the CUDA kernel that
    computes the same counts on the card.
  * :func:`strict_confusion_counts` and :func:`prob_metrics_from_counts` —
    the offline assessment's strict rule ``pred = p > thr`` (the reference's
    ``*_from_prob`` functions) and its pooled F1 / precision / recall; the
    kernel's strict variant computes the same counts on the card.
  * the reference's functional ``true_pos`` ... ``f1_score`` (torch) and
    its numpy ``*_from_prob`` functions over pooled probability arrays.

Thresholding replicates the reference's round-offset formulation
``round(y_pred - threshold + 0.5) >= 1`` (reference metrics.py:26) with
round-half-to-even at exact ties, as ``torch.round`` and ``jnp.round`` do.
"""

from __future__ import annotations

import numpy as np
import torch

CLAMP = 10e-05  # reference denominator clamp (metrics.py:39,49,65)


class MultiThresholdMetric:
    """Accumulates TP/TN/FP/FN per threshold across added samples. Totals
    are float64 on the host; the derived metrics compute in float32 from
    them, as the JAX package's do."""

    def __init__(self, thresholds):
        self._thresholds = np.asarray(thresholds, np.float32).reshape(-1)
        n = self._thresholds.shape[0]
        self.TP = np.zeros((n,), np.float64)
        self.TN = np.zeros((n,), np.float64)
        self.FP = np.zeros((n,), np.float64)
        self.FN = np.zeros((n,), np.float64)

    @property
    def thresholds(self) -> np.ndarray:
        return self._thresholds

    def add_sample(self, y_true: torch.Tensor, y_pred: torch.Tensor,
                   valid_mask: torch.Tensor | None = None) -> None:
        """Count one sample (tensors of any shape, flattened) through
        :func:`.ops.confusion.confusion_counts` — the kernel on the card,
        the plain formula on the CPU. ``y_true > 0.5`` is the truth;
        ``valid_mask`` is a {0,1} mask (nonzero counts as valid)."""
        from .ops.confusion import confusion_counts

        probs = y_pred.reshape(1, -1).float().contiguous()
        y = (y_true.reshape(1, -1) > 0.5).to(torch.uint8)
        if valid_mask is None:
            valid = torch.ones_like(y)
        else:
            valid = (valid_mask.reshape(1, -1) != 0).to(torch.uint8)
        thr = torch.as_tensor(self._thresholds, device=probs.device)
        counts = confusion_counts(probs, y, valid, thr)
        self.add_counts(*counts[0].cpu().numpy())

    def add_counts(self, tp, tn, fp, fn) -> None:
        """Accumulate per-threshold ``(n_thresholds,)`` counts in float64,
        exact past float32's 2^24 integer range."""
        self.TP = self.TP + np.asarray(tp, np.float64)
        self.TN = self.TN + np.asarray(tn, np.float64)
        self.FP = self.FP + np.asarray(fp, np.float64)
        self.FN = self.FN + np.asarray(fn, np.float64)

    @property
    def precision(self) -> np.ndarray:
        return (self.TP.astype(np.float32)
                / np.maximum((self.TP + self.FP).astype(np.float32),
                             np.float32(CLAMP)))

    @property
    def recall(self) -> np.ndarray:
        return (self.TP.astype(np.float32)
                / np.maximum((self.TP + self.FN).astype(np.float32),
                             np.float32(CLAMP)))

    def compute_basic_metrics(self):
        """False positive rate and false negative rate (metrics.py:53-62)."""
        false_pos_rate = self.FP / (self.FP + self.TN)
        false_neg_rate = self.FN / (self.FN + self.TP)
        return false_pos_rate, false_neg_rate

    def compute_f1(self) -> np.ndarray:
        p, r = self.precision, self.recall
        return np.float32(2) * p * r / np.maximum(p + r, np.float32(CLAMP))


def confusion_at_thresholds(y_true, y_pred, thresholds, valid_mask=None):
    """(TP, TN, FP, FN), each ``(n_thresholds,)`` float64, summed over all
    elements of one sample — the plain version of the confusion kernel.
    ``valid_mask`` may be any float weight; sums run in float64, so counts
    of a {0,1} mask are exact integers."""
    y_pred = torch.as_tensor(y_pred)
    t = torch.as_tensor(y_true, device=y_pred.device).reshape(1, -1) > 0.5
    p = y_pred.reshape(1, -1).float()
    thr = torch.as_tensor(thresholds, dtype=torch.float32,
                          device=p.device).reshape(-1, 1)
    pred = torch.round(p - thr + 0.5) >= 1.0
    if valid_mask is None:
        valid = torch.ones(t.shape, dtype=torch.float64, device=p.device)
    else:
        valid = torch.as_tensor(valid_mask, device=p.device).reshape(
            1, -1).double()
    tp = ((t & pred) * valid).sum(dim=1)
    tn = ((~t & ~pred) * valid).sum(dim=1)
    fp = ((~t & pred) * valid).sum(dim=1)
    fn = ((t & ~pred) * valid).sum(dim=1)
    return tp, tn, fp, fn


def strict_confusion_counts(y_true, y_prob, valid=None, threshold=0.5):
    """``(tp, fp, fn)`` float64 at one threshold with the strict rule
    ``pred = prob > threshold``, ``gt = label > 0.5`` (the JAX package's
    ``strict_confusion_counts``), summed over the valid pixels of one
    sample; ``valid`` is any float weight, None for all pixels."""
    y_prob = torch.as_tensor(y_prob)
    t = torch.as_tensor(y_true, device=y_prob.device).reshape(-1) > 0.5
    pred = y_prob.reshape(-1).float() > torch.tensor(
        threshold, dtype=torch.float32, device=y_prob.device)
    if valid is None:
        v = torch.ones(t.shape, dtype=torch.float64, device=y_prob.device)
    else:
        v = torch.as_tensor(valid, device=y_prob.device).reshape(-1).double()
    return (((t & pred) * v).sum(), ((~t & pred) * v).sum(),
            ((t & ~pred) * v).sum())


def prob_metrics_from_counts(tp, fp, fn):
    """``(f1, precision, recall)`` from pooled strict-threshold counts, with
    the reference's unclamped float64 divisions (the JAX package's
    ``prob_metrics_from_counts``)."""
    tp, fp, fn = (np.float64(v) for v in (tp, fp, fn))
    p = tp / (tp + fp)
    r = tp / (tp + fn)
    return 2 * (p * r) / (p + r), p, r


# --- functional rounded-probability metrics (reference metrics.py:69-113) ----

def true_pos(y_true, y_pred, dim=0):
    return torch.sum(y_true * torch.round(y_pred), dim=dim)


def false_pos(y_true, y_pred, dim=0):
    return torch.sum((1.0 - y_true) * torch.round(y_pred), dim=dim)


def false_neg(y_true, y_pred, dim=0):
    return torch.sum(y_true * (1.0 - torch.round(y_pred)), dim=dim)


def precision(y_true, y_pred, dim):
    tp = true_pos(y_true, y_pred, dim)
    fp = false_pos(y_true, y_pred, dim)
    return tp / torch.clamp(tp + fp, min=CLAMP)


def recall(y_true, y_pred, dim):
    tp = true_pos(y_true, y_pred, dim)
    fn = false_neg(y_true, y_pred, dim)
    return tp / torch.clamp(tp + fn, min=CLAMP)


def f1_score(gts, preds, multi_threshold_mode: bool = False, dim=(-1, -2),
             **legacy):
    """F1 of rounded probabilities over ``dim`` in float32; accepts the
    reference API's misspelled ``multi_threashold_mode`` keyword
    (utils/metrics.py:97)."""
    multi_threshold_mode = legacy.pop("multi_threashold_mode",
                                      multi_threshold_mode)
    if legacy:
        raise TypeError(f"unexpected keyword arguments: {sorted(legacy)}")
    gts = torch.as_tensor(gts, dtype=torch.float32)
    preds = torch.as_tensor(preds, dtype=torch.float32)
    if multi_threshold_mode:
        gts = torch.broadcast_to(gts[:, None, ...], preds.shape)
    r = recall(gts, preds, dim)
    p = precision(gts, preds, dim)
    return 2.0 * r * p / torch.clamp(r + p, min=CLAMP)


# --- numpy probability metrics for offline assessment ------------------------
# (reference metrics.py:116-150); the cache-disabled path of the dual-task
# assessment pools every scene's probabilities through them

def true_positives_from_prob(y_prob: np.ndarray, y_true: np.ndarray,
                             threshold: float = 0.5):
    y_pred = y_prob > threshold
    return np.sum(np.logical_and(y_pred, y_true))


def false_positives_from_prob(y_prob: np.ndarray, y_true: np.ndarray,
                              threshold: float = 0.5):
    y_pred = y_prob > threshold
    return np.sum(np.logical_and(y_pred, np.logical_not(y_true)))


def false_negatives_from_prob(y_prob: np.ndarray, y_true: np.ndarray,
                              threshold: float = 0.5):
    y_pred = y_prob > threshold
    return np.sum(np.logical_and(np.logical_not(y_pred), y_true))


def precision_from_prob(y_prob: np.ndarray, y_true: np.ndarray,
                        threshold: float = 0.5):
    tp = true_positives_from_prob(y_prob, y_true, threshold)
    fp = false_positives_from_prob(y_prob, y_true, threshold)
    return tp / (tp + fp)


# The reference spells it 'precsision_from_prob' (metrics.py:137); the alias
# keeps code written against the reference API working.
precsision_from_prob = precision_from_prob


def recall_from_prob(y_prob: np.ndarray, y_true: np.ndarray,
                     threshold: float = 0.5):
    tp = true_positives_from_prob(y_prob, y_true, threshold)
    fn = false_negatives_from_prob(y_prob, y_true, threshold)
    return tp / (tp + fn)


def f1_score_from_prob(y_prob: np.ndarray, y_true: np.ndarray,
                       threshold: float = 0.5):
    p = precision_from_prob(y_prob, y_true, threshold)
    r = recall_from_prob(y_prob, y_true, threshold)
    return 2 * (p * r) / (p + r)


def root_mean_square_error(y_pred: np.ndarray, y_true: np.ndarray):
    return np.sqrt(np.sum(np.square(y_pred - y_true)) / np.size(y_true))
