"""Evaluation metrics (the JAX package's ``metrics.py:28-109, 206-232``).

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
