"""Augmentations: the host-side crop choice and the device-side batch graph
(the JAX package's ``data/augmentations.py``).

* Host (numpy): :func:`choose_crop_offset`, the uniform or importance crop
  the training dataset draws from each sample's generator. ImportanceRandom
  Crop scores 20 candidate windows by their change-label sums and picks one
  with probability proportional to (sum + 5) (reference
  augmentations.py:107-142).
* Device (torch, NCHW): per-sample flips, rot90, color shift and gamma over
  a whole batch, in the compute dtype. The decisions are drawn by
  :func:`draw_augmentation` from a ``torch.Generator`` and applied by
  :func:`apply_augmentation`, so a test can feed both this package and the
  JAX package's ``device_augment_batch`` the same decisions.

Geometric ops apply to all channels jointly (labels move with the
imagery); photometric ops apply to the imagery channels only.
"""

from __future__ import annotations

import numpy as np
import torch

IMPORTANCE_SAMPLE_SIZE = 20   # reference augmentations.py:132
IMPORTANCE_BALANCING = 5      # reference augmentations.py:133


def choose_crop_offset(label2d, height: int, width: int, crop_size: int,
                       rng: np.random.Generator, importance: bool,
                       window_count=None) -> tuple[int, int]:
    """Pick a crop origin: uniform, or importance-weighted by change-label
    window sums. ``window_count(y, x, s)`` — the positive-pixel count of the
    window at ``(y, x)`` — may replace ``label2d``, so callers score the 20
    candidates without a full-scene label plane. The draw order and weights
    are the JAX package's, so one generator gives one crop in both."""
    limit_y = max(1, height - crop_size)
    limit_x = max(1, width - crop_size)
    if not importance or (label2d is None and window_count is None):
        return int(rng.integers(0, limit_y)), int(rng.integers(0, limit_x))
    ys = rng.integers(0, limit_y, size=IMPORTANCE_SAMPLE_SIZE)
    xs = rng.integers(0, limit_x, size=IMPORTANCE_SAMPLE_SIZE)
    s = min(crop_size, height, width)
    if window_count is None:
        def window_count(y, x, s):
            return np.count_nonzero(label2d[y:y + s, x:x + s])
    sums = np.array([window_count(y, x, s)
                     for y, x in zip(ys, xs)], np.float64)
    weights = sums + IMPORTANCE_BALANCING
    weights /= weights.sum()
    idx = rng.choice(IMPORTANCE_SAMPLE_SIZE, p=weights)
    return int(ys[idx]), int(xs[idx])


def draw_augmentation(batch: int, n_img_channels: int, *, flip: bool,
                      rotate: bool, color_shift: bool, gamma: bool,
                      generator: torch.Generator, dtype: torch.dtype,
                      device) -> dict:
    """Per-sample decisions with the reference's distributions: independent
    0.5 H/V flips, rot90 k ∈ {1, 2, 3} (never the identity), per-channel
    color factor U[0.5, 1.5] and gamma U[0.25, 2]. Disabled ones are None.
    Draws on ``generator``'s device."""
    def uniform(lo, hi):
        u = torch.rand((batch, n_img_channels), generator=generator,
                       device=device)
        return (lo + (hi - lo) * u).to(dtype)

    out = {"do_h": None, "do_v": None, "k": None, "color": None, "gamma": None}
    if flip:
        hv = torch.rand((2, batch), generator=generator, device=device) < 0.5
        out["do_h"], out["do_v"] = hv[0], hv[1]
    if rotate:
        out["k"] = torch.randint(1, 4, (batch,), generator=generator,
                                 device=device)
    if color_shift:
        out["color"] = uniform(0.5, 1.5)
    if gamma:
        out["gamma"] = uniform(0.25, 2.0)
    return out


def apply_augmentation(stack: torch.Tensor, do_h=None, do_v=None, k=None,
                       color=None, gamma=None,
                       n_img_channels: int | None = None) -> torch.Tensor:
    """Apply per-sample decisions to a square NCHW ``stack`` (B, C, S, S)
    whose first ``n_img_channels`` channels are imagery.

    ``do_h`` flips W, ``do_v`` flips H ((B,) bool); ``k`` (B,) in {1,2,3}
    rotates by k·90° as the JAX package's decomposition does, flips first:
    rot1 = rev_H ∘ T, rot2 = rev_H ∘ rev_W, rot3 = rev_W ∘ T. ``color`` and
    ``gamma`` (B, n_img) scale and exponentiate the imagery, each clipped to
    [0, 1]. A None decision is skipped."""
    def sel(mask, transformed, original):
        return torch.where(mask[:, None, None, None], transformed, original)

    x = stack
    if do_h is not None:
        x = sel(do_h, x.flip(3), x)
    if do_v is not None:
        x = sel(do_v, x.flip(2), x)
    if k is not None:
        x = sel(k % 2 == 1, x.transpose(2, 3), x)   # rot1, rot3 transpose
        x = sel(k <= 2, x.flip(2), x)               # rot1, rot2 reverse rows
        x = sel(k >= 2, x.flip(3), x)               # rot2, rot3 reverse cols
    if color is not None or gamma is not None:
        imgs, rest = x[:, :n_img_channels], x[:, n_img_channels:]
        if color is not None:
            imgs = torch.clamp(imgs * color[:, :, None, None], 0.0, 1.0)
        if gamma is not None:
            imgs = torch.clamp(torch.pow(imgs, gamma[:, :, None, None]), 0.0, 1.0)
        x = torch.cat([imgs, rest], dim=1)
    return x.contiguous()
