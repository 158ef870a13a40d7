"""Synthetic SpaceNet7-layout dataset fixture generators (the port's own
copy of the JAX package's ``generate_fixture_dataset`` and
``generate_hard_dataset``).

Builds an on-disk dataset tree matching the layout the reference dataset
expects (utils/datasets.py:17,31,37,43: ``metadata.json`` at the root,
per-AOI ``s1/ s2/ buildings/`` directories with
``{mod}_{aoi}_{year}_{month:02d}.tif`` files). The same ``seed`` writes the
same files as the JAX package's generators, so tests can hold the two
packages against one tree.

Building footprints are random rectangles that accumulate over time, so
every (t1 < t2) pair has genuine construction-only change
(``t1 == 0 ∧ t2 == 1``, reference datasets.py:48-52).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from .. import geofiles
from ..geotiff import Affine

# Default fixture AOIs, named after real SpaceNet7 AOIs so the shipped
# config split lists resolve against the fixture (base.yaml DATASET lists).
TRAIN_AOIS = ['L15-0331E-1257N_1327_3160_13', 'L15-0361E-1300N_1446_2989_13']
VAL_AOIS = ['L15-0358E-1220N_1433_3310_13']
TEST_AOIS = ['L15-0357E-1223N_1429_3296_13']
UNLABELED_AOIS = ['L15-0369E-1244N_1479_3214_13']

N_S1_BANDS = 2
N_S2_BANDS = 4


def _make_buildings(rng: np.random.Generator, h: int, w: int, n_steps: int) -> list[np.ndarray]:
    """A time series of binary building rasters; footprints only ever grow."""
    current = np.zeros((h, w), dtype=np.uint8)
    series = []
    for _ in range(n_steps):
        for _ in range(rng.integers(1, 4)):
            bh = int(rng.integers(3, max(4, h // 6)))
            bw = int(rng.integers(3, max(4, w // 6)))
            i = int(rng.integers(0, h - bh))
            j = int(rng.integers(0, w - bw))
            current[i:i + bh, j:j + bw] = 1
        series.append(current.copy())
    return series


def generate_fixture_dataset(
    root: Path,
    seed: int = 7,
    scene_size: tuple[int, int] = (80, 96),
    n_timestamps: int = 3,
    aois: dict | None = None,
    with_nans: bool = True,
) -> dict:
    """Write a synthetic dataset tree under ``root``; returns the metadata.
    ``aois`` maps AOI id -> labeled; scene ``k`` is ``scene_size`` plus
    ``(8 * (k % 3), 8 * (k % 2))`` pixels, so shapes vary."""
    rng = np.random.default_rng(seed)
    root = Path(root)
    root.mkdir(parents=True, exist_ok=True)

    if aois is None:
        aois = {aoi: True for aoi in TRAIN_AOIS + VAL_AOIS + TEST_AOIS}
        aois.update({aoi: False for aoi in UNLABELED_AOIS})

    transform = Affine.from_origin(10.0, 50.0, 4.77e-5, 4.77e-5)
    metadata: dict = {}
    for aoi_idx, (aoi_id, labeled) in enumerate(aois.items()):
        h = scene_size[0] + 8 * (aoi_idx % 3)   # vary shapes to exercise padding
        w = scene_size[1] + 8 * (aoi_idx % 2)
        buildings = _make_buildings(rng, h, w, n_timestamps)
        timestamps = []
        for t in range(n_timestamps):
            year = 2019 + (t // 12)
            month = 1 + (t % 12)
            base = buildings[t].astype(np.float32)

            s1 = rng.uniform(0, 0.6, size=(h, w, N_S1_BANDS)).astype(np.float32)
            s1 += 0.3 * base[:, :, None]
            s2 = rng.uniform(0, 0.4, size=(h, w, N_S2_BANDS)).astype(np.float32)
            s2 += 0.4 * base[:, :, None]
            if with_nans and t == 0:
                # A few NaNs and >1 values: exercises nan_to_num + clip
                # (reference datasets.py:33-34).
                s1[0, 0, 0] = np.nan
                s2[0, 1, 0] = 1.7

            geofiles.write_tif(root / aoi_id / 's1' / f's1_{aoi_id}_{year}_{month:02d}.tif',
                               s1, transform, 'EPSG:4326')
            geofiles.write_tif(root / aoi_id / 's2' / f's2_{aoi_id}_{year}_{month:02d}.tif',
                               s2, transform, 'EPSG:4326')
            if labeled:
                geofiles.write_tif(
                    root / aoi_id / 'buildings' / f'buildings_{aoi_id}_{year}_{month:02d}.tif',
                    buildings[t], transform, 'EPSG:4326')
            timestamps.append({
                'year': year, 'month': month,
                's1': True, 's2': True,
                'buildings': bool(labeled),
                'masked': False,
            })
        metadata[aoi_id] = timestamps

    geofiles.write_json(root / 'metadata.json', metadata)
    return metadata


# ---------------------------------------------------------------------------
# Hard-mode fixture: SpaceNet7-realistic statistics (the JAX package's
# generate_hard_dataset, copied).
#
# The easy fixture above saturates — big high-contrast rectangles on flat
# noise train to F1 0.99 in one epoch, which proves plumbing but not
# learning. This mode reproduces the statistics real SpaceNet7 lives in
# (reference utils/datasets.py consumers; prevalence motivates
# ImportanceRandomCrop, reference augmentations.py:129-142):
#
#   * change prevalence well under 2% of pixels per (t1, t2) pair —
#     new construction is a handful of SMALL buildings per interval;
#   * pre-existing buildings as confusers: labeled in `buildings` at every
#     timestamp, hence absent from the change target (t1==0 ∧ t2==1);
#   * unlabeled bright clutter (rock/road patches) that looks like
#     buildings in BOTH modalities but never enters any label;
#   * per-building contrast drawn from a range, so some positives are
#     weak-signal;
#   * S1 with multiplicative gamma speckle, S2 with low-frequency terrain
#     texture, per-timestamp seasonal gain/offset drift, and sensor noise.
# ---------------------------------------------------------------------------


def _bilinear_field(rng: np.random.Generator, h: int, w: int, cell: int,
                    lo: float, hi: float) -> np.ndarray:
    """Low-frequency random field: coarse uniform grid, bilinear upsample
    (no scipy in this image)."""
    gh, gw = h // cell + 2, w // cell + 2
    g = rng.uniform(lo, hi, size=(gh, gw)).astype(np.float32)
    yi = np.linspace(0.0, gh - 1.001, h)
    xi = np.linspace(0.0, gw - 1.001, w)
    y0, x0 = yi.astype(int), xi.astype(int)
    fy, fx = (yi - y0)[:, None].astype(np.float32), (xi - x0)[None, :].astype(np.float32)
    a = g[y0][:, x0]
    b = g[y0][:, x0 + 1]
    c = g[y0 + 1][:, x0]
    d = g[y0 + 1][:, x0 + 1]
    return a * (1 - fy) * (1 - fx) + b * (1 - fy) * fx + c * fy * (1 - fx) + d * fy * fx


def _paint_buildings(rng: np.random.Generator, mask: np.ndarray,
                     boost: np.ndarray, target_px: float,
                     contrast: tuple[float, float],
                     centers: list | None = None,
                     spread: float | None = None) -> None:
    """Paint small rectangles into ``mask`` (binary) and ``boost`` (per-
    building contrast in ``contrast`` range) until ~``target_px`` new pixels
    are set. SpaceNet7 buildings at 4 m/px are a few pixels on a side.

    With ``centers``, positions are drawn Gaussian around those growth
    clusters (σ = ``spread``) instead of uniformly — real construction
    clusters in development zones, which is exactly what makes most
    uniform crops change-free and ImportanceRandomCrop worth having."""
    h, w = mask.shape
    painted = 0
    while painted < target_px:
        bh = int(rng.integers(2, 9))
        bw = int(rng.integers(2, 9))
        if centers is None:
            i = int(rng.integers(0, h - bh))
            j = int(rng.integers(0, w - bw))
        else:
            ci, cj = centers[int(rng.integers(len(centers)))]
            i = int(np.clip(rng.normal(ci, spread), 0, h - bh))
            j = int(np.clip(rng.normal(cj, spread), 0, w - bw))
        painted += int((~mask[i:i + bh, j:j + bw].astype(bool)).sum())
        mask[i:i + bh, j:j + bw] = 1
        boost[i:i + bh, j:j + bw] = rng.uniform(*contrast)


def generate_hard_dataset(
    root: Path,
    seed: int = 7,
    scene_size: tuple[int, int] = (256, 256),
    n_timestamps: int = 4,
    aois: dict | None = None,
    change_per_step: float = 0.004,
    preexisting_fraction: float = 0.02,
    clutter_fraction: float = 0.015,
    signal: float = 0.3,
) -> dict:
    """Write a hard-mode synthetic dataset tree under ``root``.

    ``change_per_step`` is the fraction of pixels newly built per timestamp
    interval, so a (t1, t2) pair carries ≈ (t2-t1)·change_per_step change
    prevalence (0.4%–1.2% at the defaults with n_timestamps=4).
    ``signal`` scales building contrast relative to the fixed noise model —
    the calibration knob that sets where headline configs land on F1. The
    default 0.3 is the JAX package's calibration (its BASELINE.md): there
    the headline supervised config lands mid-range on test F1, learnable
    but noise-limited, like real SpaceNet7. Returns the metadata dict (same
    layout contract as :func:`generate_fixture_dataset`). The same
    arguments write the same files as the JAX package's generator.
    """
    rng = np.random.default_rng(seed)
    root = Path(root)
    root.mkdir(parents=True, exist_ok=True)
    if aois is None:
        aois = {aoi: True for aoi in TRAIN_AOIS + VAL_AOIS + TEST_AOIS}
        aois.update({aoi: False for aoi in UNLABELED_AOIS})

    transform = Affine.from_origin(10.0, 50.0, 4.77e-5, 4.77e-5)
    metadata: dict = {}
    for aoi_idx, (aoi_id, labeled) in enumerate(aois.items()):
        h = scene_size[0] + 8 * (aoi_idx % 3)
        w = scene_size[1] + 8 * (aoi_idx % 2)
        n_px = h * w

        # labeled footprints: pre-existing stock (never change) + growth
        mask = np.zeros((h, w), dtype=np.uint8)
        boost = np.zeros((h, w), dtype=np.float32)
        _paint_buildings(rng, mask, boost, preexisting_fraction * n_px,
                         contrast=(0.4, 1.0))
        # growth clusters: new construction concentrates in 1-3 development
        # zones per AOI (σ ≈ 8% of the scene side), so at production
        # crop:scene ratios most uniform crops carry ZERO change — the
        # regime ImportanceRandomCrop exists for
        spread = max(8.0, 0.04 * min(h, w))
        centers = [(float(rng.uniform(0, h)), float(rng.uniform(0, w)))
                   for _ in range(int(rng.integers(1, 3)))]
        masks, boosts = [], []
        for _ in range(n_timestamps):
            masks.append(mask.copy())
            boosts.append(boost.copy())
            _paint_buildings(rng, mask, boost, change_per_step * n_px,
                             contrast=(0.3, 1.0), centers=centers,
                             spread=spread)

        # unlabeled clutter: building-like in imagery, in NO label, static
        cl_mask = np.zeros((h, w), dtype=np.uint8)
        cl_boost = np.zeros((h, w), dtype=np.float32)
        _paint_buildings(rng, cl_mask, cl_boost, clutter_fraction * n_px,
                         contrast=(0.4, 1.0))

        # per-AOI low-frequency terrain per band
        terrain_s2 = [
            _bilinear_field(rng, h, w, cell=24, lo=0.12, hi=0.45)
            for _ in range(N_S2_BANDS)
        ]
        terrain_s1 = [
            _bilinear_field(rng, h, w, cell=24, lo=0.08, hi=0.28)
            for _ in range(N_S1_BANDS)
        ]

        timestamps = []
        for t in range(n_timestamps):
            year = 2019 + (t // 12)
            month = 1 + (t % 12)
            visual = boosts[t] + cl_boost  # what sensors see: labels + clutter

            # S2: terrain + seasonal per-band gain/offset + boost + noise
            s2 = np.empty((h, w, N_S2_BANDS), dtype=np.float32)
            for b in range(N_S2_BANDS):
                gain = float(rng.normal(1.0, 0.08))
                offs = float(rng.normal(0.0, 0.04))
                band = terrain_s2[b] * gain + offs
                band += 0.20 * signal * visual
                band += rng.normal(0.0, 0.05, size=(h, w)).astype(np.float32)
                s2[:, :, b] = band
            s2 = np.clip(s2, 0.0, 1.0)

            # S1: backscatter + boost, multiplicative gamma speckle (L=4)
            s1 = np.empty((h, w, N_S1_BANDS), dtype=np.float32)
            for b in range(N_S1_BANDS):
                sigma0 = terrain_s1[b] + 0.30 * signal * visual
                speckle = rng.gamma(4.0, 0.25, size=(h, w)).astype(np.float32)
                s1[:, :, b] = sigma0 * speckle
            s1 = np.clip(s1, 0.0, 1.0)

            geofiles.write_tif(root / aoi_id / 's1' / f's1_{aoi_id}_{year}_{month:02d}.tif',
                               s1, transform, 'EPSG:4326')
            geofiles.write_tif(root / aoi_id / 's2' / f's2_{aoi_id}_{year}_{month:02d}.tif',
                               s2, transform, 'EPSG:4326')
            if labeled:
                geofiles.write_tif(
                    root / aoi_id / 'buildings' / f'buildings_{aoi_id}_{year}_{month:02d}.tif',
                    masks[t], transform, 'EPSG:4326')
            timestamps.append({
                'year': year, 'month': month,
                's1': True, 's2': True,
                'buildings': bool(labeled),
                'masked': False,
            })
        metadata[aoi_id] = timestamps

    geofiles.write_json(root / 'metadata.json', metadata)
    return metadata


def fixture_cfg_overrides() -> list:
    """``merge_from_list`` pairs that point a config's AOI splits at the
    default fixture AOIs (and shrink crops to fixture scale)."""
    return [
        'DATASET.TRAINING_IDS', repr(TRAIN_AOIS),
        'DATASET.VALIDATION_IDS', repr(VAL_AOIS),
        'DATASET.TEST_IDS', repr(TEST_AOIS),
        'DATASET.UNLABELED_IDS', repr(UNLABELED_AOIS),
        'AUGMENTATION.CROP_SIZE', '32',
        'DATALOADER.TRAINING_MULTIPLIER', '2',
        'DATALOADER.NUM_WORKER', '0',
    ]
