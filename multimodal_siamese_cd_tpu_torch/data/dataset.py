"""MultimodalCDDataset — the SpaceNet7 bitemporal S1+S2 dataset.

Same constructor and sampling semantics as the JAX package's dataset and
the reference (utils/datasets.py:65-193): AOI split lists from the config,
optional unlabeled AOIs, TRAINING_MULTIPLIER epoch inflation, per-sample
timestamp-pair sampling ('first_last' or a random sorted pair),
construction-only change labels (t1==0 ∧ t2==1) and the same sample dict
keys.

* No-augmentation mode (evaluation, inference): items are (H, W, C)
  float32 numpy arrays; :meth:`eval_wire` gives the planar ``(C, Hp, Wp)``
  wire, which is already NCHW.
* Training mode (the default): :meth:`get` crops one sample from the
  memmapped scene cache into the planar wire stack ``(2·n_s1 + 2·n_s2 + 3,
  S, S)`` — ``[s1_t1 | s1_t2 | s2_t1 | s2_t2 | buildings_t1 | buildings_t2
  | change]``, float16 when the cache is float16 — byte for byte what the
  JAX package's ``crop_only=True, return_stack=True`` dataset assembles
  from the same generator. Flips, rotations and the photometric jitter run
  on the card (:mod:`.augmentations`); the JAX package's host-side
  post-crop pipeline has no counterpart here. ``ds[i]`` in training mode
  (:meth:`augmented_item`) runs that same device augmentation on the CPU
  over one crop stack and splits it into the reference's item.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from .. import geofiles
from . import augmentations
from .cache import SceneCache


class MultimodalCDDataset:
    def __init__(self, cfg, run_type: str, no_augmentations: bool = False,
                 dataset_mode: str = None, disable_multiplier: bool = False,
                 disable_unlabeled: bool = False):
        self.cfg = cfg
        self.run_type = run_type
        self.root_path = Path(cfg.PATHS.DATASET)
        self.metadata = geofiles.load_json(self.root_path / 'metadata.json')

        self.s1_band_indices = list(cfg.DATALOADER.S1_BANDS)
        self.s2_band_indices = list(cfg.DATALOADER.S2_BANDS)
        self.dataset_mode = (cfg.DATALOADER.DATASET_MODE if dataset_mode is None
                             else dataset_mode)
        self.include_building_labels = cfg.DATALOADER.INCLUDE_BUILDING_LABELS
        self.no_augmentations = no_augmentations
        self.rng = np.random.default_rng(cfg.get('SEED', 7))

        # AOI split selection (reference datasets.py:79-97)
        if run_type == 'training':
            self.aoi_ids = list(cfg.DATASET.TRAINING_IDS)
        elif run_type == 'validation':
            self.aoi_ids = list(cfg.DATASET.VALIDATION_IDS)
        else:
            self.aoi_ids = list(cfg.DATASET.TEST_IDS)
        self.labeled = [True] * len(self.aoi_ids)

        if ((cfg.DATALOADER.INCLUDE_UNLABELED or
             cfg.DATALOADER.INCLUDE_UNLABELED_VALIDATION) and not disable_unlabeled):
            aoi_ids_unlabelled = []
            if cfg.DATALOADER.INCLUDE_UNLABELED:
                aoi_ids_unlabelled += list(cfg.DATASET.UNLABELED_IDS)
            if cfg.DATALOADER.INCLUDE_UNLABELED_VALIDATION:
                aoi_ids_unlabelled += list(cfg.DATASET.VALIDATION_IDS)
            aoi_ids_unlabelled = sorted(aoi_ids_unlabelled)
            self.aoi_ids.extend(aoi_ids_unlabelled)
            self.labeled.extend([False] * len(aoi_ids_unlabelled))

        if not disable_multiplier:
            self.aoi_ids = self.aoi_ids * cfg.DATALOADER.TRAINING_MULTIPLIER
            self.labeled = self.labeled * cfg.DATALOADER.TRAINING_MULTIPLIER

        self.length = len(self.aoi_ids)
        self.cache = SceneCache.from_cfg(cfg, self.metadata)

    # -- timestamp selection (reference datasets.py:115-124) -------------------
    def _eligible_timestamps(self, aoi_id: str, labeled: bool) -> list[tuple[int, int]]:
        ts = self.metadata[aoi_id]
        if labeled:
            return [(t['year'], t['month']) for t in ts
                    if t['s1'] and t['s2'] and t['buildings'] and not t['masked']]
        return [(t['year'], t['month']) for t in ts if t['s1'] and t['s2']]

    def _pick_pair(self, timestamps: list, rng: np.random.Generator) -> tuple:
        if self.dataset_mode == 'first_last':
            return timestamps[0], timestamps[-1]
        i, j = sorted(rng.integers(0, len(timestamps), size=2))
        return timestamps[i], timestamps[j]

    def _load_change_label(self, aoi_id, year_t1, month_t1, year_t2, month_t2):
        b1 = self.cache.load(aoi_id, 'buildings', year_t1, month_t1)
        b2 = self.cache.load(aoi_id, 'buildings', year_t2, month_t2)
        change = np.logical_and(b1 == 0, b2 == 1)  # construction only
        return change.astype(np.float32)

    # -- item assembly (reference datasets.py:111-181) ----------------------------
    def __getitem__(self, index: int) -> dict:
        """The reference's item: a full scene in no-augmentation mode, the
        augmented training crop (:meth:`augmented_item`) otherwise."""
        if self.no_augmentations:
            return self.get(index)
        return self.augmented_item(index)

    def augmented_item(self, index: int,
                       rng: np.random.Generator | None = None) -> dict:
        """One training sample as the reference's item (what
        sanity_check.py shows): the crop stack of :meth:`get`, run through
        the device augmentation of :mod:`.augmentations` on the CPU in
        float32 (flips, rot90, color shift and gamma per the config; labels
        move with the imagery), then split into (S, S, C) float32 ``x_t1``,
        ``x_t2``, ``y_change`` (and ``y_sem_t1`` / ``y_sem_t2`` with
        building labels). ``rng`` (default: the dataset's own) draws the
        crop and then seeds the augmentation's generator."""
        rng = self.rng if rng is None else rng
        item = self.get(index, rng)
        stack = torch.from_numpy(item.pop('stack').astype(np.float32))[None]
        n_img = 2 * len(self.s1_band_indices) + 2 * len(self.s2_band_indices)
        a = self.cfg.AUGMENTATION
        generator = torch.Generator().manual_seed(int(rng.integers(2 ** 63)))
        decisions = augmentations.draw_augmentation(
            1, n_img, flip=bool(a.RANDOM_FLIP), rotate=bool(a.RANDOM_ROTATE),
            color_shift=bool(a.COLOR_SHIFT), gamma=bool(a.GAMMA_CORRECTION),
            generator=generator, dtype=torch.float32, device='cpu')
        hwc = augmentations.apply_augmentation(
            stack, n_img_channels=n_img, **decisions)[0].permute(1, 2, 0).numpy()
        x_t1, x_t2 = self._split_imgs(hwc[..., :n_img])
        item.update(x_t1=np.ascontiguousarray(x_t1),
                    x_t2=np.ascontiguousarray(x_t2),
                    y_change=np.ascontiguousarray(hwc[..., n_img + 2:]))
        if self.include_building_labels:
            item['y_sem_t1'] = np.ascontiguousarray(hwc[..., n_img:n_img + 1])
            item['y_sem_t2'] = np.ascontiguousarray(hwc[..., n_img + 1:n_img + 2])
        return item

    def get(self, index: int, rng: np.random.Generator | None = None,
            out: np.ndarray | None = None) -> dict:
        """Like ``__getitem__`` but with an explicit generator: loader worker
        threads pass per-batch generators, so an epoch is the same whatever
        the thread schedule. ``out`` (training mode only): a preallocated
        planar ``(C, S, S)`` row of the loader's batch buffer that the crop
        stack is assembled into in place (see :meth:`stack_spec`)."""
        rng = self.rng if rng is None else rng
        aoi_id = self.aoi_ids[index]
        labeled = self.labeled[index]
        timestamps = self._eligible_timestamps(aoi_id, labeled)
        (year_t1, month_t1), (year_t2, month_t2) = self._pick_pair(
            timestamps, rng)
        if not self.no_augmentations:
            return self._get_cropped(aoi_id, labeled, year_t1, month_t1,
                                     year_t2, month_t2, rng, out)

        img_s1_t1 = self.cache.load(aoi_id, 's1', year_t1, month_t1)
        img_s2_t1 = self.cache.load(aoi_id, 's2', year_t1, month_t1)
        img_s1_t2 = self.cache.load(aoi_id, 's1', year_t2, month_t2)
        img_s2_t2 = self.cache.load(aoi_id, 's2', year_t2, month_t2)

        h, w = img_s1_t1.shape[:2]
        if labeled:
            change = self._load_change_label(aoi_id, year_t1, month_t1,
                                             year_t2, month_t2)
            if self.include_building_labels:
                b1 = self.cache.load(aoi_id, 'buildings', year_t1, month_t1)
                b2 = self.cache.load(aoi_id, 'buildings', year_t2, month_t2)
                buildings = np.concatenate((b1, b2), axis=-1).astype(np.float32)
            else:
                buildings = np.zeros((h, w, 2), np.float32)
        else:
            change = np.zeros((h, w, 1), np.float32)
            buildings = np.zeros((h, w, 2), np.float32)

        # the no-augmentation transform is EnsureFloat32 alone
        imgs = np.concatenate((img_s1_t1, img_s1_t2, img_s2_t1, img_s2_t2),
                              axis=-1).astype(np.float32, copy=False)
        x_t1, x_t2 = self._split_imgs(imgs)

        item = {
            'x_t1': np.ascontiguousarray(x_t1),
            'x_t2': np.ascontiguousarray(x_t2),
            'y_change': np.ascontiguousarray(change, dtype=np.float32),
            'aoi_id': aoi_id,
            'year_t1': year_t1,
            'month_t1': month_t1,
            'year_t2': year_t2,
            'month_t2': month_t2,
            'is_labeled': labeled,
        }
        if self.include_building_labels:
            item['y_sem_t1'] = np.ascontiguousarray(buildings[..., :1])
            item['y_sem_t2'] = np.ascontiguousarray(buildings[..., 1:])
        return item

    def _get_cropped(self, aoi_id, labeled, year_t1, month_t1, year_t2,
                     month_t2, rng, out=None) -> dict:
        """Training crop through windowed cache reads (JAX package
        ``dataset._get_cropped``, crop-only stack path). The crop origin is
        drawn from the uint8 label planes; only S×S windows of the imagery
        are read and converted."""
        crop = self.cfg.AUGMENTATION.CROP_SIZE
        importance = self.cfg.AUGMENTATION.IMAGE_OVERSAMPLING_TYPE != 'none'
        if labeled:
            # construction-only change over {0,1} rasters is b2 > b1; it is
            # only ever read inside crop-sized windows, so it is computed
            # per window
            b1 = self.cache.load_raw_planar(aoi_id, 'buildings',
                                            year_t1, month_t1)[0]
            b2 = self.cache.load_raw_planar(aoi_id, 'buildings',
                                            year_t2, month_t2)[0]
            h, w = b1.shape

            def change_window_count(y, x, s):
                return np.count_nonzero(b2[y:y + s, x:x + s] > b1[y:y + s, x:x + s])
        else:
            h, w, _ = self.cache.scene_shape(aoi_id, 's1', year_t1, month_t1)
            change_window_count = None

        if h < crop or w < crop:
            raise ValueError(
                f"AOI {aoi_id} scene ({h}x{w}) is smaller than "
                f"AUGMENTATION.CROP_SIZE={crop}; shrink the crop or exclude "
                f"the AOI (batches must be uniformly sized)")
        y0, x0 = augmentations.choose_crop_offset(
            None, h, w, crop, rng, importance and labeled,
            window_count=change_window_count)
        s = crop
        n_s1 = len(self.s1_band_indices)
        n_s2 = len(self.s2_band_indices)
        n_img = 2 * n_s1 + 2 * n_s2

        def planar_win(modality, year, month):
            return self.cache.load_raw_planar(aoi_id, modality, year, month,
                                              window=(y0, y0 + s, x0, x0 + s))

        shape, dtype = self.stack_spec()
        if out is not None:
            stack = out
            # np.empty-backed: label planes not written below are zeroed
            if not (labeled and self.include_building_labels):
                stack[n_img:].fill(0)
        else:
            stack = np.zeros(shape, dtype)
        stack[:n_s1] = planar_win('s1', year_t1, month_t1)
        stack[n_s1:2 * n_s1] = planar_win('s1', year_t2, month_t2)
        stack[2 * n_s1:2 * n_s1 + n_s2] = planar_win('s2', year_t1, month_t1)
        stack[2 * n_s1 + n_s2:n_img] = planar_win('s2', year_t2, month_t2)
        if labeled:
            b1_win = b1[y0:y0 + s, x0:x0 + s]
            b2_win = b2[y0:y0 + s, x0:x0 + s]
            if self.include_building_labels:
                stack[n_img] = b1_win
                stack[n_img + 1] = b2_win
            stack[n_img + 2] = b2_win > b1_win
        return {
            'stack': stack,
            'aoi_id': aoi_id,
            'year_t1': year_t1, 'month_t1': month_t1,
            'year_t2': year_t2, 'month_t2': month_t2,
            'is_labeled': labeled,
        }

    def stack_spec(self):
        """``((C, S, S), dtype)`` of the training ``'stack'`` item, else
        None (no-augmentation mode). The wire is float16 when the scene cache
        is float16 (lossless there: labels are exact in f16 too), float32
        otherwise. Non-None tells the loader it may preallocate one batch
        buffer and assemble each sample in place."""
        if self.no_augmentations:
            return None
        s = self.cfg.AUGMENTATION.CROP_SIZE
        n_img = 2 * len(self.s1_band_indices) + 2 * len(self.s2_band_indices)
        f16 = self.cache.enabled and np.dtype(self.cache.dtype) == np.float16
        return (n_img + 3, s, s), (np.float16 if f16 else np.float32)

    def _split_imgs(self, imgs: np.ndarray):
        """Split the concatenated imagery block into (x_t1, x_t2) per
        DATALOADER.INPUT_MODE."""
        n_s1 = len(self.s1_band_indices)
        n_s2 = len(self.s2_band_indices)
        img_s1_t1, img_s1_t2 = imgs[..., :n_s1], imgs[..., n_s1:2 * n_s1]
        img_s2_t1 = imgs[..., 2 * n_s1:2 * n_s1 + n_s2]
        img_s2_t2 = imgs[..., 2 * n_s1 + n_s2:2 * n_s1 + 2 * n_s2]
        mode = self.cfg.DATALOADER.INPUT_MODE
        if mode == 's1':
            return img_s1_t1, img_s1_t2
        if mode == 's2':
            return img_s2_t1, img_s2_t2
        return (np.concatenate((img_s1_t1, img_s2_t1), axis=-1),
                np.concatenate((img_s1_t2, img_s2_t2), axis=-1))

    def supports_eval_wire(self) -> bool:
        """The eligibility predicate for the planar wire eval path: the
        scene cache must be on (the wire is assembled from its planes)."""
        return self.cache.enabled and self.no_augmentations

    def eval_wire(self, index: int, bucket: int = 64,
                  sem: bool = False) -> dict | None:
        """Planar, bucket-padded full-scene eval wire. Assembled straight
        from the planar scene cache in the cache's STORAGE dtype (f16 by
        default — the values are exactly representable there, so the
        device-side upcast reproduces the float32 item path bit for bit)
        with uint8 label/valid planes.

        Returns None when the scene cache is disabled (callers use the item
        path). Keys: ``x1``/``x2`` (C, Hp, Wp) planar padded imagery,
        ``y``/``valid`` (Hp, Wp) uint8, ``shape`` (h, w) true scene size,
        plus the item metadata fields. ``sem=True`` adds ``ysem1`` /
        ``ysem2`` (Hp, Wp) uint8, the building rasters of both dates (the
        dual-task assessment's semantic truths; zero for unlabeled
        scenes)."""
        if not self.supports_eval_wire():
            return None
        aoi_id = self.aoi_ids[index]
        labeled = self.labeled[index]
        timestamps = self._eligible_timestamps(aoi_id, labeled)
        (year_t1, month_t1), (year_t2, month_t2) = self._pick_pair(
            timestamps, self.rng)

        mode = self.cfg.DATALOADER.INPUT_MODE
        modalities = {'s1': ['s1'], 's2': ['s2']}.get(mode, ['s1', 's2'])

        def planar_x(year, month):
            planes = [self.cache.load_raw_planar(aoi_id, m, year, month)
                      for m in modalities]
            c = sum(p.shape[0] for p in planes)
            h, w = planes[0].shape[1:]
            hp, wp = -(-h // bucket) * bucket, -(-w // bucket) * bucket
            out = np.zeros((c, hp, wp), planes[0].dtype)
            c0 = 0
            for p in planes:
                out[c0:c0 + p.shape[0], :h, :w] = p
                c0 += p.shape[0]
            return out, (h, w)

        x1, (h, w) = planar_x(year_t1, month_t1)
        x2, _ = planar_x(year_t2, month_t2)
        hp, wp = x1.shape[1:]
        y = np.zeros((hp, wp), np.uint8)
        wire = {
            'x1': x1, 'x2': x2, 'y': y, 'shape': (h, w),
            'aoi_id': aoi_id, 'year_t1': year_t1, 'month_t1': month_t1,
            'year_t2': year_t2, 'month_t2': month_t2, 'is_labeled': labeled,
        }
        if sem:
            wire['ysem1'] = np.zeros((hp, wp), np.uint8)
            wire['ysem2'] = np.zeros((hp, wp), np.uint8)
        if labeled:
            b1 = self.cache.load_raw_planar(aoi_id, 'buildings',
                                            year_t1, month_t1)[0]
            b2 = self.cache.load_raw_planar(aoi_id, 'buildings',
                                            year_t2, month_t2)[0]
            # construction-only change over {0,1} rasters == b2 > b1
            np.greater(b2, b1, out=y[:h, :w])
            if sem:
                wire['ysem1'][:h, :w] = b1
                wire['ysem2'][:h, :w] = b2
        valid = np.zeros((hp, wp), np.uint8)
        valid[:h, :w] = 1
        wire['valid'] = valid
        return wire

    def get_aoi_ids(self) -> list:
        # sorted: set order varies with PYTHONHASHSEED across runs
        return sorted(set(self.aoi_ids))

    def get_index(self, aoi_id: str):
        """Linear AOI lookup (reference datasets.py:183-187); None when the
        AOI is not in the split."""
        for index, candidate in enumerate(self.aoi_ids):
            if aoi_id == candidate:
                return index
        return None

    def __len__(self) -> int:
        return self.length

    def __iter__(self):
        for i in range(self.length):
            yield self[i]

    def __str__(self) -> str:
        return f'Dataset with {self.length} samples.'
