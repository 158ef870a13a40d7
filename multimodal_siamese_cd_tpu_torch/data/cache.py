"""Packed scene cache (the port's own copy of the JAX package's).

The reference decodes GeoTIFFs with rasterio on every ``__getitem__``
(reference datasets.py:100,128-134). Here every (AOI, modality) time series
is decoded **once** into a packed ``(T, C, H, W)`` array on disk, memmapped
thereafter.

The on-disk layout is channel-PLANAR ``(T, C, H, W)``, the same format as
the JAX package's cache, so a full-scene eval wire is already NCHW. The
public ``load`` accessor returns (H, W, C) float32 for the item path.

Band subsetting, ``clip(0, 1)`` and ``nan_to_num`` (reference
datasets.py:30-46) are applied at cache-build time so the hot path is a pure
slice. Imagery is stored as float16 by default (inputs are reflectances in
[0, 1]; float16 resolution there is ~5e-4) — configurable via
``DATALOADER.CACHE_DTYPE``; building labels are uint8. The default cache
directory is ``<dataset>/.cache_torch``, apart from the JAX package's
``.cache_tpu``, so the two packages never race on one file.
"""

from __future__ import annotations

import hashlib
import json
import threading
from pathlib import Path

import numpy as np

from .. import geofiles

_CACHE_VERSION = 2  # v2: channel-planar (T, C, H, W) storage
_locks: dict = {}
_locks_guard = threading.Lock()


def _lock_for(key: str) -> threading.Lock:
    with _locks_guard:
        return _locks.setdefault(key, threading.Lock())


class SceneCache:
    """Lazy per-AOI packed arrays for s1 / s2 / buildings."""

    def __init__(self, dataset_root: Path, metadata: dict,
                 s1_bands, s2_bands, dtype: str = "float16",
                 cache_dir: Path | None = None, enabled: bool = True):
        self.root = Path(dataset_root)
        self.metadata = metadata
        self.s1_bands = list(s1_bands)
        self.s2_bands = list(s2_bands)
        self.dtype = np.dtype(dtype)
        self.enabled = enabled
        self.cache_dir = Path(cache_dir) if cache_dir else self.root / ".cache_torch"
        self._open: dict[tuple, tuple[np.ndarray, dict]] = {}

    def __getstate__(self) -> dict:
        """Pickled without the open memmaps (a process loader worker reopens
        them itself instead of receiving copies of the arrays)."""
        state = dict(self.__dict__)
        state["_open"] = {}
        return state

    # -- raw decode (identical semantics to reference datasets.py:30-52) ----
    def _tif_path(self, aoi_id: str, modality: str, year: int, month: int) -> Path:
        return (self.root / aoi_id / modality /
                f"{modality}_{aoi_id}_{year}_{month:02d}.tif")

    def _decode(self, aoi_id: str, modality: str, year: int, month: int) -> np.ndarray:
        img, _, _ = geofiles.read_tif(self._tif_path(aoi_id, modality, year, month))
        if modality == "s1":
            img = np.nan_to_num(np.clip(img[:, :, self.s1_bands], 0, 1)).astype(np.float32)
        elif modality == "s2":
            img = np.nan_to_num(np.clip(img[:, :, self.s2_bands], 0, 1)).astype(np.float32)
        else:  # buildings: binarize > 0 (reference datasets.py:42-46)
            img = np.nan_to_num(img > 0).astype(np.float32)
        return img

    # -- cache management ------------------------------------------------------
    def _timestamps(self, aoi_id: str, modality: str) -> list[tuple[int, int]]:
        """Timestamps the dataset can actually request for ``modality``
        (mirrors MultimodalCDDataset._eligible_timestamps): imagery is
        sampled wherever BOTH modalities exist (the unlabeled superset;
        masked allowed, reference datasets.py:121-124), buildings only at
        fully-labeled unmasked timestamps. Packing exactly this set keeps
        the build from decoding files the sampler never opens — metadata
        may flag timestamps whose other modality is absent or masked, and
        the reference tolerates those files being missing."""
        def want(t):
            if modality == "buildings":
                return (t.get("s1") and t.get("s2") and t.get("buildings")
                        and not t.get("masked", False))
            return t.get("s1") and t.get("s2")

        return [(t["year"], t["month"]) for t in self.metadata[aoi_id]
                if want(t)]

    def _cache_key(self, aoi_id: str, modality: str) -> str:
        """``{aoi}_{modality}_{confighash}_{srchash}`` — two hashes so the
        pruner can tell a SUPERSEDED generation (same config identity,
        stale source fingerprint: safe to delete) from ANOTHER CONFIG's
        cache (different bands/dtype sharing the dataset dir: deleting it
        would ping-pong full rebuilds between alternating runs)."""
        bands = self.s1_bands if modality == "s1" else self.s2_bands
        stamps = self._timestamps(aoi_id, modality)
        config_ident = json.dumps(
            [_CACHE_VERSION, modality, bands, str(self.dtype)])
        # Fingerprint the SOURCE files (size + mtime): without this a
        # re-downloaded / regenerated tif would silently keep serving the
        # old cached pixels forever. A missing file hashes as None — the
        # build will surface the real error if it is actually needed.
        # The timestamp list lives in the SOURCE hash too: metadata edits
        # change it, and their old generations are equally superseded.
        src = []
        for (y, m) in stamps:
            try:
                st = self._tif_path(aoi_id, modality, y, m).stat()
                src.append([st.st_size, st.st_mtime_ns])
            except OSError:
                src.append(None)
        ch = hashlib.sha1(config_ident.encode()).hexdigest()[:10]
        sh = hashlib.sha1(json.dumps([stamps, src]).encode()).hexdigest()[:10]
        return f"{aoi_id}_{modality}_{ch}_{sh}"

    def _build(self, aoi_id: str, modality: str, npy: Path, meta_file: Path) -> None:
        ts = self._timestamps(aoi_id, modality)
        dtype = np.uint8 if modality == "buildings" else self.dtype

        def planar(img: np.ndarray) -> np.ndarray:
            # decode yields (H, W, C) or (H, W); store (C, H, W)
            return img.transpose(2, 0, 1) if img.ndim == 3 else img[None]

        first = planar(self._decode(aoi_id, modality, *ts[0]))
        arr = np.empty((len(ts),) + first.shape, dtype=dtype)
        arr[0] = first
        for i, (y, m) in enumerate(ts[1:], start=1):
            arr[i] = planar(self._decode(aoi_id, modality, y, m))
        # Unique tmp names + atomic os.replace: concurrent builders (process
        # workers, parallel jobs sharing a dataset dir) each write their own
        # complete file and the last replace wins — builds are deterministic,
        # so either winner is valid and no reader ever sees a partial file.
        import os
        import uuid

        suffix = f".{os.getpid()}.{uuid.uuid4().hex[:8]}"
        tmp_npy = npy.with_name(npy.name + suffix)
        with open(tmp_npy, "wb") as f:
            np.save(f, arr)
        tmp_meta = meta_file.with_name(meta_file.name + suffix)
        tmp_meta.write_text(json.dumps(
            {"timestamps": ts, "shape": list(arr.shape), "dtype": str(dtype)}))
        os.replace(tmp_meta, meta_file)
        os.replace(tmp_npy, npy)

    def _prune_stale(self, aoi_id: str, modality: str, keep: str) -> None:
        """Delete superseded cache generations for ``(aoi, modality)``: a
        source re-download changes the source-fingerprint hash in the
        cache key, and without pruning every generation's packed array
        (hundreds of MB per entry at production scene sizes) would
        accumulate forever. Only generations sharing ``keep``'s CONFIG
        hash are touched — a different bands/dtype config legitimately
        keeps its own live cache in the same dataset dir. (Timestamps live
        in the SOURCE hash: two runs can only disagree on them mid-edit of
        the shared metadata.json, a transient state, whereas a committed
        metadata change genuinely supersedes old generations.) Unlinking
        is safe against concurrent readers — an open mmap keeps the inode
        alive until unmapped. Three sweeps:

          * same config hash, different source hash — superseded;
          * legacy single-hash names ({aoi}_{mod}_{10hex}.npy/.json) from
            before the two-hash key format — never loadable again;
          * builder tmp files ({name}.npy.{pid}.{hex8}) older than an
            hour — a crashed/SIGKILLed builder's partial write (live
            builds finish in minutes; the age bound protects concurrent
            builders' tmps).
        """
        import re
        import time

        config_prefix = keep.rsplit("_", 1)[0]  # {aoi}_{modality}_{ch}
        pat = re.compile(
            re.escape(config_prefix + "_") + r"[0-9a-f]{10}\.(npy|json)")
        legacy = re.compile(
            re.escape(f"{aoi_id}_{modality}_") + r"[0-9a-f]{10}\.(npy|json)")
        tmp = re.compile(
            re.escape(f"{aoi_id}_{modality}_")
            + r".+\.(npy|json)\.\d+\.[0-9a-f]{8}")
        cutoff = time.time() - 3600
        for f in self.cache_dir.glob(f"{aoi_id}_{modality}_*"):
            try:
                stale = (
                    (pat.fullmatch(f.name)
                     and not f.name.startswith(keep + "."))
                    or legacy.fullmatch(f.name)
                    or (tmp.fullmatch(f.name)
                        and f.stat().st_mtime < cutoff))
                if stale:
                    f.unlink()
            except OSError:
                pass  # racing pruner/builder; next build sweeps again

    def _load_packed(self, aoi_id: str, modality: str, _retry: bool = True):
        key = (aoi_id, modality)
        if key in self._open:
            return self._open[key]
        name = self._cache_key(aoi_id, modality)
        npy = self.cache_dir / f"{name}.npy"
        meta_file = self.cache_dir / f"{name}.json"

        def read():
            return (np.load(npy, mmap_mode="r"),
                    json.loads(meta_file.read_text()))

        if not (npy.exists() and meta_file.exists()):
            with _lock_for(name):
                if not (npy.exists() and meta_file.exists()):
                    self.cache_dir.mkdir(parents=True, exist_ok=True)
                    self._build(aoi_id, modality, npy, meta_file)
                    self._prune_stale(aoi_id, modality, keep=name)
        try:
            arr, meta = read()
        except FileNotFoundError:
            # the generation this process keyed can vanish mid-read when a
            # source tif is re-downloaded concurrently: another process
            # computes the NEW key, builds it, and its pruner unlinks ours.
            # Our key is then stale — recompute it from fresh source stats
            # (one bounded retry; a second disappearance means the dataset
            # dir is being actively rewritten and deserves the error)
            if not _retry:
                raise
            return self._load_packed(aoi_id, modality, _retry=False)
        except Exception:
            # a cache entry is REGENERABLE: a corrupt/truncated file (disk
            # hiccup, external tampering — atomic replace rules out partial
            # writes from this code) is rebuilt once instead of surfacing
            # an opaque np.load/json error for data we can remake
            with _lock_for(name):
                try:
                    # double-check under the lock: a concurrent healer may
                    # have rebuilt the entry while this thread waited, and
                    # re-reading is much cheaper than a redundant rebuild
                    arr, meta = read()
                except Exception:
                    # NEVER unlink the current generation: _build writes a
                    # complete tmp file and atomically os.replace()s it over
                    # the corrupt one, so a concurrent healer PROCESS (the
                    # in-process lock table can't see it; loader workers
                    # share one cache dir) either still sees corrupt bytes
                    # and deterministically rebuilds the same content, or
                    # sees a fresh entry — the file is only ever absent if
                    # a concurrent pruner retired this whole GENERATION
                    # (source re-download), which the FileNotFoundError
                    # retry above handles by re-keying.
                    self._build(aoi_id, modality, npy, meta_file)
                    try:
                        arr, meta = read()
                    except FileNotFoundError:
                        if not _retry:
                            raise
                        return self._load_packed(aoi_id, modality,
                                                 _retry=False)
        index = {tuple(t): i for i, t in enumerate(meta["timestamps"])}
        self._open[key] = (arr, index)
        return self._open[key]

    # -- public API --------------------------------------------------------------
    def load(self, aoi_id: str, modality: str, year: int, month: int) -> np.ndarray:
        """Scene array (H, W, C) float32 (buildings: (H, W, 1))."""
        if not self.enabled:
            img = self._decode(aoi_id, modality, year, month)
            return img if img.ndim == 3 else img[:, :, None]
        planar = self.load_raw_planar(aoi_id, modality, year, month)
        c, h, w = planar.shape
        out = np.empty((h, w, c), np.float32)
        for i in range(c):  # per-channel fill beats ascontiguous(transpose)
            out[..., i] = planar[i]
        return out

    def load_raw_planar(self, aoi_id: str, modality: str,
                        year: int, month: int,
                        window: tuple | None = None) -> np.ndarray:
        """Memmap-backed planar (C, H, W) scene in its storage dtype (no
        conversion, no copy); with the cache disabled, a fresh decode.
        ``window=(y0, y1, x0, x1)`` returns just that spatial slice (the
        training crop path). Returned as a base ndarray view: np.memmap's
        subclass plumbing buys nothing here."""
        if not self.enabled:
            img = self._decode(aoi_id, modality, year, month)
            if img.ndim == 2:
                img = img[:, :, None]
            if window is not None:
                y0, y1, x0, x1 = window
                img = img[y0:y1, x0:x1]
            return np.ascontiguousarray(img.transpose(2, 0, 1))
        arr, index = self._load_packed(aoi_id, modality)
        plane = arr[index[(year, month)]].view(np.ndarray)
        if window is not None:
            y0, y1, x0, x1 = window
            return plane[:, y0:y1, x0:x1]
        return plane

    def scene_shape(self, aoi_id: str, modality: str, year: int, month: int) -> tuple:
        """(H, W, C) — the layout-independent logical shape."""
        c, h, w = self.load_raw_planar(aoi_id, modality, year, month).shape
        return (h, w, c)

    @classmethod
    def from_cfg(cls, cfg, metadata: dict) -> "SceneCache":
        dl = cfg.DATALOADER
        return cls(
            dataset_root=Path(cfg.PATHS.DATASET),
            metadata=metadata,
            s1_bands=dl.S1_BANDS,
            s2_bands=dl.S2_BANDS,
            dtype=dl.get("CACHE_DTYPE", "float16"),
            cache_dir=dl.get("CACHE_DIR", None),
            enabled=dl.get("SCENE_CACHE", True),
        )
