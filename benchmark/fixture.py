"""The benchmark's dataset: a synthetic SpaceNet7-layout tree written once
per checkout.

A frozen copy of the port's ``data.synthetic.generate_fixture_dataset``
(the same draws in the same order, so the same seed gives the same pixels)
with its own GeoTIFF writer: uncompressed, one strip, chunky, which the
port's codec reads like any other GeoTIFF and which :mod:`.reference.data`
reads by offset. Deflating ~1.2 GB of float32 would cost about a minute of
the first run of each checkout; the pixels do not depend on it.

The tree goes to ``benchmark/.data/fixture-<digest>/`` (git ignores it),
named by a digest of ``fixture.json``, and is complete when its
``COMPLETE`` marker, written last, holds those parameters.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import struct
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
PARAMS_FILE = HERE / "fixture.json"
DATA_DIR = HERE / ".data"
N_S1_BANDS = 2
N_S2_BANDS = 4

# TIFF tags of the writer (and of reference.data's reader)
_WIDTH, _LENGTH, _BITS, _COMPRESSION, _PHOTOMETRIC = 256, 257, 258, 259, 262
_STRIP_OFFSETS, _SPP, _ROWS_PER_STRIP, _STRIP_BYTES = 273, 277, 278, 279
_PLANAR, _SAMPLE_FORMAT = 284, 339
_PIXEL_SCALE, _TIEPOINT, _GEOKEYS = 33550, 33922, 34735


def params() -> dict:
    return json.loads(PARAMS_FILE.read_text())


def write_tif(path: Path, arr: np.ndarray, origin=(10.0, 50.0), pixel=4.77e-5) -> None:
    """An (H, W[, C]) float32 or uint8 array as an uncompressed single-strip
    chunky GeoTIFF, EPSG:4326, north-up at ``origin`` with square
    ``pixel``s."""
    arr = np.ascontiguousarray(arr if arr.ndim == 3 else arr[:, :, None])
    h, w, c = arr.shape
    fmt = {np.dtype(np.float32): 3, np.dtype(np.uint8): 1}[arr.dtype]
    bits = arr.dtype.itemsize * 8
    entries = [  # (tag, type, values); type 3 SHORT, 4 LONG, 12 DOUBLE
        (_WIDTH, 4, [w]), (_LENGTH, 4, [h]), (_BITS, 3, [bits] * c),
        (_COMPRESSION, 3, [1]), (_PHOTOMETRIC, 3, [1]), (_STRIP_OFFSETS, 4, [0]),
        (_SPP, 3, [c]), (_ROWS_PER_STRIP, 4, [h]), (_STRIP_BYTES, 4, [arr.nbytes]),
        (_PLANAR, 3, [1]), (_SAMPLE_FORMAT, 3, [fmt] * c),
        (_PIXEL_SCALE, 12, [pixel, pixel, 0.0]),
        (_TIEPOINT, 12, [0.0, 0.0, 0.0, origin[0], origin[1], 0.0]),
        (_GEOKEYS, 3, [1, 1, 0, 3, 1024, 0, 1, 2, 1025, 0, 1, 1, 2048, 0, 1, 4326]),
    ]
    codes = {3: "H", 4: "I", 12: "d"}
    ifd_size = 2 + 12 * len(entries) + 4
    extra_at = 8 + ifd_size
    payloads = [struct.pack("<" + codes[t] * len(v), *v) for _, t, v in entries]
    extra_len = sum(len(p) for p in payloads if len(p) > 4)
    data_at = extra_at + extra_len
    entries[5] = (_STRIP_OFFSETS, 4, [data_at])
    payloads[5] = struct.pack("<I", data_at)
    head = bytearray(b"II" + struct.pack("<HI", 42, 8) + struct.pack("<H", len(entries)))
    extra = bytearray()
    for (tag, typ, values), payload in zip(entries, payloads):
        head += struct.pack("<HHI", tag, typ, len(values))
        if len(payload) <= 4:
            head += payload.ljust(4, b"\0")
        else:
            head += struct.pack("<I", extra_at + len(extra))
            extra += payload
    head += struct.pack("<I", 0)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "wb") as f:
        f.write(head)
        f.write(extra)
        f.write(arr.data)


def _make_buildings(rng: np.random.Generator, h: int, w: int, n_steps: int) -> list:
    """A time series of binary building rasters; footprints only grow."""
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


def scene_shape(p: dict, aoi_index: int) -> tuple:
    """The (h, w) of the ``aoi_index``-th AOI: shapes vary to exercise
    padding."""
    h0, w0 = p["scene_size"]
    return h0 + 8 * (aoi_index % 3), w0 + 8 * (aoi_index % 2)


def aois(p: dict) -> dict:
    """AOI id -> labeled, labeled first, in the generator's order."""
    return {**{a: True for a in p["labeled"]}, **{a: False for a in p["unlabeled"]}}


def dates(p: dict) -> list:
    return [(2019 + t // 12, 1 + t % 12) for t in range(p["n_timestamps"])]


def generate(root: Path, p: dict) -> dict:
    """Write the tree; returns its metadata (the generator's draws)."""
    rng = np.random.default_rng(p["seed"])
    metadata = {}
    for idx, (aoi, labeled) in enumerate(aois(p).items()):
        h, w = scene_shape(p, idx)
        buildings = _make_buildings(rng, h, w, p["n_timestamps"])
        stamps = []
        for t, (year, month) in enumerate(dates(p)):
            base = buildings[t].astype(np.float32)
            s1 = rng.uniform(0, 0.6, size=(h, w, N_S1_BANDS)).astype(np.float32)
            s1 += 0.3 * base[:, :, None]
            s2 = rng.uniform(0, 0.4, size=(h, w, N_S2_BANDS)).astype(np.float32)
            s2 += 0.4 * base[:, :, None]
            if t == 0:   # a NaN and a value above 1: nan_to_num and clip
                s1[0, 0, 0] = np.nan
                s2[0, 1, 0] = 1.7
            stem = f"{aoi}_{year}_{month:02d}.tif"
            write_tif(root / aoi / "s1" / f"s1_{stem}", s1)
            write_tif(root / aoi / "s2" / f"s2_{stem}", s2)
            if labeled:
                write_tif(root / aoi / "buildings" / f"buildings_{stem}", buildings[t])
            stamps.append({"year": year, "month": month, "s1": True, "s2": True,
                           "buildings": labeled, "masked": False})
        metadata[aoi] = stamps
    (root / "metadata.json").write_text(json.dumps(metadata))
    return metadata


def ensure(p: dict | None = None, data_dir: Path = DATA_DIR) -> Path:
    """The root of the fixture of ``p`` (default ``fixture.json``), written
    first if ``data_dir`` lacks it (into a side directory renamed into
    place, so a cut run leaves no half tree)."""
    p = params() if p is None else p
    digest = hashlib.sha256(json.dumps(p, sort_keys=True).encode()).hexdigest()[:12]
    root = data_dir / f"fixture-{digest}"
    marker = root / "COMPLETE"
    if marker.exists() and json.loads(marker.read_text()) == p:
        return root
    partial = data_dir / f"partial-{digest}"
    shutil.rmtree(partial, ignore_errors=True)
    shutil.rmtree(root, ignore_errors=True)
    generate(partial, p)
    (partial / "COMPLETE").write_text(json.dumps(p))
    os.replace(partial, root)
    return root


def fixture_bytes(p: dict) -> int:
    """Bytes of GeoTIFF pixels the tree holds (headers are ~300 B a file)."""
    total = 0
    for idx, (_, labeled) in enumerate(aois(p).items()):
        h, w = scene_shape(p, idx)
        per_date = h * w * 4 * (N_S1_BANDS + N_S2_BANDS) + (h * w if labeled else 0)
        total += per_date * p["n_timestamps"]
    return total
