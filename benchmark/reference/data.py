"""The reference's own reading of the fixture: the GeoTIFFs by offset, the
dataset's documented semantics (band lists, ``clip(0, 1)``,
``nan_to_num``, imagery stored as float16, buildings as ``> 0``,
construction-only change ``t1 == 0 and t2 == 1``), the padded full-scene
input and the search that places a delivered training crop in its scene.
Nothing here imports the port."""

from __future__ import annotations

import json
import struct
from functools import lru_cache
from pathlib import Path

import numpy as np

_DTYPES = {(3, 32): np.float32, (1, 8): np.uint8}


def read_tif(path) -> np.ndarray:
    """An uncompressed single-strip chunky TIFF as (H, W, C)."""
    buf = Path(path).read_bytes()
    if buf[:4] != b"II*\0":
        raise ValueError(f"{path}: not a little-endian classic TIFF")
    (ifd,) = struct.unpack_from("<I", buf, 4)
    (n,) = struct.unpack_from("<H", buf, ifd)
    tags = {}
    for i in range(n):
        tag, typ, count, value = struct.unpack_from("<HHII", buf, ifd + 2 + 12 * i)
        if typ == 3 and count <= 2:
            value = struct.unpack_from("<H", buf, ifd + 2 + 12 * i + 8)[0]
        tags[tag] = value
    if tags.get(259, 1) != 1:
        raise ValueError(f"{path}: compressed")
    h, w, c = tags[257], tags[256], tags[277]
    bits = struct.unpack_from("<H", buf, tags[258])[0] if c > 2 else tags[258]
    fmt = struct.unpack_from("<H", buf, tags[339])[0] if c > 2 else tags[339]
    dtype = _DTYPES[(fmt, bits)]
    return np.frombuffer(buf, dtype, h * w * c, tags[273]).reshape(h, w, c)


class Fixture:
    """The fixture tree at ``root`` under a config's band lists."""

    def __init__(self, root, s1_bands, s2_bands, building_labels: bool = False):
        self.root = Path(root)
        self.metadata = json.loads((self.root / "metadata.json").read_text())
        self.s1_bands, self.s2_bands = list(s1_bands), list(s2_bands)
        self.building_labels = building_labels

    def labeled(self, aoi: str) -> bool:
        return all(t["buildings"] for t in self.metadata[aoi])

    def dates(self, aoi: str) -> list:
        return [(t["year"], t["month"]) for t in self.metadata[aoi]]

    @lru_cache(maxsize=64)
    def planes(self, aoi: str, modality: str, year: int, month: int) -> np.ndarray:
        """(C, H, W): imagery as float16 after band selection, clip and
        nan_to_num; buildings as uint8 {0, 1}."""
        img = read_tif(self.root / aoi / modality / f"{modality}_{aoi}_{year}_{month:02d}.tif")
        if modality == "buildings":
            return (np.nan_to_num(img) > 0).astype(np.uint8).transpose(2, 0, 1)
        bands = self.s1_bands if modality == "s1" else self.s2_bands
        out = np.nan_to_num(np.clip(img[:, :, bands], 0, 1)).astype(np.float16)
        return np.ascontiguousarray(out.transpose(2, 0, 1))

    def stack(self, aoi: str, d1: tuple, d2: tuple) -> np.ndarray:
        """The full-scene training stack ``[s1_t1 | s1_t2 | s2_t1 | s2_t2 |
        buildings_t1 | buildings_t2 | change]`` (C, H, W) float16; label
        planes zero for an unlabeled AOI, the building planes zero unless
        the config includes building labels."""
        img = [self.planes(aoi, "s1", *d1), self.planes(aoi, "s1", *d2),
               self.planes(aoi, "s2", *d1), self.planes(aoi, "s2", *d2)]
        h, w = img[0].shape[1:]
        if self.labeled(aoi):
            b1 = self.planes(aoi, "buildings", *d1)[0]
            b2 = self.planes(aoi, "buildings", *d2)[0]
            change = ((b1 == 0) & (b2 == 1)).astype(np.uint8)
            if not self.building_labels:
                b1, b2 = np.zeros_like(b1), np.zeros_like(b2)
            labels = np.stack([b1, b2, change]).astype(np.float16)
        else:
            labels = np.zeros((3, h, w), np.float16)
        return np.concatenate(img + [labels])

    def scene_input(self, aoi: str, d1: tuple, d2: tuple, bucket: int) -> dict:
        """One scene pair zero-padded up to multiples of ``bucket``: float32
        (C, Hp, Wp) per date, the change truth and the valid mask (Hp, Wp)."""
        full = self.stack(aoi, d1, d2)
        n1, n2 = len(self.s1_bands), len(self.s2_bands)
        h, w = full.shape[1:]
        hp, wp = -(-h // bucket) * bucket, -(-w // bucket) * bucket
        out = {}
        for key, chans in (("x1", [*range(n1), *range(2 * n1, 2 * n1 + n2)]),
                           ("x2", [*range(n1, 2 * n1), *range(2 * n1 + n2, 2 * n1 + 2 * n2)])):
            x = np.zeros((len(chans), hp, wp), np.float32)
            x[:, :h, :w] = full[chans]
            out[key] = x
        out["y"] = np.zeros((hp, wp), np.uint8)
        out["y"][:h, :w] = full[-1]
        out["valid"] = np.zeros((hp, wp), np.uint8)
        out["valid"][:h, :w] = 1
        out["shape"] = (h, w)
        return out


def locate(scene: np.ndarray, crop: np.ndarray) -> tuple | None:
    """The ``(y, x)`` at which ``crop`` (C, S, S) equals ``scene``'s window
    (C, H, W) in every plane, or None."""
    s = crop.shape[-1]
    h, w = scene.shape[1:]
    if h < s or w < s:
        return None
    first = scene[0, :h - s + 1, :w - s + 1]
    cand = np.argwhere(first == crop[0, 0, 0])
    for dy, dx in ((0, 1), (1, 0), (s - 1, s - 1), (s // 2, s // 3)):
        if not len(cand):
            return None
        keep = scene[0, cand[:, 0] + dy, cand[:, 1] + dx] == crop[0, dy, dx]
        cand = cand[keep]
    for y, x in cand:
        if np.array_equal(scene[:, y:y + s, x:x + s], crop):
            return int(y), int(x)
    return None
