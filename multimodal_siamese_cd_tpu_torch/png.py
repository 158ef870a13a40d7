"""Minimal PNG encoder (pure Python + zlib); the port's own copy of the JAX
package's ``png.py``, byte for byte the same output.

matplotlib/PIL are not dependencies of this package; qualitative
assessment figures are composed as numpy RGB arrays (:mod:`.visualization`)
and written with this encoder. Supports 8-bit grayscale, RGB, and RGBA.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

_COLOR_TYPES = {1: 0, 3: 2, 4: 6}  # channels -> PNG color type


def _chunk(tag: bytes, payload: bytes) -> bytes:
    return (struct.pack(">I", len(payload)) + tag + payload
            + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF))


def encode_png(arr: np.ndarray) -> bytes:
    """Encode (H, W), (H, W, 1), (H, W, 3) or (H, W, 4) uint8 to PNG bytes."""
    arr = np.asarray(arr)
    if arr.ndim == 2:
        arr = arr[:, :, None]
    if arr.dtype != np.uint8:
        raise ValueError(f"encode_png expects uint8, got {arr.dtype}")
    h, w, c = arr.shape
    if c not in _COLOR_TYPES:
        raise ValueError(f"Unsupported channel count {c}")
    ihdr = struct.pack(">IIBBBBB", w, h, 8, _COLOR_TYPES[c], 0, 0, 0)
    # filter byte 0 (None) per scanline
    raw = np.empty((h, 1 + w * c), np.uint8)
    raw[:, 0] = 0
    raw[:, 1:] = arr.reshape(h, w * c)
    idat = zlib.compress(raw.tobytes(), 6)
    return (b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", idat) + _chunk(b"IEND", b""))


def write_png(path: str | Path, arr: np.ndarray) -> Path:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_bytes(encode_png(arr))
    return path


def read_png(path: str | Path) -> np.ndarray:
    """Decode a PNG written by :func:`write_png` (8-bit, filter 0 only) —
    test/verification helper, not a general decoder."""
    buf = Path(path).read_bytes()
    assert buf[:8] == b"\x89PNG\r\n\x1a\n", "not a PNG"
    pos = 8
    idat = b""
    w = h = c = None
    while pos < len(buf):
        (length,) = struct.unpack_from(">I", buf, pos)
        tag = buf[pos + 4:pos + 8]
        payload = buf[pos + 8:pos + 8 + length]
        if tag == b"IHDR":
            w, h, depth, color_type, *_ = struct.unpack(">IIBBBBB", payload)
            assert depth == 8
            c = {0: 1, 2: 3, 6: 4}[color_type]
        elif tag == b"IDAT":
            idat += payload
        pos += 12 + length
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + w * c)
    assert (raw[:, 0] == 0).all(), "only filter 0 supported"
    return raw[:, 1:].reshape(h, w, c)
