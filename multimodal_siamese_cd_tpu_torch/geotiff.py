"""Pure-Python/numpy GeoTIFF codec (the port's own copy of the JAX package's).

The reference reads rasters through rasterio/GDAL (utils/geofiles.py:8-43).
This environment has no GDAL, and the framework only needs a focused subset
of TIFF, so the codec is implemented here directly:

  read:  classic TIFF (II/MM), striped or tiled, chunky or planar,
         uint8/16/32, int8/16/32, float32/64, compression none / LZW /
         deflate (zip) / PackBits, horizontal-differencing predictor,
         GeoTIFF georeferencing (ModelPixelScale+Tiepoint or
         ModelTransformation, EPSG code from the GeoKey directory).
  write: striped chunky TIFF, deflate (default) or none, any of the above
         dtypes, with GeoTIFF tags for an affine transform + EPSG CRS.

Arrays are (H, W, C). Georeferencing is exposed as an :class:`Affine`
(a, b, c, d, e, f) with ``x = a*col + b*row + c`` — iteration order matches
rasterio's Affine so tuple-unpacking code keeps working — and a :class:`CRS`
wrapping an EPSG code.

Supported envelope (the reference reads through rasterio/GDAL, which accepts
anything — utils/geofiles.py:8-17; this codec covers the GDAL output space
SpaceNet7/Sentinel tiles live in, and REJECTS the rest loudly):

  * classic TIFF and BigTIFF (magic 43, 8-byte offsets — what GDAL emits
    for > 4 GiB rasters) on the READ side, libtiff-pinned; the writer
    emits classic only and refuses layouts that would cross 4 GiB.
  * GDAL sparse files: blocks with offset 0 / byte count 0 read as zeros
    (GDAL's missing-block semantics).
  * strips or tiles × chunky or planar (PlanarConfiguration 2) × none/
    LZW/deflate/PackBits × horizontal-differencing predictor (2) or the
    floating-point predictor (3, libtiff-pinned) in any combination.
  * unknown IFD entry field types are skipped (treated as absent), like
    libtiff; structurally corrupt or truncated files — IFD or block data
    out of bounds, short blocks, codec bitstream corruption — raise
    ``ValueError`` (never IndexError/struct.error; fuzzed in
    tests/test_geotiff_foreign.py).
"""

from __future__ import annotations

import importlib.util
import struct
import sysconfig
import zlib
from dataclasses import dataclass
from pathlib import Path

import numpy as np

# --- TIFF constants ---------------------------------------------------------

_TYPE_FORMATS = {
    1: ("B", 1), 2: ("c", 1), 3: ("H", 2), 4: ("I", 4), 5: ("II", 8),
    6: ("b", 1), 7: ("B", 1), 8: ("h", 2), 9: ("i", 4), 10: ("ii", 8),
    11: ("f", 4), 12: ("d", 8), 16: ("Q", 8), 17: ("q", 8), 18: ("Q", 8),
}

TAG_IMAGE_WIDTH = 256
TAG_IMAGE_LENGTH = 257
TAG_BITS_PER_SAMPLE = 258
TAG_COMPRESSION = 259
TAG_PHOTOMETRIC = 262
TAG_STRIP_OFFSETS = 273
TAG_SAMPLES_PER_PIXEL = 277
TAG_ROWS_PER_STRIP = 278
TAG_STRIP_BYTE_COUNTS = 279
TAG_PLANAR_CONFIG = 284
TAG_PREDICTOR = 317
TAG_TILE_WIDTH = 322
TAG_TILE_LENGTH = 323
TAG_TILE_OFFSETS = 324
TAG_TILE_BYTE_COUNTS = 325
TAG_SAMPLE_FORMAT = 339
TAG_MODEL_PIXEL_SCALE = 33550
TAG_MODEL_TIEPOINT = 33922
TAG_MODEL_TRANSFORMATION = 34264
TAG_GEO_KEY_DIRECTORY = 34735
TAG_GEO_DOUBLE_PARAMS = 34736
TAG_GEO_ASCII_PARAMS = 34737

COMPRESSION_NONE = 1
COMPRESSION_LZW = 5
COMPRESSION_DEFLATE_ADOBE = 8
COMPRESSION_PACKBITS = 32773
COMPRESSION_DEFLATE = 32946

GEOKEY_MODEL_TYPE = 1024
GEOKEY_RASTER_TYPE = 1025
GEOKEY_GEOGRAPHIC_TYPE = 2048
GEOKEY_PROJECTED_CS_TYPE = 3072

SAMPLEFORMAT_UINT = 1
SAMPLEFORMAT_INT = 2
SAMPLEFORMAT_FLOAT = 3


# --- Georeferencing types ---------------------------------------------------

@dataclass(frozen=True)
class Affine:
    """Row-major affine geotransform: x = a*col + b*row + c; y = d*col + e*row + f.

    Iterates as (a, b, c, d, e, f) — the order rasterio's Affine iterates in,
    which the reference relies on (upload_study_area.py:11: ``_, _, c, _, _,
    f, *_ = transform``).
    """

    a: float
    b: float
    c: float
    d: float
    e: float
    f: float

    def __iter__(self):
        return iter((self.a, self.b, self.c, self.d, self.e, self.f))

    @classmethod
    def identity(cls) -> "Affine":
        return cls(1.0, 0.0, 0.0, 0.0, 1.0, 0.0)

    @classmethod
    def from_origin(cls, west: float, north: float, xsize: float, ysize: float) -> "Affine":
        return cls(xsize, 0.0, west, 0.0, -ysize, north)

    def __mul__(self, colrow):
        col, row = colrow
        return (self.a * col + self.b * row + self.c,
                self.d * col + self.e * row + self.f)


@dataclass(frozen=True)
class CRS:
    """Coordinate reference system identified by an EPSG code."""

    epsg: int = 4326

    def __str__(self) -> str:
        return f"EPSG:{self.epsg}"

    @classmethod
    def from_user_input(cls, value) -> "CRS":
        if isinstance(value, CRS):
            return value
        if value is None:
            return cls()
        if isinstance(value, int):
            return cls(value)
        s = str(value).strip().upper()
        if s.startswith("EPSG:"):
            return cls(int(s.split(":", 1)[1]))
        raise ValueError(f"Cannot parse CRS from {value!r}")


# --- Compression codecs -----------------------------------------------------
# Optional native decoders (``python -m multimodal_siamese_cd_tpu_torch.
# build_native`` compiles native/fastcodecs.c into NATIVE_DIR); the
# pure-Python decoders below keep everything working without a compiler.
NATIVE_DIR = Path(__file__).resolve().parent.parent / "build" / "native"


def native_path(directory: Path | None = None) -> Path:
    """Where the native decoders' extension is built: ``_fastcodecs`` with
    this interpreter's extension suffix, in ``directory`` (default
    :data:`NATIVE_DIR`)."""
    suffix = sysconfig.get_config_var("EXT_SUFFIX")
    return Path(directory or NATIVE_DIR) / f"_fastcodecs{suffix}"


def load_native(directory: Path | None = None):
    """The native decoders' module built in ``directory`` (default
    :data:`NATIVE_DIR`), or None when it is not there or does not load."""
    path = native_path(directory)
    if not path.exists():
        return None
    spec = importlib.util.spec_from_file_location("_fastcodecs", path)
    module = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(module)
    except ImportError:
        return None
    return module


_fastcodecs = load_native()


def _packbits_decode(data: bytes, limit: int = 0) -> bytes:
    if _fastcodecs is not None:
        return _fastcodecs.packbits_decode(data, limit)
    return _packbits_decode_py(data, limit)


def _packbits_decode_py(data: bytes, limit: int = 0) -> bytes:
    out = bytearray()
    i, n = 0, len(data)
    while i < n:
        h = data[i]
        i += 1
        if h < 128:
            out += data[i:i + h + 1]
            i += h + 1
        elif h > 128:
            out += data[i:i + 1] * (257 - h)
            i += 1
        # h == 128: no-op
        if limit and len(out) > limit:
            raise ValueError(
                "Corrupt PackBits stream: output exceeds the block limit")
    return bytes(out)


def _lzw_decode(data: bytes, limit: int = 0) -> bytes:
    if _fastcodecs is not None:
        return _fastcodecs.lzw_decode(data, limit)
    return _lzw_decode_py(data, limit)


def _lzw_decode_py(data: bytes, limit: int = 0) -> bytes:
    """TIFF-variant LZW (MSB-first bit packing, early code-width change).
    ``limit`` > 0 hard-caps the output (decompression-bomb guard)."""
    CLEAR, EOI = 256, 257
    out = bytearray()
    table: list[bytes] = []

    def reset_table():
        nonlocal table
        table = [bytes([i]) for i in range(256)] + [b"", b""]

    reset_table()
    bitpos = 0
    nbits = 9
    maxcode = (1 << nbits) - 1
    total_bits = len(data) * 8
    prev: bytes | None = None

    while bitpos + nbits <= total_bits:
        byte_idx = bitpos >> 3
        chunk = data[byte_idx:byte_idx + 4]
        val = int.from_bytes(chunk.ljust(4, b"\0"), "big")
        code = (val >> (32 - (bitpos & 7) - nbits)) & maxcode
        bitpos += nbits

        if code == EOI:
            break
        if code == CLEAR:
            reset_table()
            nbits = 9
            maxcode = (1 << nbits) - 1
            prev = None
            continue

        if prev is None:
            if code >= 256:
                raise ValueError("Corrupt LZW stream: non-literal first code")
            entry = table[code]
        elif code < len(table):
            entry = table[code]
            table.append(prev + entry[:1])
        elif code == len(table):
            entry = prev + prev[:1]
            table.append(entry)
        else:
            raise ValueError("Corrupt LZW stream: code out of range")
        out += entry
        if limit and len(out) > limit:
            raise ValueError(
                "Corrupt LZW stream: output exceeds the block limit")
        prev = entry
        # TIFF "early change", decoder side (libtiff tif_lzw.c rule): widen
        # when the NEXT free slot is one from the boundary — len(table) is
        # that slot, so at 511/1023/2047 entries the following code arrives
        # one bit wider. (The old `+ 2` widened one code early and desynced
        # on every real libtiff/GDAL stream at the 9->10-bit boundary;
        # verified against libtiff.so.6.)
        if len(table) + 1 >= (1 << nbits) and nbits < 12:
            nbits += 1
            maxcode = (1 << nbits) - 1
    return bytes(out)


def _decompress(data: bytes, compression: int, expected: int = 0) -> bytes:
    """Decode one block. ``expected`` (the block's uncompressed byte size,
    when the caller knows it) bounds the output so a corrupt or malicious
    bitstream cannot balloon memory (decompression-bomb guard); blocks may
    legitimately decode to slightly more than the valid area (padded last
    strips/tiles), so the bound is loose."""
    limit = expected * 2 + 65536 if expected else 0
    if compression == COMPRESSION_NONE:
        return data
    if compression in (COMPRESSION_DEFLATE, COMPRESSION_DEFLATE_ADOBE):
        try:
            if limit:
                d = zlib.decompressobj()
                out = d.decompress(data, limit)
                # unconsumed_tail: input left over after the output cap hit;
                # not d.eof: input fully consumed but over-limit output (or a
                # truncated stream) still pending inside the decompressor —
                # both mean the block does not decode cleanly within bounds.
                if d.unconsumed_tail or not d.eof:
                    raise ValueError(
                        f"Corrupt TIFF: deflate block inflates beyond "
                        f"{limit} bytes or is truncated (expected "
                        f"~{expected})")
                return out
            return zlib.decompress(data)
        except zlib.error as e:
            # zlib.error is NOT a ValueError; normalize to the module's
            # corrupt-input contract
            raise ValueError(f"Corrupt TIFF: deflate block: {e}") from None
    if compression == COMPRESSION_LZW:
        return _lzw_decode(data, limit)
    if compression == COMPRESSION_PACKBITS:
        return _packbits_decode(data, limit)
    raise NotImplementedError(f"TIFF compression {compression} not supported")


# --- Reader -----------------------------------------------------------------

class _TiffIFD:
    """IFD parser for classic TIFF and (``big=True``) BigTIFF: u64 entry
    count, 20-byte entries with u64 value counts, 8-byte inline values and
    u64 overflow offsets (BigTIFF spec / libtiff tif_dirread.c)."""

    def __init__(self, buf: bytes, order: str, offset: int, big: bool = False):
        self.buf = buf
        self.order = order
        self.big = big
        self._inline = 8 if big else 4
        try:
            if big:
                (n_entries,) = struct.unpack_from(order + "Q", buf, offset)
                if n_entries > 65535:  # classic's natural u16 bound; a
                    # forged u64 count would loop near-forever otherwise
                    raise ValueError(
                        f"Corrupt TIFF: implausible IFD entry count "
                        f"{n_entries}")
                pos = offset + 8
            else:
                (n_entries,) = struct.unpack_from(order + "H", buf, offset)
                pos = offset + 2
            self.tags: dict[int, tuple] = {}
            for _ in range(n_entries):
                tag, typ = struct.unpack_from(order + "HH", buf, pos)
                (count,) = struct.unpack_from(
                    order + ("Q" if big else "I"), buf, pos + 4)
                self.tags[tag] = (typ, count, pos + (12 if big else 8))
                pos += 20 if big else 12
            (self.next_ifd,) = struct.unpack_from(
                order + ("Q" if big else "I"), buf, pos)
        except struct.error as e:
            raise ValueError(f"Corrupt TIFF: IFD out of bounds ({e})") from None

    def value(self, tag: int, default=None):
        if tag not in self.tags:
            return default
        typ, count, value_pos = self.tags[tag]
        if typ not in _TYPE_FORMATS:
            # unknown field type: skip the entry like libtiff does
            return default
        fmt, size = _TYPE_FORMATS[typ]
        total = size * count
        if total <= self._inline:
            data_pos = value_pos
        else:
            (data_pos,) = struct.unpack_from(
                self.order + ("Q" if self.big else "I"), self.buf, value_pos)
        if data_pos + total > len(self.buf):
            raise ValueError(
                f"Corrupt TIFF: tag {tag} data [{data_pos}:{data_pos + total}] "
                f"beyond end of file ({len(self.buf)} bytes)")
        if typ == 2:  # ASCII
            raw = self.buf[data_pos:data_pos + count]
            return raw.rstrip(b"\0").decode("ascii", errors="replace")
        if typ in (5, 10):  # rationals
            vals = struct.unpack_from(self.order + ("I" if typ == 5 else "i") * 2 * count,
                                      self.buf, data_pos)
            return [vals[i] / vals[i + 1] if vals[i + 1] else 0.0
                    for i in range(0, 2 * count, 2)]
        vals = struct.unpack_from(self.order + fmt * count, self.buf, data_pos)
        return list(vals)

    def scalar(self, tag: int, default=None):
        v = self.value(tag, None)
        if v is None:
            return default
        return v[0] if isinstance(v, list) else v


def _dtype_from(bits: int, sample_format: int, order: str) -> np.dtype:
    bo = "<" if order == "<" else ">"
    kind = {SAMPLEFORMAT_UINT: "u", SAMPLEFORMAT_INT: "i", SAMPLEFORMAT_FLOAT: "f"}.get(
        sample_format)
    if kind is None:
        raise NotImplementedError(f"TIFF sample format {sample_format} not supported")
    if bits % 8 != 0 or bits // 8 not in (1, 2, 4, 8):
        raise NotImplementedError(f"TIFF bits-per-sample {bits} not supported")
    if kind == "f" and bits not in (32, 64):
        raise NotImplementedError(f"float{bits} TIFF not supported")
    return np.dtype(f"{bo}{kind}{bits // 8}")


def _undo_predictor(block: np.ndarray) -> np.ndarray:
    # Horizontal differencing: cumulative sum along the width axis.
    if block.dtype.kind == "f":
        raise ValueError(
            "predictor 2 on float samples is invalid (floats use 3)")
    return np.cumsum(block, axis=1, dtype=block.dtype)


def _undo_fp_predictor(raw: bytes, rows: int, n_vals_row: int,
                       itemsize: int, stride: int) -> bytes:
    """TIFF floating-point predictor (3): each row's sample bytes are
    stored as byte PLANES ordered MSB..LSB with byte-wise horizontal
    differencing at the sample stride (libtiff tif_predict.c fpAcc
    semantics — pinned against libtiff-written f32/f64 files). Returns
    little-endian sample bytes for the first ``rows`` rows.

    The plane order is MSB-first REGARDLESS of the file's II/MM byte mark:
    libtiff's decoder never byte-swaps after fpAcc, so this function's
    output is always interpreted little-endian. Big-endian fp-predictor
    files written by libtiff itself are unrecoverable-by-construction (its
    ENCODER swabs samples before the plane split, so even libtiff reads
    its own MM+predictor-3 output back as garbage — differential-fuzz
    find, tools/difffuzz_geotiff.py); this reader deliberately matches
    libtiff's READER bit-for-bit, which is what GDAL consumers see."""
    cc = n_vals_row * itemsize
    a = np.frombuffer(raw, np.uint8, count=rows * cc).reshape(rows, cc)
    acc = np.cumsum(a.reshape(rows, cc // stride, stride), axis=1,
                    dtype=np.uint8)  # uint8 cumsum == mod-256 accumulate
    planes = acc.reshape(rows, itemsize, n_vals_row)
    # plane 0 is the MSB: reverse to LSB-first, then interleave per value
    le = np.transpose(planes[:, ::-1, :], (0, 2, 1))
    return np.ascontiguousarray(le).tobytes()


def imread(path: str | Path) -> tuple[np.ndarray, dict]:
    """Read the first IFD of a TIFF into an (H, W, C) array.

    Returns ``(array, meta)`` where meta holds ``transform`` (:class:`Affine`
    or None), ``crs`` (:class:`CRS` or None), and raw geo tag values.
    """
    buf = Path(path).read_bytes()
    if len(buf) < 8:
        raise ValueError(f"Not a TIFF file: {path}")
    byte_order = buf[:2]
    if byte_order == b"II":
        order = "<"
    elif byte_order == b"MM":
        order = ">"
    else:
        raise ValueError(f"Not a TIFF file (bad byte order mark): {path}")
    (magic,) = struct.unpack_from(order + "H", buf, 2)
    if magic == 43:
        # BigTIFF (libtiff "w8"/GDAL BIGTIFF=YES): 8-byte offsets
        offsize, reserved = struct.unpack_from(order + "HH", buf, 4)
        if offsize != 8 or reserved != 0:
            raise ValueError(
                f"Corrupt BigTIFF: offset size {offsize}/reserved "
                f"{reserved} (expected 8/0): {path}")
        (ifd_offset,) = struct.unpack_from(order + "Q", buf, 8)
        ifd = _TiffIFD(buf, order, ifd_offset, big=True)
    elif magic == 42:
        (ifd_offset,) = struct.unpack_from(order + "I", buf, 4)
        ifd = _TiffIFD(buf, order, ifd_offset)
    else:
        raise ValueError(f"Not a TIFF file (magic {magic}, expected 42): {path}")

    width = ifd.scalar(TAG_IMAGE_WIDTH)
    height = ifd.scalar(TAG_IMAGE_LENGTH)
    if not width or not height:
        raise ValueError(f"Corrupt TIFF: missing image dimensions: {path}")
    spp = ifd.scalar(TAG_SAMPLES_PER_PIXEL, 1)
    bits_all = ifd.value(TAG_BITS_PER_SAMPLE) or (8,)
    if len(set(bits_all)) > 1:
        # heterogeneous per-channel depths: frombuffer with one dtype would
        # silently interleave garbage; reject loudly instead
        raise ValueError(
            f"Unsupported TIFF: heterogeneous BitsPerSample {bits_all}: {path}")
    bits = bits_all[0]
    photometric = ifd.scalar(TAG_PHOTOMETRIC, 1)
    if photometric not in (0, 1, 2):
        # palette indices / transparency masks / YCbCr / CMYK would decode
        # to values that are NOT pixel intensities — "rejects the rest
        # loudly" (palette files carry a ColorMap this codec does not apply)
        raise ValueError(
            f"Unsupported TIFF: PhotometricInterpretation {photometric} "
            f"(supported: 0/1 grayscale, 2 RGB): {path}")
    sample_format = ifd.scalar(TAG_SAMPLE_FORMAT, SAMPLEFORMAT_UINT)
    compression = ifd.scalar(TAG_COMPRESSION, COMPRESSION_NONE)
    predictor = ifd.scalar(TAG_PREDICTOR, 1)
    planar = ifd.scalar(TAG_PLANAR_CONFIG, 1)
    dtype = _dtype_from(bits, sample_format, order)

    # Hard plausibility caps BEFORE any allocation: the structural
    # block-count check below is satisfiable by a tiny forged file claiming
    # one enormous sparse tile (65535^2 -> one offset), and np.empty under
    # Linux overcommit "succeeds" then OOM-kills on first touch instead of
    # raising. Real SpaceNet7/Sentinel rasters are well under these bounds.
    MAX_SIDE = 1 << 17         # 131072 px per side
    MAX_IMAGE_BYTES = 1 << 34  # 16 GiB decoded
    if width > MAX_SIDE or height > MAX_SIDE or not 1 <= spp <= 1024:
        raise ValueError(
            f"Corrupt TIFF: implausible dimensions {height}x{width}x{spp} "
            f"(cap {MAX_SIDE} px/side, 1024 samples): {path}")
    if width * height * spp * dtype.itemsize > MAX_IMAGE_BYTES:
        raise ValueError(
            f"Corrupt TIFF: {height}x{width}x{spp}x{dtype.itemsize}B "
            f"exceeds the {MAX_IMAGE_BYTES >> 30} GiB decode cap: {path}")

    tiled = TAG_TILE_OFFSETS in ifd.tags
    if tiled:
        offsets = ifd.value(TAG_TILE_OFFSETS)
        counts = ifd.value(TAG_TILE_BYTE_COUNTS)
        tw = ifd.scalar(TAG_TILE_WIDTH)
        th = ifd.scalar(TAG_TILE_LENGTH)
        if not tw or not th:
            raise ValueError(f"Corrupt TIFF: tiled without tile dimensions: {path}")
        if tw > MAX_SIDE or th > MAX_SIDE or (
                tw * th * (1 if planar == 2 else spp) * dtype.itemsize
                > MAX_IMAGE_BYTES):
            raise ValueError(
                f"Corrupt TIFF: implausible tile size {th}x{tw}: {path}")
    else:
        offsets = ifd.value(TAG_STRIP_OFFSETS)
        counts = ifd.value(TAG_STRIP_BYTE_COUNTS)
        rps = ifd.scalar(TAG_ROWS_PER_STRIP, height)
        # image-clamp so an absurd RowsPerStrip can't void the per-strip
        # decompression-bomb cap (decode_block's nominal_rows)
        rps = min(rps, height)
        if rps <= 0:
            raise ValueError(f"Corrupt TIFF: non-positive RowsPerStrip: {path}")
    if not offsets or not counts:
        raise ValueError(f"Corrupt TIFF: no strip/tile offsets: {path}")

    n_planes = spp if planar == 2 else 1
    samples_per_block = 1 if planar == 2 else spp

    # Structural consistency BEFORE allocating: the block count implied by
    # the dimensions must match the offset table exactly — this is what a
    # well-formed writer emits, and it rejects corrupt/fuzzed dimension tags
    # (which otherwise demand absurd allocations) cheaply.
    if tiled:
        blocks_per_plane = (-(-width // tw)) * (-(-height // th))
    else:
        blocks_per_plane = -(-height // rps)
    n_blocks = blocks_per_plane * n_planes
    if len(offsets) != n_blocks or len(counts) != n_blocks:
        raise ValueError(
            f"Corrupt TIFF: {height}x{width}x{spp} (planar {planar}) implies "
            f"{n_blocks} blocks but the offset table has {len(offsets)}: {path}")
    try:
        out = np.empty((height, width, spp), dtype=dtype.newbyteorder("="))
    except MemoryError:
        raise ValueError(
            f"Corrupt TIFF: implausible dimensions "
            f"{height}x{width}x{spp}: {path}") from None

    def decode_block(idx: int, rows: int, cols: int,
                     nominal_rows: int | None = None) -> np.ndarray:
        if idx >= len(offsets) or idx >= len(counts):
            raise ValueError(
                f"Corrupt TIFF: block {idx} beyond the offset table "
                f"({len(offsets)} entries): {path}")
        n_vals = rows * cols * samples_per_block
        if offsets[idx] == 0 or counts[idx] == 0:
            # GDAL sparse file: a missing block reads as zeros
            return np.zeros((rows, cols, samples_per_block), dtype=dtype)
        if offsets[idx] + counts[idx] > len(buf):
            raise ValueError(
                f"Truncated TIFF: block {idx} "
                f"[{offsets[idx]}:{offsets[idx] + counts[idx]}] beyond end "
                f"of file ({len(buf)} bytes): {path}")
        # The bomb-guard cap must allow the block's NOMINAL size, not the
        # image-clamped remainder: writers may legitimately encode a final
        # strip padded to full RowsPerStrip (data past the image edge is
        # undefined per spec; np.frombuffer(count=n_vals) truncates it).
        cap_vals = (nominal_rows or rows) * cols * samples_per_block
        raw = _decompress(bytes(buf[offsets[idx]:offsets[idx] + counts[idx]]),
                          compression, expected=cap_vals * dtype.itemsize)
        if len(raw) < n_vals * dtype.itemsize:
            raise ValueError(
                f"Corrupt TIFF: block {idx} decodes to {len(raw)} bytes, "
                f"expected {n_vals * dtype.itemsize}: {path}")
        if predictor == 3:
            if dtype.kind != "f":
                raise ValueError(
                    f"Corrupt TIFF: predictor 3 on non-float samples: {path}")
            fixed = _undo_fp_predictor(raw, rows, cols * samples_per_block,
                                       dtype.itemsize, samples_per_block)
            block = np.frombuffer(fixed, np.dtype(f"<f{dtype.itemsize}"),
                                  count=n_vals)
        else:
            block = np.frombuffer(raw, dtype=dtype, count=n_vals)
        block = block.reshape(rows, cols * samples_per_block)
        if predictor == 2:
            block = block.reshape(rows, cols, samples_per_block)
            block = _undo_predictor(block).reshape(rows, cols * samples_per_block)
        elif predictor not in (1, 3):
            raise NotImplementedError(
                f"TIFF predictor {predictor} not supported")
        return block.reshape(rows, cols, samples_per_block)

    if tiled:
        tiles_across = -(-width // tw)
        tiles_down = -(-height // th)
        per_plane = tiles_across * tiles_down
        for plane in range(n_planes):
            for t in range(per_plane):
                ti, tj = divmod(t, tiles_across)
                block = decode_block(plane * per_plane + t, th, tw)
                rows = min(th, height - ti * th)
                cols = min(tw, width - tj * tw)
                dst = out[ti * th:ti * th + rows, tj * tw:tj * tw + cols]
                if planar == 2:
                    dst[:, :, plane] = block[:rows, :cols, 0]
                else:
                    dst[:] = block[:rows, :cols]
    else:
        strips_per_plane = -(-height // rps)
        for plane in range(n_planes):
            for s in range(strips_per_plane):
                row0 = s * rps
                rows = min(rps, height - row0)
                # nominal strip height caps the bomb guard (see decode_block);
                # rps is already image-clamped where it's parsed, so an absurd
                # RowsPerStrip cannot void the guard
                block = decode_block(plane * strips_per_plane + s, rows, width,
                                     nominal_rows=rps)
                if planar == 2:
                    out[row0:row0 + rows, :, plane] = block[:, :, 0]
                else:
                    out[row0:row0 + rows] = block

    meta = _read_geo(ifd)
    return out, meta


def _read_geo(ifd: _TiffIFD) -> dict:
    meta: dict = {"transform": None, "crs": None}
    scale = ifd.value(TAG_MODEL_PIXEL_SCALE)
    tiepoint = ifd.value(TAG_MODEL_TIEPOINT)
    matrix = ifd.value(TAG_MODEL_TRANSFORMATION)
    if matrix and len(matrix) >= 8:
        meta["transform"] = Affine(matrix[0], matrix[1], matrix[3],
                                   matrix[4], matrix[5], matrix[7])
    elif scale and tiepoint and len(scale) >= 2 and len(tiepoint) >= 6:
        i, j, _, x, y, _ = tiepoint[:6]
        sx, sy = scale[0], scale[1]
        meta["transform"] = Affine(sx, 0.0, x - i * sx, 0.0, -sy, y + j * sy)

    keys = ifd.value(TAG_GEO_KEY_DIRECTORY)
    if keys and len(keys) >= 4:
        n_keys = keys[3]
        kv = {}
        for k in range(n_keys):
            key_id, location, count, value = keys[4 + 4 * k:8 + 4 * k]
            if location == 0:
                kv[key_id] = value
        epsg = kv.get(GEOKEY_PROJECTED_CS_TYPE) or kv.get(GEOKEY_GEOGRAPHIC_TYPE)
        # 32767 is "user-defined" per the GeoTIFF spec — a custom CRS this
        # codec cannot express; crs stays None rather than minting a bogus
        # EPSG:32767 that a read-modify-write cycle would re-emit
        if epsg and 1024 <= epsg < 32768 + 32768 and epsg != 32767:
            meta["crs"] = CRS(int(epsg))
        meta["geokeys"] = kv
    return meta


# --- Writer -----------------------------------------------------------------

def _sample_format_of(dtype: np.dtype) -> int:
    return {"u": SAMPLEFORMAT_UINT, "i": SAMPLEFORMAT_INT,
            "f": SAMPLEFORMAT_FLOAT, "b": SAMPLEFORMAT_UINT}[dtype.kind]


def imwrite(path: str | Path, arr: np.ndarray,
            transform: Affine | None = None, crs: CRS | str | int | None = None,
            compression: str = "deflate", rows_per_strip: int | None = None) -> None:
    """Write an (H, W, C) or (H, W) array as a striped chunky (Geo)TIFF."""
    arr = np.asarray(arr)
    if arr.dtype == np.bool_:
        arr = arr.astype(np.uint8)
    if arr.ndim == 2:
        arr = arr[:, :, None]
    if arr.ndim != 3:
        raise ValueError(f"Expected (H, W[, C]) array, got shape {arr.shape}")
    height, width, spp = arr.shape
    arr = np.ascontiguousarray(arr, dtype=arr.dtype.newbyteorder("<"))

    comp_codes = {"none": COMPRESSION_NONE, "deflate": COMPRESSION_DEFLATE_ADOBE,
                  "zlib": COMPRESSION_DEFLATE_ADOBE}
    if compression not in comp_codes:
        raise ValueError(
            f"Unsupported write compression {compression!r}; supported: "
            f"{sorted(comp_codes)} (the READER additionally decodes "
            f"lzw/packbits, but this writer does not emit them)")
    comp_code = comp_codes[compression]
    if rows_per_strip is None:
        row_bytes = max(1, width * spp * arr.dtype.itemsize)
        rows_per_strip = max(1, min(height, (1 << 20) // row_bytes))
    n_strips = -(-height // rows_per_strip)

    strips = []
    for s in range(n_strips):
        chunk = arr[s * rows_per_strip:(s + 1) * rows_per_strip].tobytes()
        if comp_code != COMPRESSION_NONE:
            chunk = zlib.compress(chunk, 6)
        strips.append(chunk)

    entries: list[tuple[int, int, int, object]] = []  # (tag, type, count, value)

    def add(tag, typ, values):
        if not isinstance(values, (list, tuple, bytes)):
            values = [values]
        entries.append((tag, typ, len(values), values))

    add(TAG_IMAGE_WIDTH, 4, width)
    add(TAG_IMAGE_LENGTH, 4, height)
    add(TAG_BITS_PER_SAMPLE, 3, [arr.dtype.itemsize * 8] * spp)
    add(TAG_COMPRESSION, 3, comp_code)
    add(TAG_PHOTOMETRIC, 3, 1)  # BlackIsZero
    add(TAG_SAMPLES_PER_PIXEL, 3, spp)
    add(TAG_ROWS_PER_STRIP, 4, rows_per_strip)
    add(TAG_PLANAR_CONFIG, 3, 1)
    add(TAG_SAMPLE_FORMAT, 3, [_sample_format_of(arr.dtype)] * spp)

    if transform is not None:
        t = Affine(*transform) if not isinstance(transform, Affine) else transform
        if t.b == 0.0 and t.d == 0.0 and t.a > 0.0 and t.e < 0.0:
            # PixelScale+Tiepoint can only express the north-up x-east
            # orientation (ScaleX/ScaleY positive, y decreasing); an
            # axis-flipped transform (a<0 or e>0) must go through
            # ModelTransformation or the read-back georeferencing would be
            # silently mirrored
            add(TAG_MODEL_PIXEL_SCALE, 12, [t.a, -t.e, 0.0])
            add(TAG_MODEL_TIEPOINT, 12, [0.0, 0.0, 0.0, t.c, t.f, 0.0])
        else:
            add(TAG_MODEL_TRANSFORMATION, 12,
                [t.a, t.b, 0.0, t.c, t.d, t.e, 0.0, t.f,
                 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 1.0])
    if crs is not None:
        epsg = CRS.from_user_input(crs).epsg
        is_geographic = 4000 <= epsg < 5000
        model_type = 2 if is_geographic else 1
        cs_key = GEOKEY_GEOGRAPHIC_TYPE if is_geographic else GEOKEY_PROJECTED_CS_TYPE
        add(TAG_GEO_KEY_DIRECTORY, 3, [
            1, 1, 0, 3,
            GEOKEY_MODEL_TYPE, 0, 1, model_type,
            GEOKEY_RASTER_TYPE, 0, 1, 1,
            cs_key, 0, 1, epsg,
        ])

    # Two passes: compute layout, then emit.
    strip_offsets = [0] * n_strips
    add(TAG_STRIP_OFFSETS, 4, strip_offsets)
    add(TAG_STRIP_BYTE_COUNTS, 4, [len(s) for s in strips])
    entries.sort(key=lambda e: e[0])

    header_size = 8
    ifd_size = 2 + 12 * len(entries) + 4
    overflow_pos = header_size + ifd_size

    def encoded(values, typ):
        fmt, _ = _TYPE_FORMATS[typ]
        return struct.pack("<" + fmt * len(values), *values)

    overflow: list[bytes] = []
    pos = overflow_pos
    entry_payloads = []
    strip_offset_entry_idx = None
    for idx, (tag, typ, count, values) in enumerate(entries):
        if tag == TAG_STRIP_OFFSETS:
            strip_offset_entry_idx = idx
        data = encoded(values, typ)
        if len(data) <= 4:
            entry_payloads.append((None, data.ljust(4, b"\0")))
        else:
            entry_payloads.append((pos, data))
            overflow.append(data)
            pos += len(data) + (len(data) & 1)

    data_start = pos
    off = data_start
    for s in range(n_strips):
        strip_offsets[s] = off
        off += len(strips[s])
    if off > 0xFFFFFFFF:
        raise ValueError(
            f"Raster would need a {off}-byte file, beyond the 4 GiB classic "
            f"TIFF offset limit (this writer emits classic TIFF only, "
            f"though the reader decodes BigTIFF); split the raster or "
            f"write tiles")

    # Re-encode the strip-offsets entry now that offsets are known.
    tag, typ, count, _ = entries[strip_offset_entry_idx]
    data = encoded(strip_offsets, typ)
    o_pos, _ = entry_payloads[strip_offset_entry_idx]
    if len(data) <= 4:
        entry_payloads[strip_offset_entry_idx] = (None, data.ljust(4, b"\0"))
    else:
        entry_payloads[strip_offset_entry_idx] = (o_pos, data)

    out = bytearray()
    out += b"II" + struct.pack("<HI", 42, header_size)
    out += struct.pack("<H", len(entries))
    for (tag, typ, count, _values), (o_pos, data) in zip(entries, entry_payloads):
        out += struct.pack("<HHI", tag, typ, count)
        if o_pos is None:
            out += data
        else:
            out += struct.pack("<I", o_pos)
    out += struct.pack("<I", 0)  # no next IFD

    cursor = len(out)
    for (o_pos, data) in entry_payloads:
        if o_pos is not None:
            assert cursor == o_pos, (cursor, o_pos)
            out += data
            if len(data) & 1:
                out += b"\0"
            cursor = len(out)
    assert cursor == data_start, (cursor, data_start)
    for s in strips:
        out += s

    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_bytes(bytes(out))
