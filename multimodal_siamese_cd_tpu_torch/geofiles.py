"""Geo raster / JSON file I/O (the port's own copy of the JAX package's).

Same public surface as the reference (utils/geofiles.py:8-111):
``read_tif``, ``write_tif``, ``get_coords``, ``basename_from_file``,
``id2yx``, ``combine_tif_patches``, ``load_json``, ``write_json`` —
implemented over the package's GeoTIFF codec (:mod:`.geotiff`) instead of
rasterio/GDAL.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from . import geotiff


def read_tif(file: Path):
    """Read a GeoTIFF as ``((H, W, C) array, transform, crs)``.

    Mirrors reference geofiles.py:8-17 (which reads bands-first via rasterio
    then transposes; our codec is (H, W, C) natively).
    """
    file = Path(file)
    if not file.exists():
        raise FileNotFoundError(f'File {file} not found')
    arr, meta = geotiff.imread(file)
    return arr, meta["transform"], meta["crs"]


def write_tif(file: Path, arr: np.ndarray, transform, crs) -> None:
    """Write an (H, W[, C]) array as a GeoTIFF (reference geofiles.py:21-43)."""
    file = Path(file)
    if not file.parent.exists():
        file.parent.mkdir(parents=True)
    geotiff.imwrite(file, arr, transform=transform, crs=crs)


def get_coords(file: Path) -> list:
    """Patch-grid coordinates from a ``{base}_{i:010d}-{j:010d}.tif`` name
    (reference geofiles.py:46-51)."""
    file_parts = Path(file).stem.split('_')
    coord_part = file_parts[-1]
    return [int(coord) for coord in coord_part.split('-')]


def basename_from_file(file: Path) -> str:
    """Strip the trailing coordinate part from a patch filename
    (reference geofiles.py:54-58)."""
    file_parts = Path(file).stem.split('_')
    return '_'.join(file_parts[:-1])


def id2yx(patch_id: str) -> tuple:
    """Parse an ``{y}-{x}`` patch id (reference geofiles.py:61-63)."""
    y, x = patch_id.split('-')
    return int(y), int(x)


def combine_tif_patches(folder: Path, basename: str, delete_tiles: bool = False,
                        dtype=np.int8) -> None:
    """Mosaic ``{basename}_{i:010d}-{j:010d}.tif`` tiles back into one raster
    (reference geofiles.py:66-100). Tiles must be square and share a size;
    the output keeps the upper-left tile's georeferencing."""
    folder = Path(folder)
    files = [f for f in folder.glob('**/*') if f.is_file() and basename_from_file(f) == basename]
    coords = [get_coords(f) for f in files]
    max_i = max(c[0] for c in coords)
    max_j = max(c[1] for c in coords)

    ul_file = folder / f'{basename}_{0:010d}-{0:010d}.tif'
    ul_arr, transform, crs = read_tif(ul_file)
    tile_height, tile_width, n_bands = ul_arr.shape
    assert tile_height == tile_width
    tile_size = tile_height

    lr_file = folder / f'{basename}_{max_i:010d}-{max_j:010d}.tif'
    lr_arr, _, _ = read_tif(lr_file)
    lr_height, lr_width, _ = lr_arr.shape

    mosaic = np.full((max_i + lr_height, max_j + lr_width, n_bands),
                     fill_value=-1, dtype=dtype)
    for file in files:
        tile, _, _ = read_tif(file)
        i_start, j_start = get_coords(file)
        mosaic[i_start:i_start + tile_size, j_start:j_start + tile_size] = tile
        if delete_tiles:
            file.unlink()

    write_tif(folder / f'{basename}.tif', mosaic, transform, crs)


def load_json(file: Path):
    with open(str(file)) as f:
        try:
            return json.load(f)
        except json.JSONDecodeError as e:
            # name the file: a corrupt metadata.json otherwise surfaces a
            # bare position with no hint which file to fix
            raise ValueError(f"Corrupt JSON in {file}: {e}") from None


def write_json(file: Path, data) -> None:
    with open(str(file), 'w', encoding='utf-8') as f:
        json.dump(data, f, ensure_ascii=False, indent=4)
