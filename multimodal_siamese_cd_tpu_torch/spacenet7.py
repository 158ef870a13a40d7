"""Raw SpaceNet7 (Planet) dataset helpers (the port's own copy of the JAX
package's ``spacenet7.py``).

Covers the live surface of the reference's utils/spacenet7_helpers.py:6-108
— date parsing, AOI enumeration over the raw SpaceNet7 train/test tree,
UDM-mask checks, Planet mosaic + rasterized label loading, construction-only
change labels, and the split generator that produced the config AOI lists.

The whole module is host-side path glue around one external contract: the
SpaceNet7 directory layout. That contract is therefore expressed once, as a
declarative asset table (``_ASSETS``) consumed by a single resolver
(``asset_path``), rather than as per-function path arithmetic.

Layout (fixed by the public dataset, not by this repo)::

    {root}/{train|test}/{aoi_id}/
        images_masked/ global_monthly_{y}_{m:02d}_mosaic_{aoi}.tif
        UDM_masks/     global_monthly_{y}_{m:02d}_mosaic_{aoi}_UDM.tif
        labels_raster/ global_monthly_{y}_{m:02d}_mosaic_{aoi}_Buildings.tif
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from . import geofiles

# asset kind -> (subdirectory under the AOI folder, filename suffix after
# the shared "global_monthly_{y}_{m:02d}_mosaic_{aoi}" stem)
_ASSETS = {
    "mosaic": ("images_masked", ""),
    "udm": ("UDM_masks", "_UDM"),
    "buildings": ("labels_raster", "_Buildings"),
}

_STEM = "global_monthly_{year}_{month:02d}_mosaic_{aoi_id}"


def asset_path(spacenet7_path: str, aoi_id: str, kind: str,
               year: int, month: int) -> Path:
    """Resolve one dated asset of ``aoi_id`` per the ``_ASSETS`` table."""
    subdir, suffix = _ASSETS[kind]
    stem = _STEM.format(year=year, month=month, aoi_id=aoi_id)
    return (_aoi_dir(spacenet7_path, aoi_id) / subdir
            / f"{stem}{suffix}.tif")


def _aoi_dir(spacenet7_path: str, aoi_id: str) -> Path:
    return (Path(spacenet7_path) / get_dataset(spacenet7_path, aoi_id)
            / aoi_id)


def file2date(file: Path) -> tuple:
    """Parse (year, month) back out of the shared filename stem
    (reference spacenet7_helpers.py:6-9)."""
    _, _, year, month = Path(file).stem.split("_")[:4]
    return int(year), int(month)


def get_all_aoi_ids(spacenet7_path: str, dataset: str = "train") -> list:
    parent = Path(spacenet7_path) / dataset
    return sorted(f.name for f in parent.iterdir() if f.is_dir())


def get_dataset(spacenet7_path: str, aoi_id: str) -> str:
    """Which top-level subset ('train'/'test') holds ``aoi_id``."""
    in_train = aoi_id in get_all_aoi_ids(spacenet7_path, "train")
    return "train" if in_train else "test"


def is_masked(spacenet7_path: str, aoi_id: str, year: int, month: int) -> bool:
    """A month is unusable when Planet shipped a UDM cloud/defect mask."""
    return asset_path(spacenet7_path, aoi_id, "udm", year, month).exists()


def get_all_dates(spacenet7_path: str, aoi_id: str,
                  sort_by_date: bool = True) -> list:
    """All UDM-clean (year, month) timestamps of ``aoi_id``, chronological
    by default."""
    mosaic_dir = _aoi_dir(spacenet7_path, aoi_id) / _ASSETS["mosaic"][0]
    dates = [file2date(f) for f in mosaic_dir.glob("**/*") if f.is_file()]
    clean = [d for d in dates if not is_masked(spacenet7_path, aoi_id, *d)]
    return sorted(clean, key=lambda d: d[0] * 12 + d[1]) if sort_by_date \
        else clean


def get_date_from_index(spacenet7_path: str, aoi_id: str, index: int) -> tuple:
    return get_all_dates(spacenet7_path, aoi_id)[index]


def load_planet_mosaic(spacenet7_path: str, aoi_id: str,
                       year: int, month: int) -> np.ndarray:
    img, _, _ = geofiles.read_tif(
        asset_path(spacenet7_path, aoi_id, "mosaic", year, month))
    return img


def get_shape(spacenet7_path: str, aoi_id: str) -> tuple:
    first = get_date_from_index(spacenet7_path, aoi_id, 0)
    return load_planet_mosaic(spacenet7_path, aoi_id, *first).shape[:2]


def load_semantics_label(spacenet7_path: str, aoi_id: str,
                         year: int, month: int) -> np.ndarray:
    """Binarized rasterized building footprints for one month."""
    label, _, _ = geofiles.read_tif(
        asset_path(spacenet7_path, aoi_id, "buildings", year, month))
    return (label > 0)[:, :, 0].astype(np.float32)


def compute_change(semantics_t1: np.ndarray,
                   semantics_t2: np.ndarray) -> np.ndarray:
    """Construction-only change (reference spacenet7_helpers.py:64-66)."""
    built = semantics_t2 == 1
    was_empty = semantics_t1 == 0
    return (was_empty & built).astype(np.float32)


def load_change_label_dates(spacenet7_path: str, aoi_id: str, year_t1: int,
                            month_t1: int, year_t2: int,
                            month_t2: int) -> np.ndarray:
    sem = [load_semantics_label(spacenet7_path, aoi_id, y, m)
           for y, m in ((year_t1, month_t1), (year_t2, month_t2))]
    return compute_change(*sem)


def load_change_label_indices(spacenet7_path: str, aoi_id: str,
                              index_t1: int, index_t2: int) -> np.ndarray:
    dates = get_all_dates(spacenet7_path, aoi_id)
    (y1, m1), (y2, m2) = dates[index_t1], dates[index_t2]
    return load_change_label_dates(spacenet7_path, aoi_id, y1, m1, y2, m2)


def training_validation_split(spacenet7_path: str, split: float = 0.3,
                              seed: int = 7) -> tuple[list, list]:
    """The split generator that produced the config AOI lists (reference
    spacenet7_helpers.py:84-97); returns (training, validation).

    Reproduction-faithful: the reference drew from the legacy global
    MT19937 stream (``np.random.seed(seed); np.random.rand(n)``), so the
    same draw is taken from a private ``RandomState`` (bit-identical
    sequence, no global-state pollution) — regenerating splits yields the
    reference's exact AOI assignment for the same seed."""
    aoi_ids = get_all_aoi_ids(spacenet7_path, "train")
    draw = np.random.RandomState(seed).rand(len(aoi_ids))
    is_val = draw <= split
    validation = [a for a, v in zip(aoi_ids, is_val) if v]
    training = [a for a, v in zip(aoi_ids, is_val) if not v]
    return training, validation


def _print_aoi_list(title: str, aoi_ids: list) -> None:
    print(f"--{title}--")
    for aoi_id in aoi_ids:
        print(f"'{aoi_id}',")


def print_training_validation_split(spacenet7_path: str, split: float = 0.3,
                                    seed: int = 7) -> None:
    training, validation = training_validation_split(spacenet7_path, split,
                                                     seed)
    _print_aoi_list("validation", validation)
    _print_aoi_list("training", training)


def print_test_aoi_ids(spacenet7_path: str) -> None:
    _print_aoi_list("test", get_all_aoi_ids(spacenet7_path, "test"))
