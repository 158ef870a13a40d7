"""Processed-dataset metadata/timeseries helpers (the port's own copy of the
JAX package's ``dataset_helpers.py``).

Port of the usable intent of utils/dataset_helpers.py:6-186, adapted to the
live dataset layout (per-AOI dicts of timestamp records in metadata.json —
utils/datasets.py:115-119) and with the reference's internal bugs fixed:
the ``month == month`` tautology (dataset_helpers.py:37), the argless
``metadata()`` call (:101), and the argument-order drift in
``duration_timeseries`` (:68-74).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from . import geofiles


def bad_data(dataset_path: str) -> dict:
    return geofiles.load_json(Path(dataset_path) / 'bad_data.json')


def timestamps(dataset_path: str) -> dict:
    return geofiles.load_json(Path(dataset_path) / 'spacenet7_timestamps.json')


def metadata(dataset_path: str) -> dict:
    return geofiles.load_json(Path(dataset_path) / 'metadata.json')


def aoi_ids(dataset_path: str) -> list:
    return sorted(metadata(dataset_path).keys())


def aoi_metadata(dataset_path: str, aoi_id: str) -> list:
    return metadata(dataset_path)[aoi_id]


def metadata_index(dataset_path: str, aoi_id: str, year: int, month: int):
    for i, ts in enumerate(aoi_metadata(dataset_path, aoi_id)):
        if ts['year'] == year and ts['month'] == month:
            return i
    return None


def metadata_timestamp(dataset_path: str, aoi_id: str, year: int, month: int):
    for ts in aoi_metadata(dataset_path, aoi_id):
        if ts['year'] == year and ts['month'] == month:
            return ts
    return None


def date2index(date) -> int:
    """Months since 2019-01 (reference dataset_helpers.py:49-52)."""
    year, month = date[:2]
    return year * 12 + month - (2019 * 12 + 1)


def get_timeseries(dataset_path: str, aoi_id: str,
                   require_buildings: bool = False) -> list:
    """Usable (s1 ∧ s2 ∧ ¬masked) timestamps, optionally also requiring
    building labels (reference dataset_helpers.py:56-59 semantics on the
    live metadata schema)."""
    out = []
    for ts in aoi_metadata(dataset_path, aoi_id):
        if ts['s1'] and ts['s2'] and not ts['masked']:
            if not require_buildings or ts['buildings']:
                out.append((ts['year'], ts['month']))
    return out


def length_timeseries(dataset_path: str, aoi_id: str) -> int:
    return len(get_timeseries(dataset_path, aoi_id))


def get_date_from_index(dataset_path: str, aoi_id: str, index: int) -> tuple:
    return get_timeseries(dataset_path, aoi_id)[index]


def duration_timeseries(dataset_path: str, aoi_id: str) -> int:
    """Months between first and last usable timestamp (fixed version of
    reference dataset_helpers.py:68-74)."""
    start_year, start_month = get_date_from_index(dataset_path, aoi_id, 0)
    end_year, end_month = get_date_from_index(dataset_path, aoi_id, -1)
    return (end_year - start_year) * 12 + (end_month - start_month)


def get_geo(dataset_path: str, aoi_id: str) -> tuple:
    """(transform, crs) of an AOI's first S1 scene."""
    folder = Path(dataset_path) / aoi_id / 's1'
    file = sorted(f for f in folder.glob('**/*') if f.is_file())[0]
    _, transform, crs = geofiles.read_tif(file)
    return transform, crs


def date2str(date) -> str:
    year, month = date[:2]
    return f'{year - 2000:02d}-{month:02d}'


def load_label(dataset_path: str, aoi_id: str, year: int, month: int) -> np.ndarray:
    label_file = (Path(dataset_path) / aoi_id / 'buildings'
                  / f'buildings_{aoi_id}_{year}_{month:02d}.tif')
    label, _, _ = geofiles.read_tif(label_file)
    return np.squeeze(label > 0).astype(np.float32)


def load_label_in_timeseries(dataset_path: str, aoi_id: str, index: int) -> np.ndarray:
    year, month = get_timeseries(dataset_path, aoi_id, require_buildings=True)[index]
    return load_label(dataset_path, aoi_id, year, month)


def generate_change_label(dataset_path: str, aoi_id: str) -> np.ndarray:
    """Construction-only change between first and last labeled timestamp
    (reference dataset_helpers.py:165-171)."""
    label_start = load_label_in_timeseries(dataset_path, aoi_id, 0)
    label_end = load_label_in_timeseries(dataset_path, aoi_id, -1)
    return np.logical_and(label_start == 0, label_end == 1).astype(np.uint8)


def generate_train_test_split(dataset_path: str, split: float = 0.3,
                              seed: int = 7) -> tuple[list, list]:
    """Random AOI split (reference dataset_helpers.py:174-186); returns
    (train, test). Draws from a private legacy MT19937 stream
    (``RandomState``, equivalent to the reference's global
    ``np.random.seed(seed); np.random.rand(n)``) so regenerating the split
    reproduces the reference's exact AOI assignment — same guarantee as
    ``spacenet7.training_validation_split``."""
    ids = aoi_ids(dataset_path)
    rand = np.random.RandomState(seed).rand(len(ids))
    test = [a for a, r in zip(ids, rand) if r <= split]
    train = [a for a, r in zip(ids, rand) if r > split]
    return train, test
