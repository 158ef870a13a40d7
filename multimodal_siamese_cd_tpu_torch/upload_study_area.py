"""Google Earth Engine study-area export CLI (the root
``upload_study_area.py`` on the port).

    python -m multimodal_siamese_cd_tpu_torch.upload_study_area \\
        -s <spacenet7-dir> [-c base] [KEY VALUE ...]

An ee-free core assembles per-AOI records (origin in the source CRS, split
and labeled tags from the config's AOI lists); a thin Earth Engine layer
turns them into a FeatureCollection export to Drive. The flags and the
exported schema (properties ``aoi_id`` / ``split`` / ``labeled``, a GeoJSON
table ``siamese_ssl_aoi_ids`` in the Drive folder ``siamese_ssl``) are the
root script's. ``ee`` is imported only where the export runs, so this
module imports without Earth Engine; the export itself needs the
``earthengine-api`` package and the network. Runs no model.
"""

from __future__ import annotations

from pathlib import Path

from . import experiment_manager, geofiles, parsers, spacenet7

EXPORT_SPEC = dict(
    description='siameseSSLstudyArea',
    folder='siamese_ssl',
    fileNamePrefix='siamese_ssl_aoi_ids',
    fileFormat='GeoJSON',
)

# Config list -> (split tag, labeled flag); AOIs on no list are the
# unlabeled pool and ride along tagged as unlabeled training area.
SPLIT_SOURCES = (
    ('TRAINING_IDS', 'training', 1),
    ('VALIDATION_IDS', 'validation', 1),
    ('TEST_IDS', 'test', 1),
)
DEFAULT_ASSIGNMENT = ('training', 0)


def split_assignment(cfg, aoi_id: str) -> tuple:
    """(split, labeled) for one AOI, driven by the config's split lists."""
    for key, split, labeled in SPLIT_SOURCES:
        if aoi_id in cfg.DATASET[key]:
            return split, labeled
    return DEFAULT_ASSIGNMENT


def aoi_centroid(spacenet7_path: str, dataset: str, aoi_id: str) -> tuple:
    """((x, y), crs) of an AOI's origin in its source projection, read from
    the affine transform of its first masked image."""
    folder = Path(spacenet7_path) / dataset / aoi_id / 'images_masked'
    tif = sorted(f for f in folder.rglob('*') if f.is_file())[0]
    _, transform, crs = geofiles.read_tif(tif)
    _, _, c, _, _, f, *_ = transform
    return (c, f), crs


def study_area_records(cfg, spacenet7_path: str) -> list:
    """One dict per SpaceNet7 AOI: location and split/labeled tags. Needs
    no Earth Engine; this is the exported schema."""
    records = []
    for dataset in ('train', 'test'):
        for aoi_id in spacenet7.get_all_aoi_ids(spacenet7_path, dataset):
            (x, y), crs = aoi_centroid(spacenet7_path, dataset, aoi_id)
            split, labeled = split_assignment(cfg, aoi_id)
            records.append({'aoi_id': aoi_id, 'split': split,
                            'labeled': labeled, 'x': x, 'y': y,
                            'crs': str(crs)})
    return records


def export_records(records: list):
    """The only Earth-Engine-touching step: records -> FeatureCollection ->
    Drive table export. Returns the started task."""
    import ee

    features = [
        ee.Feature(
            ee.Geometry.Point(coords=[r['x'], r['y']],
                              proj=r['crs']).transform(),
            {'aoi_id': r['aoi_id'], 'split': r['split'],
             'labeled': r['labeled']})
        for r in records
    ]
    task = ee.batch.Export.table.toDrive(
        collection=ee.FeatureCollection(features), **EXPORT_SPEC)
    task.start()
    return task


def upload_study_area(spacenet7_path: str, config_name: str = 'base') -> None:
    cfg = experiment_manager.load_cfg(config_name)
    export_records(study_area_records(cfg, spacenet7_path))


# the module-level name the reference exposes (upload_study_area.py:47)
metadata_argument_parser = parsers.metadata_argument_parser


def main(argv=None) -> None:
    args = metadata_argument_parser().parse_known_args(argv)[0]
    try:
        import ee
    except ImportError:
        raise SystemExit("earthengine-api is not installed; "
                         "`pip install earthengine-api` to use this script.")
    ee.Initialize()
    upload_study_area(args.spacenet7_dir, args.config_file)


if __name__ == '__main__':
    main()
