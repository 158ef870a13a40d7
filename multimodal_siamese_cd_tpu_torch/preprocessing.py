"""Dataset preprocessing CLI: build ``metadata.json`` for a processed dataset
tree (the root ``preprocessing.py`` on the port).

    python -m multimodal_siamese_cd_tpu_torch.preprocessing -d <dataset-dir>

Scans ``{root}/{aoi}/{s1,s2,buildings}`` for ``{mod}_{aoi}_{year}_{month:02d}
.tif`` files and writes the metadata.json schema the dataset reads
(reference utils/datasets.py:115-119: per AOI, a list of ``{year, month,
s1, s2, buildings, masked}`` records; ``masked`` from ``bad_data.json``
where the tree has one). Runs no model.
"""

from __future__ import annotations

from pathlib import Path

from . import geofiles, parsers


def _scan_modality(aoi_dir: Path, modality: str) -> set:
    folder = aoi_dir / modality
    dates = set()
    if folder.exists():
        for f in folder.glob(f"{modality}_*.tif"):
            parts = f.stem.split("_")
            dates.add((int(parts[-2]), int(parts[-1])))
    return dates


def create_metadata_file(dataset_path: str) -> dict:
    root = Path(dataset_path)
    bad = {}
    bad_file = root / "bad_data.json"
    if bad_file.exists():
        bad = geofiles.load_json(bad_file)

    metadata = {}
    for aoi_dir in sorted(p for p in root.iterdir() if p.is_dir()
                          and not p.name.startswith(".")):
        aoi_id = aoi_dir.name
        s1 = _scan_modality(aoi_dir, "s1")
        s2 = _scan_modality(aoi_dir, "s2")
        buildings = _scan_modality(aoi_dir, "buildings")
        all_dates = sorted(s1 | s2 | buildings, key=lambda d: d[0] * 12 + d[1])
        if not all_dates:
            continue
        bad_dates = {tuple(d) for d in bad.get(aoi_id, [])}
        metadata[aoi_id] = [
            {
                "year": year,
                "month": month,
                "s1": (year, month) in s1,
                "s2": (year, month) in s2,
                "buildings": (year, month) in buildings,
                "masked": (year, month) in bad_dates,
            }
            for year, month in all_dates
        ]

    geofiles.write_json(root / "metadata.json", metadata)
    print(f"metadata.json written for {len(metadata)} AOIs under {root}")
    return metadata


def main(argv=None) -> dict:
    args = parsers.preprocess_argument_parser().parse_known_args(argv)[0]
    return create_metadata_file(args.dataset)


if __name__ == "__main__":
    main()
