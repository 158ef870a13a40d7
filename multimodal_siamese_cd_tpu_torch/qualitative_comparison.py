"""Multi-model qualitative comparison figures CLI (the root
``qualitative_comparison.py`` on the port).

    python -m multimodal_siamese_cd_tpu_torch.qualitative_comparison \\
        -c <config> [<config> ...] -o <out-dir> -d <dataset-dir> \\
        [--device cpu] [KEY VALUE ...]

PNG grid figures: per-AOI rows of [t1, t2, GT] followed by one prediction
column per config, with optional zoom windows and TP/FP/FN coloring
(reference qualitative_comparison.py:25-167). ``-c`` takes a LIST of config
names; each loads ``{out}/networks/{name}_checkpoint{INFERENCE_CHECKPOINT}
.pt``. The trailing ``KEY VALUE`` overrides, which the root script accepts
and drops, apply here to every config. Runs on the card unless ``--device
cpu`` asks for the CPU.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from . import (checkpoints, evaluation, experiment_manager, parsers, spacenet7,
               visualization)
from .data.dataset import MultimodalCDDataset


def _setup(config_name: str, output_dir, dataset_dir, opts) -> tuple:
    """The config (its file, then ``opts``) and its test split."""
    cfg = experiment_manager.setup_cfg_manual(config_name, Path(output_dir),
                                              Path(dataset_dir))
    cfg.merge_from_list(list(opts))
    ds = MultimodalCDDataset(cfg, 'test', dataset_mode='first_last',
                             no_augmentations=True, disable_unlabeled=True,
                             disable_multiplier=True)
    return cfg, ds


def _predict_change(model, ds, aoi_id, cfg, device):
    index = ds.get_index(aoi_id)
    if index is None:
        raise KeyError(f"AOI {aoi_id!r} is not in {cfg.NAME}'s test split")
    item = ds[index]
    probs = evaluation.scene_probabilities(model, item,
                                           bucket=evaluation.eval_bucket(cfg),
                                           device=device)
    return item, (probs > 0.5).astype(np.uint8)


def qualitative_comparison(config_names: list, output_dir: str, dataset_dir: str,
                           aoi_ids: list, device=None, opts=()) -> Path:
    """(reference qualitative_comparison.py:25-69)"""
    rows = [[None] * (3 + len(config_names)) for _ in aoi_ids]
    for j, config_name in enumerate(config_names):
        print(config_name)
        cfg, ds = _setup(config_name, output_dir, dataset_dir, opts)
        model, _, _ = checkpoints.load_checkpoint(cfg.INFERENCE_CHECKPOINT, cfg,
                                                  device=device)
        for i, aoi_id in enumerate(aoi_ids):
            item, pred = _predict_change(model, ds, aoi_id, cfg, device)
            rows[i][3 + j] = visualization.gray_rgb(pred)
            if j == 0:
                rows[i][0] = visualization.imagery_panel(item['x_t1'], cfg)
                rows[i][1] = visualization.imagery_panel(item['x_t2'], cfg)
                rows[i][2] = visualization.gray_rgb(item['y_change'])
    out_file = Path(output_dir) / 'plots' / 'qualitative_comparison.png'
    return visualization.save_figure(
        out_file, rows, col_titles=['t1', 't2', 'GT'] + list(config_names),
        row_labels=list(aoi_ids))


def qualitative_comparison_zoom(config_names: list, output_dir: str,
                                dataset_dir: str, aoi_ids: list, zooms: list,
                                colored: bool = False, device=None,
                                opts=()) -> Path:
    """Zoomed comparison with optional TP/FP/FN coloring (reference
    qualitative_comparison.py:105-167). A zoom ``(i, j, s)`` is the window
    ``[i:i+s, j:j+s]`` of the processed scene (``s`` None: to the scene's
    end); GT comes from the dataset item itself."""
    rows = [[None] * (3 + len(config_names)) for _ in aoi_ids]
    for j, config_name in enumerate(config_names):
        print(config_name)
        cfg, ds = _setup(config_name, output_dir, dataset_dir, opts)
        model, _, _ = checkpoints.load_checkpoint(cfg.INFERENCE_CHECKPOINT, cfg,
                                                  device=device)
        for i, (aoi_id, zoom) in enumerate(zip(aoi_ids, zooms)):
            item, pred = _predict_change(model, ds, aoi_id, cfg, device)
            i_start, j_start, s = zoom
            if s is None:
                i_end, j_end = item['y_change'].shape[:2]
            else:
                i_end, j_end = i_start + s, j_start + s
            window = np.s_[i_start:i_end, j_start:j_end]
            gt = item['y_change'][..., 0][window]
            pred_w = pred[window]
            if colored:
                classification = visualization.get_misclassifications(pred_w, gt)
                rows[i][3 + j] = visualization.classification_rgb(classification)
            else:
                rows[i][3 + j] = visualization.gray_rgb(pred_w)
            if j == 0:
                rows[i][0] = visualization.imagery_panel(item['x_t1'][window], cfg)
                rows[i][1] = visualization.imagery_panel(item['x_t2'][window], cfg)
                rows[i][2] = visualization.gray_rgb(gt)
    suffix = 'zoom_colored' if colored else 'zoom'
    out_file = Path(output_dir) / 'plots' / f'qualitative_comparison_{suffix}.png'
    return visualization.save_figure(
        out_file, rows, col_titles=['t1', 't2', 'GT'] + list(config_names),
        row_labels=list(aoi_ids))


def qualitative_comparison_zoom_selector(output_dir: str, dataset_dir: str,
                                         aoi_ids: list, zooms: list) -> Path:
    """Zoom-window preview over the raw SpaceNet7 Planet data (reference
    qualitative_comparison.py:72-102); runs no model."""
    rows = []
    for aoi_id, zoom in zip(aoi_ids, zooms):
        i_start, j_start, s = zoom
        if s is None:
            i_end, j_end = spacenet7.get_shape(dataset_dir, aoi_id)
        else:
            i_end, j_end = i_start + s, j_start + s
        window = np.s_[i_start:i_end, j_start:j_end]
        row = [None] * 5
        for index in (0, -1):
            year, month = spacenet7.get_date_from_index(dataset_dir, aoi_id, index)
            img = spacenet7.load_planet_mosaic(dataset_dir, aoi_id, year, month)
            row[0 if index == 0 else 2] = visualization.to_uint8(
                img[window][:, :, :3], 0, max(float(img.max()), 1.0))
            gt_sem = spacenet7.load_semantics_label(dataset_dir, aoi_id, year, month)
            row[1 if index == 0 else 3] = visualization.gray_rgb(gt_sem[window])
        gt_change = spacenet7.load_change_label_indices(dataset_dir, aoi_id, 0, -1)
        row[4] = visualization.gray_rgb(gt_change[window])
        rows.append(row)
    out_file = Path(output_dir) / 'plots' / 'zoom_selector.png'
    return visualization.save_figure(
        out_file, rows,
        col_titles=['planet t1', 'sem t1', 'planet t2', 'sem t2', 'change'],
        row_labels=list(aoi_ids))


# Default AOI/zoom selections from the reference __main__
# (qualitative_comparison.py:219-228).
DEFAULT_AOI_IDS = [
    'L15-0457E-1135N_1831_3648_13',
    'L15-1479E-1101N_5916_3785_13',
    'L15-1672E-1207N_6691_3363_13',
]
DEFAULT_ZOOMS = [
    (400, 100, 200),
    (0, 0, 300),
    (0, 150, 750),
]


def main(argv=None, aoi_ids=DEFAULT_AOI_IDS, zooms=DEFAULT_ZOOMS) -> Path:
    """The CLI: the colored zoom figure over ``aoi_ids`` and ``zooms`` (the
    reference's selection unless a caller names its own)."""
    args = parsers.comparison_argument_parser().parse_known_args(argv)[0]
    return qualitative_comparison_zoom(args.config_files, args.output_dir,
                                       args.dataset_dir, aoi_ids, zooms,
                                       colored=True, device=args.device,
                                       opts=args.opts or ())


if __name__ == '__main__':
    main()
