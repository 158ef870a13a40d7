"""Dual-task model assessment CLI: change, change from semantics, semantics
(the root ``assessment_semantics.py`` on the port).

    python -m multimodal_siamese_cd_tpu_torch.assessment_semantics \\
        -c <config> -o <out-dir> -d <dataset-dir> [-r validation] \\
        [--device cpu] [KEY VALUE ...]

Quantitative protocol (reference assessment_semantics.py:99-152): pixel
probabilities pooled over every scene of the split, strict threshold
``p > 0.5``, three blocks printed (Change / Change Sem / Sem). Runs on the
card unless ``--device cpu`` asks for the CPU.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from . import (checkpoints, evaluation, experiment_manager, metrics, parsers,
               visualization)
from .data.dataset import MultimodalCDDataset
from .device import resolve_device

_BLOCKS = (('Change', 'change'), ('Change Sem', 'change_sem'), ('Sem', 'sem'))


def _dataset(cfg, run_type):
    return MultimodalCDDataset(cfg, run_type, dataset_mode='first_last',
                               no_augmentations=True, disable_unlabeled=True,
                               disable_multiplier=True)


def qualitative_assessment_change(cfg, run_type: str = 'test', device=None) -> None:
    """(reference assessment_semantics.py:11-50)"""
    model, _, _ = checkpoints.load_checkpoint(cfg.INFERENCE_CHECKPOINT, cfg,
                                              device=device)
    for item in _dataset(cfg, run_type):
        out = evaluation.dualtask_scene_outputs(
            model, item, bucket=evaluation.eval_bucket(cfg), device=device)
        panels = [[
            visualization.imagery_panel(item['x_t1'], cfg),
            visualization.imagery_panel(item['x_t2'], cfg),
            visualization.gray_rgb(item['y_change']),
            visualization.gray_rgb(out['change_sem']),
            visualization.gray_rgb(out['change']),
        ]]
        out_file = (Path(cfg.PATHS.OUTPUT) / 'plots' / 'assessment_change_ssl'
                    / f"{item['aoi_id']}.png")
        visualization.save_figure(
            out_file, panels, title=f"{cfg.NAME} {item['aoi_id']}",
            col_titles=['t1', 't2', 'GT change', 'change from sem', 'change'])


def qualitative_assessment_sem(cfg, run_type: str = 'validation', device=None) -> None:
    """(reference assessment_semantics.py:53-96)"""
    model, _, _ = checkpoints.load_checkpoint(cfg.INFERENCE_CHECKPOINT, cfg,
                                              device=device)
    for item in _dataset(cfg, run_type):
        out = evaluation.dualtask_scene_outputs(
            model, item, bucket=evaluation.eval_bucket(cfg), device=device)
        panels = [
            [visualization.imagery_panel(item['x_t1'], cfg),
             visualization.gray_rgb(item['y_sem_t1']),
             visualization.gray_rgb(out['sem_t1'])],
            [visualization.imagery_panel(item['x_t2'], cfg),
             visualization.gray_rgb(item['y_sem_t2']),
             visualization.gray_rgb(out['sem_t2'])],
        ]
        out_file = (Path(cfg.PATHS.OUTPUT) / 'plots' / 'assessment_sem_ssl'
                    / f"{item['aoi_id']}.png")
        visualization.save_figure(
            out_file, panels, title=f"{cfg.NAME} {item['aoi_id']}",
            col_titles=['image', 'GT sem', 'pred sem'],
            row_labels=['t1', 't2'])


def _print_block(title: str, f1, p, r) -> None:
    print(f'--{title}--')
    print(f'F1 score: {f1:.3f} - Precision: {p:.3f} - Recall {r:.3f}')


def quantitative_assessment(cfg, run_type: str = 'validation', device=None) -> dict:
    """(reference assessment_semantics.py:99-152) Prints the three blocks
    and returns ``{'change'|'change_sem'|'sem': (f1, precision, recall)}``.

    The pooled counts come from the confusion kernel's strict rule on the
    device, per scene, summed on the host in float64: counting then
    summing equals pooling then counting. With the scene cache on they
    stream over wire groups
    (:func:`..evaluation.dualtask_quantitative_counts`); without it over
    the float32 items (:func:`..evaluation.dualtask_item_counts`). Only on
    the CPU does the cache-disabled path take the reference's shape: every
    scene's probabilities pooled on the host and scored with the numpy
    ``*_from_prob`` metrics."""
    print(cfg.NAME)
    device = resolve_device(device)
    model, _, _ = checkpoints.load_checkpoint(cfg.INFERENCE_CHECKPOINT, cfg,
                                              device=device)
    ds = _dataset(cfg, run_type)
    bucket = evaluation.eval_bucket(cfg)
    counts = evaluation.dualtask_quantitative_counts(model, ds, bucket=bucket,
                                                     device=device)
    if counts is None and device.type != 'cpu':
        counts = evaluation.dualtask_item_counts(model, ds, bucket=bucket,
                                                 device=device)
    results = {}
    if counts is not None:
        for title, key in _BLOCKS:
            results[key] = metrics.prob_metrics_from_counts(*counts[key])
            _print_block(title, *results[key])
        return results

    predictions = {'change': [], 'change_sem': [], 'sem': []}
    truths = {'change': [], 'sem': []}
    for item in ds:
        out = evaluation.dualtask_scene_outputs(model, item, bucket=bucket,
                                                device=device)
        truths['sem'].extend([item['y_sem_t1'].ravel(), item['y_sem_t2'].ravel()])
        truths['change'].append(item['y_change'].ravel())
        predictions['change'].append(out['change'].ravel())
        predictions['change_sem'].append(out['change_sem'].ravel())
        predictions['sem'].extend([out['sem_t1'].ravel(), out['sem_t2'].ravel()])
    truths = {k: np.concatenate(v) > 0.5 for k, v in truths.items()}
    for title, key in _BLOCKS:
        probs = np.concatenate(predictions[key])
        gt = truths['sem' if key == 'sem' else 'change']
        results[key] = (metrics.f1_score_from_prob(probs, gt),
                        metrics.precision_from_prob(probs, gt),
                        metrics.recall_from_prob(probs, gt))
        _print_block(title, *results[key])
    return results


def main(argv=None) -> None:
    parser = parsers.assessment_argument_parser()
    parser.set_defaults(run_type='validation')
    args = parser.parse_known_args(argv)[0]
    cfg = experiment_manager.setup_cfg(args)
    quantitative_assessment(cfg, run_type=args.run_type, device=args.device)


if __name__ == '__main__':
    main()
