"""Offline change-detection assessment CLI (the root ``assessment_change.py``
on the port).

    python -m multimodal_siamese_cd_tpu_torch.assessment_change -c <config> \\
        -o <out-dir> -d <dataset-dir> [-r test] [--device cpu] [KEY VALUE ...]

Loads ``{out}/networks/{NAME}_checkpoint{INFERENCE_CHECKPOINT}.pt`` and
prints F1, precision and recall over the split's full scenes at threshold
0.5 (``evaluation.inference_loop``: the confusion kernel's rounding rule on
the card). Runs on the card unless ``--device cpu`` asks for the CPU.
"""

from __future__ import annotations

from pathlib import Path

from . import checkpoints, evaluation, experiment_manager, parsers, visualization
from .data.dataset import MultimodalCDDataset


def _dataset(cfg, run_type: str) -> MultimodalCDDataset:
    return MultimodalCDDataset(cfg, run_type, no_augmentations=True,
                               dataset_mode='first_last', disable_multiplier=True,
                               disable_unlabeled=True)


def qualitative_assessment(cfg, run_type: str = 'test', device=None) -> None:
    """Per-AOI figure of a dual-task model: inputs, GT and predicted
    semantics, GT and predicted change (reference assessment_change.py:
    10-48), written as PNG grids to ``{OUTPUT}/plots/change/{NAME}/``."""
    print(cfg.NAME)
    model, _, _ = checkpoints.load_checkpoint(cfg.INFERENCE_CHECKPOINT, cfg,
                                              device=device)
    for item in _dataset(cfg, run_type):
        out = evaluation.dualtask_scene_outputs(
            model, item, bucket=evaluation.eval_bucket(cfg), device=device)
        panels = [
            [visualization.imagery_panel(item['x_t1'], cfg),
             visualization.gray_rgb(item['y_sem_t1']),
             visualization.gray_rgb(out['sem_t1']),
             visualization.gray_rgb(item['y_change'])],
            [visualization.imagery_panel(item['x_t2'], cfg),
             visualization.gray_rgb(item['y_sem_t2']),
             visualization.gray_rgb(out['sem_t2']),
             visualization.gray_rgb(out['change'])],
        ]
        out_file = (Path(cfg.PATHS.OUTPUT) / 'plots' / 'change' / cfg.NAME
                    / f"{item['aoi_id']}.png")
        visualization.save_figure(out_file, panels)


def quantitative_assessment(cfg, run_type: str = 'test', device=None) -> tuple:
    """F1 / precision / recall over the split (reference
    assessment_change.py:51-61), printed; returns ``(f1, precision,
    recall)``."""
    print(cfg.NAME)
    model, _, _ = checkpoints.load_checkpoint(cfg.INFERENCE_CHECKPOINT, cfg,
                                              device=device)
    data = evaluation.inference_loop(model, _dataset(cfg, run_type),
                                     bucket=evaluation.eval_bucket(cfg),
                                     device=device)
    f1, precision, recall = data['change']
    print(f'F1 score: {f1:.3f} - Precision: {precision:.3f} - Recall {recall:.3f}')
    return data['change']


def main(argv=None) -> None:
    args = parsers.assessment_argument_parser().parse_known_args(argv)[0]
    cfg = experiment_manager.setup_cfg(args)
    quantitative_assessment(cfg, run_type=args.run_type, device=args.device)


if __name__ == '__main__':
    main()
