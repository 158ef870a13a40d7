"""Visual dataset spot-check CLI (the root ``sanity_check.py`` on the port).

    python -m multimodal_siamese_cd_tpu_torch.sanity_check -c <config> \\
        -d <dataset-dir> [-r training] [-n 5] [-o sanity_checks] [KEY VALUE ...]

Writes PNG panels of S2 / S1 imagery at both dates plus the change label
for the first samples of a split, as the training path sees them: crops
with flips, rotations and photometric jitter
(:meth:`..data.dataset.MultimodalCDDataset.augmented_item`). Runs no model;
the trailing ``KEY VALUE`` overrides apply to the config.
"""

from __future__ import annotations

import argparse
from pathlib import Path

from . import experiment_manager, visualization
from .data.dataset import MultimodalCDDataset


def sanity_check_dataset(config_name: str, dataset_dir: str = None,
                         run_type: str = 'training', n_samples: int = 5,
                         out_dir: str = 'sanity_checks', opts=()) -> list:
    cfg = experiment_manager.load_cfg(config_name)
    cfg.merge_from_list(list(opts))
    if dataset_dir is not None:
        cfg.PATHS.DATASET = str(dataset_dir)
    ds = MultimodalCDDataset(cfg, run_type, no_augmentations=False,
                             disable_multiplier=True)
    files = []
    for index in range(min(n_samples, len(ds))):
        item = ds[index]
        # one row per modality the config carries (items hold only the
        # INPUT_MODE bands)
        s1_t1, s2_t1 = visualization.split_modalities(item['x_t1'], cfg)
        s1_t2, s2_t2 = visualization.split_modalities(item['x_t2'], cfg)
        panels = []
        if s2_t1 is not None and s2_t1.shape[2] >= 3:
            panels.append([visualization.to_uint8(s2_t1[:, :, :3], 0, 0.3),
                           visualization.to_uint8(s2_t2[:, :, :3], 0, 0.3),
                           visualization.gray_rgb(item['y_change'])])
        if s1_t1 is not None:
            panels.append([visualization.sar_gray(s1_t1, 0),
                           visualization.sar_gray(s1_t2, 0)])
        if s2_t1 is None or s2_t1.shape[2] < 3:
            # no optical row: keep the change label beside the imagery the
            # config does carry
            panels.insert(0, [visualization.imagery_panel(item['x_t1'], cfg),
                              visualization.imagery_panel(item['x_t2'], cfg),
                              visualization.gray_rgb(item['y_change'])])
        out_file = Path(out_dir) / f"{config_name}_{run_type}_{index}.png"
        files.append(visualization.save_figure(out_file, panels))
        print(f"wrote {files[-1]}")
    return files


def argument_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Dataset sanity check")
    parser.add_argument('-c', '--config-file', dest='config_file', default='debug')
    parser.add_argument('-d', '--dataset-dir', dest='dataset_dir', default=None)
    parser.add_argument('-r', '--run-type', dest='run_type', default='training')
    parser.add_argument('-n', '--n-samples', dest='n_samples', type=int, default=5)
    parser.add_argument('-o', '--output-dir', dest='output_dir', default='sanity_checks')
    parser.add_argument('opts', default=None, nargs=argparse.REMAINDER,
                        help="Modify config options using the command-line")
    return parser


def main(argv=None) -> list:
    args = argument_parser().parse_args(argv)
    return sanity_check_dataset(args.config_file, args.dataset_dir, args.run_type,
                                args.n_samples, args.output_dir, args.opts or ())


if __name__ == '__main__':
    main()
