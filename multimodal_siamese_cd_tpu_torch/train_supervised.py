"""Supervised change-detection training CLI of the port.

Same contract as the reference train_supervised.py::

    python -m multimodal_siamese_cd_tpu_torch.train_supervised \\
        -c <config> -p <wandb-project> -o <out-dir> -d <dataset-dir> \\
        [--device cpu] [KEY VALUE ...]

Trains on the CUDA card unless ``--device`` names another torch device.
On several cards, one process per card::

    MSCD_DISTRIBUTED=1 torchrun --nproc_per_node=N \\
        -m multimodal_siamese_cd_tpu_torch.train_supervised -c <config> ...

(:mod:`multimodal_siamese_cd_tpu_torch.parallel`; ``TRAINER.BATCH_SIZE``
is the global batch).
"""

import os
import sys

from multimodal_siamese_cd_tpu_torch import (experiment_manager, parallel,
                                             parsers, trainers, wandb_compat)


def main(argv=None) -> None:
    run_cli('supervised', argv)


def run_cli(regime: str, argv=None) -> None:
    """Parse the training CLI's arguments and train ``cfg`` in ``regime``
    (shared by the supervised, semi-supervised and dual-task entry
    scripts)."""
    args = parsers.training_argument_parser().parse_known_args(argv)[0]
    cfg = experiment_manager.setup_cfg(args)

    trainers.seed_everything(cfg.SEED)
    # a multi-process run (MSCD_DISTRIBUTED=1 under torchrun) logs from
    # rank 0 alone
    trainers.training_grid(cfg)

    wandb_compat.init(
        name=cfg.NAME,
        config=cfg,
        entity='multimodal_siamese_cd',
        project=args.project,
        tags=['ssl', 'cd', 'siamese', 'spacenet7'],
        mode='online' if not cfg.DEBUG and parallel.rank() == 0 else 'disabled',
        out_dir=cfg.PATHS.OUTPUT,
    )

    try:
        trainers.run_training(cfg, regime, device=args.device)
    except KeyboardInterrupt:
        try:
            sys.exit(0)
        except SystemExit:
            os._exit(0)
    finally:
        wandb_compat.finish()
        parallel.shutdown()


if __name__ == '__main__':
    main()
