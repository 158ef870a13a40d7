"""Dual-task (change + building semantics) training CLI of the port.

Same contract as the port's train_supervised.py (the JAX package's
train_supervised_dualtask.py, the intended behaviour of the reference's
script)::

    python -m multimodal_siamese_cd_tpu_torch.train_supervised_dualtask \\
        -c <config> -p <wandb-project> -o <out-dir> -d <dataset-dir> \\
        [--device cpu] [KEY VALUE ...]

Use a dtsiameseunet config with INCLUDE_BUILDING_LABELS (e.g. dtsiamese).
Trains on the CUDA card unless ``--device`` names another torch device.
"""

from multimodal_siamese_cd_tpu_torch.train_supervised import run_cli


def main(argv=None) -> None:
    run_cli('dualtask', argv)


if __name__ == '__main__':
    main()
