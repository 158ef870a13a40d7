"""Semi-supervised (cross-modal consistency) training CLI of the port.

Same contract as the port's train_supervised.py (the JAX package's
train_semisupervised.py, the reference's script)::

    python -m multimodal_siamese_cd_tpu_torch.train_semisupervised \\
        -c <config> -p <wandb-project> -o <out-dir> -d <dataset-dir> \\
        [--device cpu] [KEY VALUE ...]

Use a whatevernet-family config (e.g. siamese_mmcr_alpha0500) or
dtsiamese_ssl. Trains on the CUDA card unless ``--device`` names another
torch device.
"""

from multimodal_siamese_cd_tpu_torch.train_supervised import run_cli


def main(argv=None) -> None:
    run_cli('semisupervised', argv)


if __name__ == '__main__':
    main()
