"""Padded-bucket against exact-shape evaluation F1 at the SpaceNet7 scale
(the JAX package's ``tools/eval_exactness.py``).

    python -m multimodal_siamese_cd_tpu_torch.eval_exactness [--skip-train]

The padded evaluation (``evaluation.EVAL_BUCKET`` 64, the default) zero-pads
scenes up to multiples of 64 and masks the padding out of the confusion
counts, but the network still sees the padding, so valid pixels within its
receptive field of a padded edge are predicted otherwise than by an
unpadded forward (``TRAINER.EVAL_PAD_MULTIPLE: 1``). This module puts a
number on the F1 difference at a trained checkpoint (random weights would
put every pixel at the threshold and overstate it):

  1. trains ``siameseunet`` briefly through ``convergence_run`` (320^2
     synthetic scenes, ``--multiplier`` 48, the checkpoint of epoch 1) into
     ``--out-dir``, unless ``--skip-train`` reuses the checkpoint there;
  2. writes a second synthetic split of ~1000^2 scenes (sides not multiples
     of 64);
  3. evaluates the checkpoint on it with bucket 64 and bucket 1, on the
     card (the confusion CUDA kernel counts both), and prints each split's
     F1 in both modes, the largest |dF1| (``eval_pad_f1_abs_delta``) and
     the wall times, in one JSON line naming the card.

``--device cpu`` runs it on the CPU, for the tests (the training CLI then
runs there too); without it the module needs the card and raises where
there is none. ``KEY VALUE`` overrides go to the training run and the
evaluation's config.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

from . import checkpoints, evaluation
from .config import load_cfg
from .data.dataset import MultimodalCDDataset
from .device import describe, resolve_device
from .wandb_compat import SINK_ENV

REPO = Path(__file__).resolve().parent.parent
VAL = [f"L15-synval{i}" for i in range(2)]
TEST = [f"L15-syntest{i}" for i in range(2)]


def train_checkpoint(out: Path, data: Path, multiplier: int, device: str | None,
                     opts: list) -> None:
    """One short supervised epoch through the training CLI (the checkpoint
    of epoch 1)."""
    cmd = [sys.executable, "-m", "multimodal_siamese_cd_tpu_torch.convergence_run",
           "--regime", "supervised", "--scene", "320",
           "--data-dir", str(data), "--out-dir", str(out),
           "--multiplier", str(multiplier), "--log-freq", "1000",
           "--save-checkpoints", "[1]"]
    if device is not None:
        cmd += ["--device", device]
    cmd += opts
    print("training:", " ".join(cmd), flush=True)
    subprocess.run(cmd, cwd=REPO, check=True, env={**os.environ, **SINK_ENV})


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--scene", type=int, default=1000,
                   help="eval scene base size; 1000 %% 64 != 0 forces padding")
    p.add_argument("--multiplier", type=int, default=48,
                   help="training steps for the throwaway checkpoint")
    p.add_argument("--out-dir", default=None,
                   help="default: a directory under the system's temporary one")
    p.add_argument("--skip-train", action="store_true",
                   help="reuse an existing checkpoint in --out-dir")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card; 'cpu' for the "
                        "tests)")
    p.add_argument("opts", nargs="*", metavar="KEY VALUE", help="config overrides")
    return p


def main(argv=None) -> int:
    p = parser()
    args = p.parse_args(argv)
    if len(args.opts) % 2:
        p.error("overrides must come in KEY VALUE pairs")
    device = resolve_device(args.device)
    tmp = Path(tempfile.gettempdir())
    out = Path(args.out_dir or tmp / "evex_out")
    if not args.skip_train:
        train_checkpoint(out, tmp / "convds320", args.multiplier, args.device,
                         args.opts)

    eval_data = tmp / f"evexds{args.scene}"
    if not (eval_data / "metadata.json").exists():
        from .data.synthetic import generate_fixture_dataset

        print(f"generating {args.scene}^2-class eval scenes...", flush=True)
        generate_fixture_dataset(eval_data, seed=13,
                                 scene_size=(args.scene, args.scene),
                                 aois={a: True for a in VAL + TEST})

    cfg = load_cfg("siamese")
    cfg.merge_from_list(args.opts)
    cfg.NAME = "siamese"
    cfg.PATHS.OUTPUT = str(out)
    cfg.PATHS.DATASET = str(eval_data)
    cfg.DATASET.TRAINING_IDS = []
    cfg.DATASET.VALIDATION_IDS = VAL
    cfg.DATASET.TEST_IDS = TEST
    cfg.DATASET.UNLABELED_IDS = []

    model, _, step = checkpoints.load_checkpoint(1, cfg, device=device)
    print(f"loaded checkpoint epoch 1 (step {step})", flush=True)

    summary = {"metric": "eval_pad_f1_abs_delta", "scene_class": args.scene,
               "splits": {}, "device": describe(device)}
    deltas = []
    for split in ("validation", "test"):
        ds = MultimodalCDDataset(cfg, split, no_augmentations=True,
                                 dataset_mode="first_last",
                                 disable_multiplier=True, disable_unlabeled=True)
        items = [ds[i] for i in range(len(ds))]
        shapes = sorted({it["x_t1"].shape[:2] for it in items})
        results = {}
        for mode, bucket in (("padded64", 64), ("exact", 1)):
            t0 = time.perf_counter()
            measurer = evaluation.run_measurer(model, items, np.asarray([0.5]),
                                               bucket=bucket, device=device)
            f1 = float(np.asarray(measurer.compute_f1()).max())
            results[mode] = {"f1": f1, "wall_s": time.perf_counter() - t0}
            print(f"{split:10s} {mode:8s} F1 {f1:.6f} "
                  f"({results[mode]['wall_s']:.1f} s)", flush=True)
        delta = abs(results["padded64"]["f1"] - results["exact"]["f1"])
        deltas.append(delta)
        summary["splits"][split] = {
            "scene_shapes": [list(s) for s in shapes], **results, "abs_delta": delta}
    summary["value"] = max(deltas)
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
