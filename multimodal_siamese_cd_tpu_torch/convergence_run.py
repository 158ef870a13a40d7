"""Convergence evidence through the port's training CLIs.

    python -m multimodal_siamese_cd_tpu_torch.convergence_run --regime supervised \\
        --hard --scene 512 --signal 0.3 --multiplier 64 --log-freq 16 --epochs 6

Generates a synthetic SpaceNet7-layout dataset (buildings visible in the
imagery; ``--hard``: the hard-mode fixture of
:func:`.data.synthetic.generate_hard_dataset`), runs one of the three
training CLIs (``python -m multimodal_siamese_cd_tpu_torch.train_*``) with a
short schedule, then prints the F1 trajectory parsed from the run's JSONL
sink (the CLI runs with ``MSCD_LOG_SINK=jsonl``, so the sink is used even
where wandb is installed). The counterpart of the JAX package's
``tools/convergence_run.py``: the same regimes, AOI lists, flags, defaults
and CLI overrides, plus ``--device`` (passed on to the CLI; the default is
the card). A failed run exits with the CLI's code. Data and output default
to directories under the system's temporary directory.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

from .wandb_compat import SINK_ENV

REPO = Path(__file__).resolve().parent.parent

REGIMES = {
    "supervised": ("train_supervised", "siamese"),
    "dualtask": ("train_supervised_dualtask", "dtsiamese"),
    # alpha0500: supervised factor 0.5 — mmcr_base is the consistency-only
    # ablation (LOSS_FACTOR 0.0) and cannot learn change labels by design
    "semisupervised": ("train_semisupervised", "siamese_mmcr_alpha0500"),
}

# A larger AOI grid than the default test fixture (hyphen-only ids: the
# s1_{aoi}_{year}_{month}.tif naming stays unambiguous).
TRAIN = [f"L15-syntrain{i}" for i in range(8)]
VAL = [f"L15-synval{i}" for i in range(2)]
TEST = [f"L15-syntest{i}" for i in range(2)]
UNLAB = [f"L15-synunlab{i}" for i in range(4)]

F1_KEYS = ("training F1", "validation F1", "test F1")


def ensure_dataset(root: Path, scene: int, hard: bool = False,
                   signal: float = 1.0, seed: int = 7) -> None:
    """Generate the dataset at ``root`` unless the marker there records the
    same parameters; regenerate a tree this tool wrote with others; refuse
    to touch a tree without the marker."""
    root = Path(root)
    params = {"scene": scene, "train": TRAIN, "val": VAL, "test": TEST,
              "unlab": UNLAB, "hard": hard,
              "signal": signal if hard else None, "seed": seed}
    marker = root / "convergence_gen_params.json"
    if marker.exists() and json.loads(marker.read_text()) == params:
        return
    if root.exists():
        if not marker.exists():
            # NEVER delete a tree this tool didn't generate (--data-dir may
            # point at a real dataset)
            raise SystemExit(
                f"{root} exists but has no {marker.name}; refusing to "
                f"overwrite a dataset this tool did not generate — pass an "
                f"empty/new --data-dir")
        shutil.rmtree(root)  # our own stale generation: regenerate
    from .data.synthetic import generate_fixture_dataset, generate_hard_dataset

    print(f"generating {'HARD ' if hard else ''}synthetic dataset at {root} "
          f"({scene}^2 scenes)...", flush=True)
    aois = {a: True for a in TRAIN + VAL + TEST}
    aois.update({a: False for a in UNLAB})
    if hard:
        generate_hard_dataset(root, seed=seed, scene_size=(scene, scene),
                              aois=aois, signal=signal)
    else:
        generate_fixture_dataset(root, seed=seed, scene_size=(scene, scene),
                                 aois=aois)
    marker.write_text(json.dumps(params))


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--regime", choices=sorted(REGIMES), default="dualtask")
    p.add_argument("--scene", type=int, default=320)
    p.add_argument("--data-dir", default=None)
    p.add_argument("--out-dir", default=None)
    p.add_argument("--epochs", type=int, default=1)
    p.add_argument("--multiplier", type=int, default=64)
    p.add_argument("--log-freq", type=int, default=10)
    p.add_argument("--save-checkpoints", default=None,
                   help="SAVE_CHECKPOINTS override, e.g. '[1]'")
    p.add_argument("--hard", action="store_true",
                   help="hard-mode fixture: <2%% change prevalence, "
                        "confuser buildings/clutter, speckle + drift "
                        "(synthetic.generate_hard_dataset)")
    p.add_argument("--signal", type=float, default=0.3,
                   help="hard-mode building contrast scale (0.3, the "
                        "generator's calibrated default)")
    p.add_argument("--seed", type=int, default=7)
    p.add_argument("--uniform-crop", action="store_true",
                   help="override AUGMENTATION.IMAGE_OVERSAMPLING_TYPE to "
                        "'none' (importance-vs-uniform ablation)")
    p.add_argument("--model", default=None,
                   help="MODEL.TYPE override (factory-type convergence legs)")
    p.add_argument("--config", default=None,
                   help="config name override (default: the regime's "
                        "headline config)")
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--device", default=None,
                   help="torch device of the training CLI (default: the "
                        "CUDA card; 'cpu' runs on the CPU)")
    p.add_argument("extra", nargs="*", metavar="KEY VALUE",
                   help="extra config overrides appended to the CLI — e.g. "
                        "`DEBUG False` (the upstream unet/baseline_* grid "
                        "pins DEBUG: True = one step per epoch, reproduced "
                        "faithfully by the shipped configs)")
    return p


def parse_args(argv=None) -> argparse.Namespace:
    p = parser()
    args = p.parse_args(argv)
    if len(args.extra) % 2:
        p.error("extra overrides must come in KEY VALUE pairs")
    return args


def paths(args) -> tuple[Path, Path]:
    """(dataset directory, output directory) of a run."""
    tmp = Path(tempfile.gettempdir())
    data = Path(args.data_dir or tmp / f"convds{args.scene}")
    if args.data_dir is None and args.hard:
        data = tmp / f"convds_hard{args.scene}_s{args.signal}"
    out_tag = args.regime + ("_hard" if args.hard else "") \
        + (f"_{args.config}" if args.config else "") \
        + (f"_{args.model}" if args.model else "") \
        + ("_uniform" if args.uniform_crop else "")
    return data, Path(args.out_dir or tmp / f"convout_{out_tag}")


def command(args, data: Path, out: Path) -> tuple[str, list, str]:
    """(CLI module, its argv, config name) of the training run: the JAX
    tool's arguments and overrides, ``--device`` before the overrides."""
    module, config = REGIMES[args.regime]
    if args.config is not None:
        config = args.config
    argv = ["-c", config, "-p", "convergence", "-o", str(out), "-d", str(data)]
    if args.device is not None:
        argv += ["--device", args.device]
    argv += ["DATASET.TRAINING_IDS", repr(TRAIN),
             "DATASET.VALIDATION_IDS", repr(VAL),
             "DATASET.TEST_IDS", repr(TEST),
             "DATASET.UNLABELED_IDS", repr(UNLAB),
             "DATALOADER.TRAINING_MULTIPLIER", str(args.multiplier),
             "LOG_FREQ", str(args.log_freq),
             "TRAINER.WEDGE_TIMEOUT", "1800",
             "TRAINER.EPOCHS", str(args.epochs)]
    if args.save_checkpoints is not None:
        argv += ["SAVE_CHECKPOINTS", args.save_checkpoints]
    if args.uniform_crop:
        argv += ["AUGMENTATION.IMAGE_OVERSAMPLING_TYPE", "none"]
    if args.model is not None:
        argv += ["MODEL.TYPE", args.model]
    if args.batch_size is not None:
        argv += ["TRAINER.BATCH_SIZE", str(args.batch_size)]
    return f"multimodal_siamese_cd_tpu_torch.{module}", argv + args.extra, config


def prepare(args) -> tuple[str, list, Path]:
    """Make the output directory and the dataset, clear the run's JSONL
    sink (it appends; one run per report). Returns (CLI module, argv, the
    sink's path)."""
    data, out = paths(args)
    out.mkdir(parents=True, exist_ok=True)
    ensure_dataset(data, args.scene, hard=args.hard, signal=args.signal,
                   seed=args.seed)
    module, argv, config = command(args, data, out)
    log = out / "logs" / f"{config}.jsonl"
    log.unlink(missing_ok=True)
    return module, argv, log


def trajectory(log: Path) -> list[tuple]:
    """``(step, key, value)`` of every F1 record in the JSONL sink, in order."""
    rows = []
    for line in Path(log).read_text().splitlines():
        rec = json.loads(line)
        rows += [(rec.get("step"), key, rec[key]) for key in F1_KEYS if key in rec]
    return rows


def print_trajectory(log: Path) -> None:
    print(f"\nF1 trajectory ({log}):")
    for step, key, value in trajectory(log):
        print(f"  step {step:>4}  {key}: {value:.4f}")


def main(argv=None) -> int:
    args = parse_args(argv)
    module, cli_argv, log = prepare(args)
    cmd = [sys.executable, "-m", module] + cli_argv
    print("running:", " ".join(cmd), flush=True)
    rc = subprocess.run(cmd, cwd=REPO, env={**os.environ, **SINK_ENV}).returncode
    if rc:
        print(f"the training CLI failed rc={rc}", flush=True)
        return rc
    print_trajectory(log)
    return 0


if __name__ == "__main__":
    sys.exit(main())
