"""Production-cadence, multi-epoch lifecycle run of the port's training CLIs.

    python -m multimodal_siamese_cd_tpu_torch.lifecycle_run --hard      # full shape
    python -m multimodal_siamese_cd_tpu_torch.lifecycle_run --scene 128 \\
        --multiplier 16 --crop 128                                       # smoke

A synthetic dataset at the reference's production shape (39 train / 9 val /
12 test labeled AOIs + 20 unlabeled, ~1024^2 scenes — reference
configs/base.yaml:28,47-134), trained through the port's training CLI
(``python -m multimodal_siamese_cd_tpu_torch.train_*``) with the reference's
control flow at scale (LOG_FREQ 100 full-split in-epoch evaluations,
epoch-end evaluations, SAVE_CHECKPOINTS every epoch), for 3 epochs, with:

  * a SIGKILL mid-epoch 3 (a preemption), once the first LOG_FREQ window
    of the final epoch (the seam) has its records on disk; then the same
    command again with ``TRAINER.RESUME_CHECKPOINT latest``: the run finds
    the epoch-2 checkpoint itself;
  * the seam check: the killed and the resumed run both log the seam
    window, and every number of its records must agree within 1e-6
    (wall clocks aside): checkpoint, loader schedule and random streams
    restore exactly;
  * patches/s per log window (``train_time``, the window minus its
    evaluations);
  * the offline assessment (``python -m multimodal_siamese_cd_tpu_torch.
    assessment_change``) of the final epoch's checkpoint.

The counterpart of the JAX package's ``tools/lifecycle_run.py`` (same
``overrides``, ``plan``, ``window_rates``, dataset and report), plus
``--device`` (passed on to each CLI; the default is the card) and
trailing ``KEY VALUE`` overrides for every CLI; the log is read every
``POLL_S`` seconds while waiting for the seam. The CLIs run with
``MSCD_LOG_SINK=jsonl``: the JSONL log this tool reads is written even where
wandb is installed. A failed run is an error:
nothing is retried. Writes ``lifecycle_report.json``, the JSONL log and the
CLIs' console output under ``--out-dir`` (default: under the system's
temporary directory); the F1 trajectory prints at the end.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import time
from pathlib import Path

from .wandb_compat import SINK_ENV

REPO = Path(__file__).resolve().parent.parent

# regime -> (training CLI module, headline config, trains on unlabeled AOIs
# too); the configs are convergence_run's
REGIMES = {
    "supervised": ("train_supervised", "siamese", False),
    "dualtask": ("train_supervised_dualtask", "dtsiamese", False),
    # alpha0500: supervised factor 0.5 (mmcr_base is consistency-only and
    # cannot learn change labels by design)
    "semisupervised": ("train_semisupervised", "siamese_mmcr_alpha0500", True),
}

TRAIN = [f"L15-lftrain{i}" for i in range(39)]
VAL = [f"L15-lfval{i}" for i in range(9)]
TEST = [f"L15-lftest{i}" for i in range(12)]
UNLAB = [f"L15-lfunlab{i}" for i in range(20)]

SEAM_LIMIT = 1e-6
POLL_S = 0.2     # seconds between reads of the log while waiting for the seam


def ensure_dataset(root: Path, scene: int, hard: bool = False) -> None:
    """Generate the dataset at ``root`` unless its marker records the same
    parameters; generated into a sibling and renamed, so an interrupted
    generation never leaves a marker-less tree that the guard refuses."""
    root = Path(root)
    params = {"scene": scene, "train": TRAIN, "val": VAL, "test": TEST,
              "unlab": UNLAB, "v": 1, "hard": hard}
    marker = root / "lifecycle_gen_params.json"
    if marker.exists() and json.loads(marker.read_text()) == params:
        return
    if root.exists() and not marker.exists():
        # NEVER delete a tree this tool didn't generate
        raise SystemExit(
            f"{root} exists but has no {marker.name}; refusing to "
            f"overwrite a dataset this tool did not generate")
    from .data.synthetic import generate_fixture_dataset, generate_hard_dataset

    t0 = time.time()
    print(f"generating {'HARD ' if hard else ''}synthetic dataset at {root} "
          f"({len(TRAIN)}/{len(VAL)}/{len(TEST)}+{len(UNLAB)} AOIs, "
          f"~{scene}^2 scenes)...", flush=True)
    aois = {a: True for a in TRAIN + VAL + TEST}
    aois.update({a: False for a in UNLAB})
    tmp = root.with_name(root.name + ".partial")
    if tmp.exists():
        shutil.rmtree(tmp)
    if hard:
        generate_hard_dataset(tmp, scene_size=(scene, scene), aois=aois)
    else:
        generate_fixture_dataset(tmp, scene_size=(scene, scene), aois=aois)
    (tmp / marker.name).write_text(json.dumps(params))
    if root.exists():
        shutil.rmtree(root)
    tmp.rename(root)
    print(f"dataset generated in {time.time() - t0:.0f} s", flush=True)


def overrides(args) -> list:
    return ["DATASET.TRAINING_IDS", repr(TRAIN),
            "DATASET.VALIDATION_IDS", repr(VAL),
            "DATASET.TEST_IDS", repr(TEST),
            "DATASET.UNLABELED_IDS", repr(UNLAB),
            "DATALOADER.TRAINING_MULTIPLIER", str(args.multiplier),
            "LOG_FREQ", str(args.log_freq),
            "TRAINER.EPOCHS", str(args.epochs),
            "AUGMENTATION.CROP_SIZE", str(args.crop),
            "SAVE_CHECKPOINTS", repr(list(range(1, args.epochs + 1)))]


def plan(regime: str, multiplier: int, log_freq: int, epochs: int,
         batch: int | None = None) -> dict:
    """The run's schedule from the regime's config: its batch size (the
    semi-supervised configs pin TRAINER.BATCH_SIZE 4, not base.yaml's 8),
    steps per epoch (semi-supervised epochs also count the 20 unlabeled
    AOIs), the epoch resumed from and the seam step, the first LOG_FREQ
    multiple inside the final epoch."""
    from .config import load_cfg

    _, config, with_unlabeled = REGIMES[regime]
    batch = batch or load_cfg(config).TRAINER.BATCH_SIZE
    n_train_aois = len(TRAIN) + (len(UNLAB) if with_unlabeled else 0)
    steps_per_epoch = (n_train_aois * multiplier) // batch
    resume_epoch = epochs - 1
    resume_step = resume_epoch * steps_per_epoch
    # first LOG_FREQ multiple inside the final epoch: both runs log it
    seam_step = ((resume_step // log_freq) + 1) * log_freq
    if seam_step >= epochs * steps_per_epoch:
        raise AssertionError("final epoch too short to contain a log window; "
                             "raise --multiplier")
    return {"batch": batch, "steps_per_epoch": steps_per_epoch,
            "resume_epoch": resume_epoch, "seam_step": seam_step}


def cli(module: str) -> list:
    """The command that runs the port's CLI ``module`` (e.g.
    ``train_supervised``) in a new process."""
    return [sys.executable, "-m", f"multimodal_siamese_cd_tpu_torch.{module}"]


def launch(cmd, log_path: Path):
    print("running:", " ".join(cmd), flush=True)
    logf = open(log_path, "a")
    return subprocess.Popen(cmd, cwd=REPO, stdout=logf, stderr=logf,
                            env={**os.environ, **SINK_ENV}), logf


def parse_jsonl(text: str) -> list:
    records = []
    for line in text.splitlines():
        try:
            records.append(json.loads(line))
        except json.JSONDecodeError:
            pass  # mid-write tail line
    return records


def read_jsonl(path: Path) -> list:
    return parse_jsonl(path.read_text()) if path.exists() else []


def window_rates(recs, steps_per_epoch, batch, start_step=0):
    """Patches/s of each log window, over the steps it really covers.

    A window summary at step ``s`` covers the steps since
    ``max(previous summary, epoch start)``: the trainer's train_time
    accumulator resets at epoch starts as well as after each window, so
    dividing every window by LOG_FREQ would undercount epoch-first windows.
    The first window of each phase is dropped (it includes the warm-up).
    """
    rates, prev, first = [], start_step, True
    for r in recs:
        if "train_time" not in r or r.get("step") is None:
            continue
        s = r["step"]
        epoch_start = ((s - 1) // steps_per_epoch) * steps_per_epoch
        n = s - max(prev, epoch_start)
        prev = s
        if first:
            first = False
            continue
        if n > 0 and r["train_time"] > 0:
            rates.append(n * batch / r["train_time"])
    return rates


def seam_differences(phase_a: list, phase_b: list, seam_step: int) -> dict:
    """Largest |A - B| per numeric key over the seam step's records of the
    killed (A) and the resumed (B) run, compared pairwise in order (each
    log window writes several records at one step); wall clocks and the
    sink's own stamps aside."""
    a_seam = [r for r in phase_a if r.get("step") == seam_step]
    b_seam = [r for r in phase_b if r.get("step") == seam_step]
    if not a_seam or len(a_seam) != len(b_seam):
        raise AssertionError(f"seam step {seam_step} record counts differ "
                             f"(A: {len(a_seam)}, B: {len(b_seam)})")
    diffs = {}
    for ra, rb in zip(a_seam, b_seam):
        if set(ra) != set(rb):
            raise AssertionError(f"seam record keys differ: {ra} vs {rb}")
        for key, va in ra.items():
            vb = rb[key]
            if isinstance(va, (int, float)) and isinstance(vb, (int, float)) \
                    and key not in ("time", "train_time") \
                    and not key.startswith("_"):
                diffs[key] = max(diffs.get(key, 0.0), abs(va - vb))
    return diffs


def assessment_argv(args, config: str, out: Path, data: Path) -> list:
    """``assessment_change``'s arguments for the final epoch's checkpoint."""
    return (["-c", config, "-o", str(out), "-d", str(data)] + _device(args)
            + overrides(args) + args.extra
            + ["INFERENCE_CHECKPOINT", str(args.epochs)])


def _device(args) -> list:
    return [] if args.device is None else ["--device", args.device]


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--regime", choices=sorted(REGIMES), default="supervised")
    p.add_argument("--scene", type=int, default=1024)
    p.add_argument("--epochs", type=int, default=3)
    # 39 AOIs x 128 / batch 8 = 624 steps/epoch
    p.add_argument("--multiplier", type=int, default=128)
    p.add_argument("--log-freq", type=int, default=100)
    p.add_argument("--batch", type=int, default=None,
                   help="override TRAINER.BATCH_SIZE (default: the regime "
                        "config's own value — semisup configs pin 4, not 8)")
    p.add_argument("--crop", type=int, default=256,
                   help="AUGMENTATION.CROP_SIZE (production default 256; "
                        "shrink for smoke runs with small scenes)")
    p.add_argument("--data-dir", default=None)
    p.add_argument("--out-dir", default=None)
    p.add_argument("--kill-timeout", type=float, default=7200,
                   help="abort if the kill window never arrives (s)")
    p.add_argument("--hard", action="store_true",
                   help="hard-mode fixture (synthetic.generate_hard_dataset, "
                        "signal 0.3)")
    p.add_argument("--device", default=None,
                   help="torch device of every CLI (default: the CUDA card; "
                        "'cpu' runs on the CPU)")
    p.add_argument("extra", nargs="*", metavar="KEY VALUE",
                   help="config overrides appended to every CLI")
    return p


def main(argv=None) -> int:
    p = parser()
    args = p.parse_args(argv)
    if len(args.extra) % 2:
        p.error("extra overrides must come in KEY VALUE pairs")

    module, config, _ = REGIMES[args.regime]
    tag = f"{args.scene}{'_hard' if args.hard else ''}"
    tmp = Path(tempfile.gettempdir())
    data = Path(args.data_dir or tmp / f"lifecycle_ds{tag}")
    out = Path(args.out_dir or tmp / f"lifecycle_out{tag}_{args.regime}")
    out.mkdir(parents=True, exist_ok=True)
    ensure_dataset(data, args.scene, hard=args.hard)

    run_plan = plan(args.regime, args.multiplier, args.log_freq, args.epochs,
                    batch=args.batch)
    batch = run_plan["batch"]
    steps_per_epoch = run_plan["steps_per_epoch"]
    resume_epoch = run_plan["resume_epoch"]
    seam_step = run_plan["seam_step"]
    print(f"regime {args.regime}: batch {batch}, "
          f"{steps_per_epoch} steps/epoch x {args.epochs} epochs", flush=True)

    jsonl = out / "logs" / f"{config}.jsonl"
    jsonl.unlink(missing_ok=True)
    console = out / "console.log"
    console.unlink(missing_ok=True)

    train_argv = (["-c", config, "-p", "lifecycle", "-o", str(out), "-d", str(data)]
                  + _device(args) + overrides(args) + args.extra)
    if args.batch is not None:
        train_argv += ["TRAINER.BATCH_SIZE", str(args.batch)]

    def seam_logged() -> list:
        # the window summary (train_time) is written after the window's
        # training and validation F1 records
        return [r["step"] for r in read_jsonl(jsonl)
                if "train_time" in r and r.get("step") is not None
                and r["step"] >= seam_step]

    # ---- phase A: train, then SIGKILL mid-final-epoch --------------------
    t0 = time.time()
    proc, logf = launch(cli(module) + train_argv, console)
    try:
        while True:
            if proc.poll() is not None:
                # read the log again before judging the exit: a short run
                # can log the seam window and finish inside one poll gap
                if seam_logged():
                    raise SystemExit(
                        f"phase A FINISHED before the SIGKILL could land (seam "
                        f"step {seam_step} too close to the run's end for the "
                        f"{POLL_S:g} s poll) — raise --multiplier so the "
                        f"final epoch extends past the seam window")
                raise SystemExit(f"phase A exited rc={proc.returncode} before "
                                 f"the kill window (step {seam_step}) — see "
                                 f"{console}")
            steps = seam_logged()
            if steps:
                killed_at = max(steps)
                proc.send_signal(signal.SIGKILL)  # preemption stand-in
                proc.wait()
                break
            if time.time() - t0 > args.kill_timeout:
                proc.send_signal(signal.SIGKILL)
                proc.wait()
                raise SystemExit("phase A never reached the kill window")
            time.sleep(POLL_S)
    finally:
        if proc.poll() is None:    # an error above: leave no training process
            proc.kill()
            proc.wait()
        logf.close()
    # SIGKILL can land mid-write: drop any partial trailing line now so
    # phase B's first appended record never splices onto it, and parse
    # phase A from the same truncated bytes so the record counts line up
    raw_a = jsonl.read_bytes()
    nl = raw_a.rfind(b"\n")
    jsonl.write_bytes(raw_a[:nl + 1] if nl >= 0 else b"")
    phase_a = read_jsonl(jsonl)
    print(f"phase A: SIGKILLED after logging step {killed_at} "
          f"({time.time() - t0:.0f} s in)", flush=True)
    ckpt = out / "networks" / f"{config}_checkpoint{resume_epoch}.pt"
    if not ckpt.exists():
        raise SystemExit(f"epoch-{resume_epoch} checkpoint missing: {ckpt}")

    # ---- phase B: resume from the epoch-(E-1) checkpoint ------------------
    # no epoch named anywhere: the restarted command finds the newest
    # checkpoint itself. Phase B runs one epoch where phase A ran up to
    # `epochs`, so phase A's wall time is a generous bound for it
    phase_b_timeout = max(time.time() - t0, 900.0)
    t1 = time.time()
    proc, logf = launch(cli(module) + train_argv
                        + ["TRAINER.RESUME_CHECKPOINT", "latest"], console)
    try:
        rc = proc.wait(timeout=phase_b_timeout)
    except subprocess.TimeoutExpired:
        rc = "wedged"
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        logf.close()
    if rc != 0:
        raise SystemExit(f"phase B (resume) failed rc={rc} — see {console}")
    print(f"phase B: resumed run finished ({time.time() - t1:.0f} s)", flush=True)
    records = read_jsonl(jsonl)
    phase_b = records[len(phase_a):]

    # ---- seam invisibility: both phases logged the seam window -----------
    seam_diffs = seam_differences(phase_a, phase_b, seam_step)
    bad = {k: d for k, d in seam_diffs.items() if d > SEAM_LIMIT}
    if bad:
        raise AssertionError(f"resume seam VISIBLE in metrics: {bad}")
    print(f"seam check OK: step-{seam_step} records agree within {SEAM_LIMIT:g} "
          f"across kill+resume ({seam_diffs})", flush=True)

    # ---- patches/s per window ---------------------------------------------
    rates = (window_rates(phase_a, steps_per_epoch, batch)
             + window_rates(phase_b, steps_per_epoch, batch,
                            start_step=resume_epoch * steps_per_epoch))
    rate = sorted(rates)[len(rates) // 2] if rates else float("nan")

    # ---- offline assessment on the final artifact -------------------------
    t2 = time.time()
    assess_cmd = cli("assessment_change") + assessment_argv(args, config, out, data)
    print("running:", " ".join(assess_cmd), flush=True)
    try:
        r = subprocess.run(assess_cmd, cwd=REPO, capture_output=True, text=True,
                           timeout=phase_b_timeout, env={**os.environ, **SINK_ENV})
    except subprocess.TimeoutExpired:
        raise SystemExit(f"offline assessment wedged (> {phase_b_timeout:.0f} s)")
    print(r.stdout[-2000:], flush=True)
    if r.returncode:
        print(r.stderr[-3000:], flush=True)
        raise SystemExit(f"offline assessment failed rc={r.returncode}")
    print(f"offline assessment done ({time.time() - t2:.0f} s)", flush=True)

    # ---- report ------------------------------------------------------------
    def trajectory(recs):
        return [{k: r.get(k) for k in
                 ("step", "epoch", "training F1", "validation F1", "test F1",
                  "loss", "train_time", "time") if k in r}
                for r in recs
                if any(f in r for f in
                       ("training F1", "validation F1", "test F1"))]

    report = {
        "shape": {"scene": args.scene, "aois": [len(TRAIN), len(VAL),
                                                len(TEST), len(UNLAB)],
                  "steps_per_epoch": steps_per_epoch, "epochs": args.epochs,
                  "log_freq": args.log_freq, "batch": batch,
                  "multiplier": args.multiplier},
        "killed_after_step": killed_at, "resume_epoch": resume_epoch,
        "seam_step": seam_step, "seam_max_abs_diff":
            max(seam_diffs.values()) if seam_diffs else None,
        "median_train_patches_per_sec": round(rate, 1),
        "window_rates": [round(x, 1) for x in rates],
        "assessment_tail": r.stdout.strip().splitlines()[-3:],
        "trajectory": trajectory(records),
    }
    (out / "lifecycle_report.json").write_text(json.dumps(report, indent=1))
    print(f"\nreport: {out / 'lifecycle_report.json'}")
    print(f"median train rate {rate:.1f} patches/s")
    for t in report["trajectory"]:
        f1s = ", ".join(f"{k}={t[k]:.4f}" for k in
                        ("training F1", "validation F1", "test F1") if k in t)
        print(f"  step {t.get('step'):>5} epoch {t.get('epoch'):.2f}  {f1s}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
