"""Does the training loader's samples/s margin over the card's demand survive
the host work that in-training evaluation interleaves (the JAX package's
``tools/soak_loader.py``)?

    python -m multimodal_siamese_cd_tpu_torch.soak_loader [--wire] \\
        [--duty-period S] [--chip-demand PATCHES_PER_S]

Every LOG_FREQ steps the trainer also runs two evaluation passes, whose host
side (scene cache reads, padding, group stacks) competes with the loader's
workers for the host's cores. This module measures ``data.loader.
TrainLoader``'s steady rate alone, then with a thread replaying that
evaluation host work: continuously (the worst case), or duty-cycled with
``--duty-period`` (two passes every that many seconds, the production
cadence of LOG_FREQ x the step time). ``--wire`` replays the wire path's
host work (``eval_wire`` planes and the group stacks, the production path),
else the float32 item path's (items, padding, and the confusion counts on
the host).

Host-only by definition: it runs no kernel and touches no card, and its line
says ``"device": "host"``. The dataset (4 training and 2 validation AOIs of
``--scene``^2, seed 5) is written once under ``--data-dir`` (default: the
system's temporary directory). Prints one JSON line; ``--chip-demand`` (the
card's patches/s from ``bench``) is echoed into it for the margin.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import torch

from .config import load_cfg
from .data.dataset import MultimodalCDDataset
from .data.loader import TrainLoader
from .evaluation import EVAL_BUCKET, eval_group_limit, pad_to_bucket
from .metrics import MultiThresholdMetric


def _burst_loop(stop: threading.Event, one_pass, period) -> None:
    """Two passes of the evaluation replay, then (``period`` set) rest until
    the cycle of ``period`` seconds ends; ``period`` None: continuously."""
    while not stop.is_set():
        t0 = time.perf_counter()
        one_pass()
        if stop.is_set():
            return
        one_pass()
        if period is not None:
            rest = period - (time.perf_counter() - t0)
            if rest > 0:
                stop.wait(rest)


def eval_host_work_loop(stop: threading.Event, eval_ds, counters,
                        period=None) -> None:
    """The item path's host work: each pass reads every scene from the
    dataset (cache read and float32 assembly), pads it, and counts it on
    the host against same-shaped probabilities (the host cost of counting
    is the same whatever the probabilities)."""
    rng = np.random.default_rng(0)

    def one_pass():
        measurer = MultiThresholdMetric(np.asarray([0.5]))
        for i in range(len(eval_ds)):
            if stop.is_set():
                return
            item = eval_ds[i]
            _, valid = pad_to_bucket(item["x_t1"])
            pad_to_bucket(item["x_t2"])
            y, _ = pad_to_bucket(item["y_change"])
            probs = rng.random(y.shape[:2], np.float32)
            measurer.add_sample(torch.from_numpy(y[..., 0]), torch.from_numpy(probs),
                                valid_mask=torch.from_numpy(valid))
            counters["eval_scenes"] += 1

    _burst_loop(stop, one_pass, period)


def wire_eval_host_work_loop(stop: threading.Event, eval_ds, bucket,
                             counters, period=None) -> None:
    """The wire path's host work: ``eval_wire`` planes and the per-group
    stacks (its counting runs on the card)."""
    def one_pass():
        pending: dict = {}
        for i in range(len(eval_ds)):
            if stop.is_set():
                return
            w = eval_ds.eval_wire(i, bucket)
            group = pending.setdefault(w["x1"].shape, [])
            group.append(w)
            if len(group) >= eval_group_limit(w["x1"].shape[1:]):
                for k in ("x1", "x2", "y", "valid"):
                    np.stack([g[k] for g in group])
                group.clear()
            counters["eval_scenes"] += 1
        for group in pending.values():
            if group:
                for k in ("x1", "x2", "y", "valid"):
                    np.stack([g[k] for g in group])

    _burst_loop(stop, one_pass, period)


def measure_loader(loader, seconds: float) -> float:
    """Samples/s the loader yields over ``seconds`` of host wall time."""
    t0 = time.perf_counter()
    n = 0
    while time.perf_counter() - t0 < seconds:
        for batch in loader:
            n += batch["stack"].shape[0]
            if time.perf_counter() - t0 >= seconds:
                break
    return n / (time.perf_counter() - t0)


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--scene", type=int, default=1000)
    p.add_argument("--seconds", type=float, default=30.0)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--data-dir", default=None)
    p.add_argument("--wire", action="store_true",
                   help="replay the wire eval path's host work (the production "
                        "path) instead of the float32 item path's")
    p.add_argument("--chip-demand", type=float, default=None,
                   help="the card's patches/s from bench; echoed into the JSON "
                        "for the margin comparison")
    p.add_argument("--duty-period", type=float, default=None,
                   help="replay eval bursts (2 passes) every this many seconds "
                        "(LOG_FREQ x the step time) instead of continuously")
    return p


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    data = Path(args.data_dir or Path(tempfile.gettempdir()) / f"soakds{args.scene}")
    train = [f"L15-soak{i}" for i in range(4)]
    val = [f"L15-soakval{i}" for i in range(2)]
    if not (data / "metadata.json").exists():
        from .data.synthetic import generate_fixture_dataset

        print(f"generating {args.scene}^2-class scenes...", flush=True)
        generate_fixture_dataset(data, seed=5, scene_size=(args.scene, args.scene),
                                 aois={a: True for a in train + val})

    cfg = load_cfg("base")
    cfg.PATHS.DATASET = str(data)
    cfg.DATASET.TRAINING_IDS = train
    cfg.DATASET.VALIDATION_IDS = val
    cfg.DATASET.TEST_IDS = []
    cfg.DATASET.UNLABELED_IDS = []
    cfg.DATALOADER.TRAINING_MULTIPLIER = 100
    # a scene smaller than the crop (a test's) is cropped whole
    cfg.AUGMENTATION.CROP_SIZE = min(cfg.AUGMENTATION.CROP_SIZE, args.scene)

    ds = MultimodalCDDataset(cfg, "training")
    loader = TrainLoader(ds, batch_size=args.batch, shuffle=True, num_workers=1,
                         seed=7)
    eval_ds = MultimodalCDDataset(cfg, "validation", no_augmentations=True,
                                  dataset_mode="first_last",
                                  disable_multiplier=True, disable_unlabeled=True)
    if args.wire:
        for i in range(len(eval_ds)):          # warm every eval AOI's cache
            eval_ds.eval_wire(i, EVAL_BUCKET)
        target, target_args = wire_eval_host_work_loop, (eval_ds, EVAL_BUCKET)
    else:
        for i in range(len(eval_ds)):          # warm the scene cache, not the items
            eval_ds[i]
        target, target_args = eval_host_work_loop, (eval_ds,)

    # every (AOI, timestamp) decoded before the timed window: a first decode
    # (seconds for a 1000^2 scene) is not the steady state
    t0 = time.perf_counter()
    for i in range(min(len(ds), 64)):
        ds.get(i)
    print(f"cache warm ({time.perf_counter() - t0:.1f} s); measuring...", flush=True)

    try:
        alone = measure_loader(loader, args.seconds)
        print(f"loader alone: {alone:.1f} samples/s", flush=True)
        stop = threading.Event()
        counters = {"eval_scenes": 0}
        t = threading.Thread(target=target, args=(stop, *target_args, counters),
                             kwargs={"period": args.duty_period}, daemon=True)
        t.start()
        t0 = time.perf_counter()
        contended = measure_loader(loader, args.seconds)
        eval_rate = counters["eval_scenes"] / (time.perf_counter() - t0)
        stop.set()
        t.join(timeout=60)
    finally:
        loader.close()
    print(f"loader + eval host work: {contended:.1f} samples/s (eval side "
          f"processed {eval_rate:.2f} scenes/s)", flush=True)

    result = {
        "metric": "loader_soak_samples_per_sec",
        "alone": alone,
        "with_eval_host_work": contended,
        "degradation_pct": 100 * (1 - contended / alone),
        "eval_scenes_per_sec_concurrent": eval_rate,
        "scene_class": args.scene,
        "eval_path": "wire" if args.wire else "item",
        "eval_cadence": ("continuous" if args.duty_period is None
                         else f"duty_{args.duty_period}s"),
        "device": "host",
    }
    if args.chip_demand is not None:
        result["chip_demand_patches_per_sec"] = args.chip_demand
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
