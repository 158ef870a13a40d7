"""End-to-end full-scene evaluation throughput at the SpaceNet7 shape class
(the JAX package's ``tools/bench_assessment.py``).

    python -m multimodal_siamese_cd_tpu_torch.bench_assessment [--data-dir D]

``bench_eval`` times the forward alone; this module times the whole path
the trainer's in-training evaluation and ``assessment_change`` run,
``evaluation.run_measurer`` over a ``MultimodalCDDataset``: scene assembly
out of the scene cache on the host, bucket padding, group stacking, the
forward on the card and the confusion counts (the confusion CUDA kernel,
``ops/csrc/confusion.cu``). The gap between the two rates is host work and
dispatch that a forward-only bench cannot see.

The dataset (defaults: 32 labeled AOIs of ~1000^2 scenes, 2 timestamps) is
written once under the system's temporary directory by
``data.synthetic.generate_fixture_dataset`` (seed 11) with a marker of its
parameters; a tree this module wrote with other parameters is written
again, a tree without the marker is never overwritten. ``--data-dir`` may
name a dataset this module did not write (no marker, a ``metadata.json``):
it is then read as it stands, every labeled AOI of it a validation scene.

Passes: the host side alone over the wires (``--item-path``: over the float32
items), cold then warm; then ``run_measurer`` end to end, a warm-up pass and a
timed one closed by reading the F1 back. Prints one JSON line naming the
card. ``--device cpu`` runs it on the CPU, for the tests; without it the
module needs the card and raises where there is none.
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from . import evaluation, geofiles
from .bench import SEED
from .config import load_cfg
from .data.dataset import MultimodalCDDataset
from .device import describe, resolve_device
from .models.factory import create_network
from .trainers import sync

AOI_TMPL = "L15-beval{:02d}"
MARKER = "bench_assessment_gen_params.json"


def ensure_dataset(root: Path, scene: int, n_aois: int) -> list:
    """The validation AOIs of the dataset at ``root``, written first unless
    it holds this module's marker with these parameters (see the module's
    docstring for a dataset without the marker)."""
    params = {"scene": scene, "n_aois": n_aois, "timestamps": 2}
    marker = root / MARKER
    aois = [AOI_TMPL.format(i) for i in range(n_aois)]
    if marker.exists() and json.loads(marker.read_text()) == params:
        return aois
    if root.exists():
        if not marker.exists():
            if (root / "metadata.json").exists():
                meta = geofiles.load_json(root / "metadata.json")
                return sorted(a for a, ts in meta.items()
                              if any(t["buildings"] for t in ts))
            raise SystemExit(
                f"{root} exists but has no {marker.name}; refusing to "
                f"overwrite a dataset this tool did not generate")
        shutil.rmtree(root)
    from .data.synthetic import generate_fixture_dataset

    print(f"generating {n_aois} x {scene}^2 scenes at {root} "
          f"(one-time, cached)...", flush=True)
    # written beside and renamed, so an interrupted run never leaves a
    # marker-less root that would refuse every later run
    tmp = root.with_name(root.name + ".tmp")
    if tmp.exists():
        shutil.rmtree(tmp)
    generate_fixture_dataset(tmp, seed=11, scene_size=(scene, scene),
                             n_timestamps=2, aois={a: True for a in aois})
    (tmp / marker.name).write_text(json.dumps(params))
    tmp.rename(root)
    return aois


def assessment_cfg(data: Path, aois: list):
    """``siamese.yaml`` over ``data`` with ``aois`` as its validation split."""
    cfg = load_cfg("siamese")
    cfg.PATHS.DATASET = str(data)
    cfg.DATASET.TRAINING_IDS = []
    cfg.DATASET.VALIDATION_IDS = list(aois)
    cfg.DATASET.TEST_IDS = []
    cfg.DATASET.UNLABELED_IDS = []
    return cfg


def assessment_dataset(cfg) -> MultimodalCDDataset:
    """The validation split as ``model_evaluation`` builds it."""
    return MultimodalCDDataset(cfg, "validation", no_augmentations=True,
                               dataset_mode="first_last",
                               disable_multiplier=True, disable_unlabeled=True)


def host_only_pass(ds, bucket: int) -> float:
    """``run_measurer``'s item loop without any device call: float32 items,
    padding and the group stacks."""
    pending: dict = {}
    t0 = time.perf_counter()
    for item in ds:
        x1, valid = evaluation.pad_to_bucket(item["x_t1"], bucket)
        x2, _ = evaluation.pad_to_bucket(item["x_t2"], bucket)
        y, _ = evaluation.pad_to_bucket(item["y_change"], bucket)
        group = pending.setdefault(x1.shape, [])
        group.append((x1, x2, y, valid))
        if len(group) >= evaluation.eval_group_limit(x1.shape):
            np.stack([s[0] for s in group])
            np.stack([s[1] for s in group])
            group.clear()
    for group in pending.values():
        if group:
            np.stack([s[0] for s in group])
            np.stack([s[1] for s in group])
    return time.perf_counter() - t0


def wire_host_only_pass(ds, bucket: int) -> float:
    """The wire path's streaming loop without any device call: the planar
    wires and the group stacks."""
    pending: dict = {}
    t0 = time.perf_counter()
    for i in range(len(ds)):
        w = ds.eval_wire(i, bucket)
        group = pending.setdefault(w["x1"].shape, [])
        group.append(w)
        if len(group) >= evaluation.eval_group_limit(w["x1"].shape[1:]):
            for k in ("x1", "x2", "y", "valid"):
                np.stack([g[k] for g in group])
            group.clear()
    for group in pending.values():
        if group:
            for k in ("x1", "x2", "y", "valid"):
                np.stack([g[k] for g in group])
    return time.perf_counter() - t0


class _Items:
    """The dataset's float32 items, assembled on every pass; without
    ``eval_wire`` it takes ``run_measurer``'s item path."""

    def __init__(self, ds):
        self.ds = ds

    def __iter__(self):
        return (self.ds[i] for i in range(len(self.ds)))

    def __len__(self):
        return len(self.ds)


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--scene", type=int, default=1000,
                   help="scene base size (1000 %% 64 != 0 exercises padding)")
    p.add_argument("--n-aois", type=int, default=32)
    p.add_argument("--data-dir", default=None)
    p.add_argument("--host-only", action="store_true",
                   help="only run the host passes, no device")
    p.add_argument("--item-path", action="store_true",
                   help="take run_measurer's float32 item path, not the wire "
                        "path")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card; 'cpu' for the "
                        "tests)")
    p.add_argument("opts", nargs="*", metavar="KEY VALUE",
                   help="config overrides")
    return p


def main(argv=None) -> int:
    p = parser()
    args = p.parse_args(argv)
    if len(args.opts) % 2:
        p.error("overrides must come in KEY VALUE pairs")
    device = None if args.host_only else resolve_device(args.device)
    data = Path(args.data_dir or Path(tempfile.gettempdir())
                / f"bassds{args.scene}_{args.n_aois}")
    aois = ensure_dataset(data, args.scene, args.n_aois)
    cfg = assessment_cfg(data, aois)
    cfg.merge_from_list(args.opts)
    ds = assessment_dataset(cfg)
    n = len(ds)
    scene_class = int(ds.eval_wire(0, evaluation.EVAL_BUCKET)["shape"][0])
    source = _Items(ds) if args.item_path else ds
    host_pass = host_only_pass if args.item_path else wire_host_only_pass
    print(f"{n} scenes, device={device}", flush=True)

    # the first pass builds the scene cache and warms the page cache
    t0 = time.perf_counter()
    host_pass(source, evaluation.EVAL_BUCKET)
    print(f"host-only pass (cold cache build included): "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    host_s = host_pass(source, evaluation.EVAL_BUCKET)
    print(f"host-only (warm): {host_s:.2f} s ({n / host_s:.2f} scenes/s)", flush=True)
    if args.host_only:
        return 0

    info = describe(device)
    model = create_network(cfg, device=device,
                           generator=torch.Generator().manual_seed(SEED))
    thresholds = np.asarray([0.5])

    def timed_pass() -> tuple[float, float]:
        sync(device)
        t0 = time.perf_counter()
        measurer = evaluation.run_measurer(model, source, thresholds, device=device)
        f1 = float(np.asarray(measurer.compute_f1()).max())   # on the host: closes it
        return time.perf_counter() - t0, f1

    warm_s, _ = timed_pass()         # cuDNN's choices, the first allocations
    print(f"e2e warmup pass: {warm_s:.1f} s", flush=True)
    e2e_s, f1 = timed_pass()
    print(f"e2e (warm): {e2e_s:.2f} s ({n / e2e_s:.2f} scenes/s, F1 {f1:.4f})",
          flush=True)
    print(json.dumps({
        "metric": "eval_e2e_scenes_per_sec", "value": n / e2e_s,
        "unit": "scenes/s", "scene_class": scene_class, "n_scenes": n,
        "host_only_scenes_per_sec": n / host_s, "e2e_wall_s": e2e_s,
        "f1": f1, "path": "item" if args.item_path else "wire", "device": info,
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
