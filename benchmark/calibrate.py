"""The readings the limits of ``correct`` are set from, for one cell, in one
process:

    python3 -m benchmark.calibrate --workload <cell> --seeds 1,2,... \\
        --control-seeds 1,2,3 [--out FILE]

For every seed of ``--seeds`` the program's sound readings: the cell's
set-up and the stretch of its timed path that the run judges (training:
the first window's three checked steps; serving: the sampled requests),
judged by the reference as a run judges them. For every seed of
``--control-seeds``: the control, the reference in float8 e4m3 in the
program's place, and (training) the planted fault of half of each batch
left out, the loss the mean over the rest. Prints one JSON line per
reading and, with ``--out``, writes them all. The benchmark's runs never
call this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

from .cell import Cell
from .reference import judge
from .traffic import serve, train


def train_readings(cell, control: bool) -> list:
    cfg, model, optimizer, loader, window, weights = train.build(cell)
    feed = train.Feed(loader, int(cfg.TRAINER.STEPS_PER_EXECUTION), cell.device)
    try:
        first = train.first_window(cell, model, optimizer, window, feed, weights)
    finally:
        feed.close()
        loader.close()
    del model, optimizer, window
    torch.cuda.empty_cache()
    j = train.judged(cell, first, weights)
    ref, moved = j["_ref"], j["_moved"]
    out = [{"kind": "program", **{k: v for k, v in j.items() if not k.startswith("_")},
            "loss": first["readings"]["loss"], "ref_loss": ref["loss"],
            "moved_leaves": [len(moved["first"]), len(moved["any"])],
            "leaves": len(ref["grad"]),
            "worst": judge.worst_leaves(first["readings"], ref, moved)}]
    if control:
        batches, labs = j["_batches"]
        fp8 = train.reference(cell, batches, labs, weights, quantized=True)
        out.append({"kind": "control_fp8", **judge.train_numbers(fp8, ref, moved),
                    "loss": fp8["loss"], "worst": judge.worst_leaves(fp8, ref, moved)})
        half = train.reference(cell, batches, labs, weights,
                               rows_kept=slice(0, first["batch"] // 2))
        out.append({"kind": "fault_half_batch", **judge.train_numbers(half, ref, moved),
                    "loss": half["loss"]})
    return out


def serve_readings(cell, control: bool) -> list:
    import tempfile

    requests = serve.Requests(cell)
    with tempfile.TemporaryDirectory() as tmp:
        server, weights = serve.build(cell, Path(tmp))
        kept = {i: server.predict(*requests.get(i)) for i in requests.sample}
        del server
    torch.cuda.empty_cache()
    ref = serve.reference_maps(cell, weights, requests, sorted(kept))
    out = [{"kind": "program", "prob_gap": serve.gap(kept, ref),
            "mean_gap": float(np.mean([np.abs(kept[i] - ref[i]).mean() for i in ref]))}]
    if control:
        fp8 = serve.reference_maps(cell, weights, requests, sorted(kept), quantized=True)
        out.append({"kind": "control_fp8", "prob_gap": serve.gap(fp8, ref),
                    "mean_gap": float(np.mean([np.abs(fp8[i] - ref[i]).mean() for i in ref]))})
    return out


READINGS = {"train": train_readings, "serve": serve_readings}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--out", default=None)
    a = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibration reads the card; none found", file=sys.stderr)
        return 2
    seeds = [int(s) for s in a.seeds.split(",")]
    controls = {int(s) for s in a.control_seeds.split(",") if s}
    rows = []
    for seed in list(dict.fromkeys(seeds + sorted(controls))):
        cell = Cell(a.workload, seed, 0.0, False, torch.device("cuda"), time.perf_counter())
        t0 = time.perf_counter()
        for r in READINGS[cell.traffic["kind"]](cell, seed in controls):
            r.update(workload=a.workload, seed=seed, card=torch.cuda.get_device_name(),
                     seconds=time.perf_counter() - t0)
            print(json.dumps(r), flush=True)
            rows.append(r)
    if a.out:
        Path(a.out).parent.mkdir(parents=True, exist_ok=True)
        Path(a.out).write_text("\n".join(json.dumps(r) for r in rows) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
