"""The bytes the port's train step moves between ranks, and what they cost
beside the step time (the JAX package's ``tools/model_scaling.py``).

    python -m multimodal_siamese_cd_tpu_torch.model_scaling [--regime R] [--world N]
        [--crop 256] [--batch-per-rank 8] [--step-ms MS[,MS...]] [--loader-rate S]
        [--device D] [KEY VALUE ...]

The JAX tool compiles the step for a TPU topology and parses the
collectives the compiler put in its HLO. The port makes its collectives
itself, so this module counts them: it runs one step of each regime (its
headline model, ``bench.REGIME_MODELS``, at ``--batch-per-rank`` rows a
rank and ``--crop``² crops) in a world of ``--world`` ranks
(``parallel.cluster_check``'s ``step`` case with ``count_collectives``)
and counts every
tensor the port's call sites hand to ``torch.distributed``, by kind
(``all_reduce``, ``broadcast``, ``halo``) and by site (``bn_sums``: sync-BN's
flat ``2C`` float32 sums, forward and backward; ``gradient``: the flat
gradient; ``global_rows``: each micro-batch's global outputs and labels in
float32; ``broadcast``; ``halo``). The counts depend on the shapes alone,
so a world on the CPU (``--device cpu``) counts what a world of cards
would. Without ``--device`` the ranks run on the card, sharing it over
gloo when there are fewer cards than ranks.

The step time is ``--step-ms``, one value per regime measured, in order,
comma-separated.
Without it, on the card, this process measures each regime with
``bench.measure`` (K 20 steps a call as a CUDA graph, one card) after the
count; on the CPU it refuses to run, since a CPU time is no card's.

One JSON line per regime carries the JAX tool's record keys
(``analyze_regime``), renamed where a world of ranks is not a TPU mesh:
``world`` (JAX ``mesh_devices``), ``batch_per_rank`` (``batch_per_chip``),
``measured_step_ms_1card`` (``measured_step_ms_1chip``),
``link_wire_ms_ring`` (``ici_wire_ms_ring``) and ``topology`` (the world's
layout and backend, where JAX names the TPU topology); plus
``collective_calls``, ``by_site`` and ``device``. It leaves out
``flops_per_device_per_step``: XLA's ``cost_analysis`` has no counterpart
here.

The link model is the JAX tool's: a ring all-reduce moves ``2(n-1)/n`` of
the all-reduced bytes per rank, split over both directions of its link,
at ``LINK_GBPS_PER_DIR``. With no overlap a step takes the step time plus
the wire time; overlapped, the larger of the two.

``--loader-rate`` (the samples/s one loader core sustains, as ``python -m
multimodal_siamese_cd_tpu_torch.soak_loader`` reads it on the host) adds a
line with the host-feed table: the patches/s a world of 1, 4, 8 and 16
cards demands at the first regime's step time, and the loader cores that
takes.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import tempfile
from pathlib import Path

import torch

from . import bench
from .device import describe, resolve_device
from .parallel import cluster_check

# NVLink 4 on an H100 SXM5: 18 links of 25 GB/s each way (NVIDIA's H100
# data sheet, 900 GB/s in all)
LINK_GBPS_PER_DIR = 450.0
SEED = 0        # the synthetic batch's and, with bench.SEED, the weights' seed
LAUNCH_TIMEOUT = 900


def regime_overrides(regime: str, world: int, batch_per_rank: int, crop: int,
                     opts=()) -> list:
    """The ``base`` config overrides of a regime's counted step: the bench's
    config (its headline model, bf16, the crop) at the world's global
    batch, then ``opts``."""
    overrides = ["MODEL.TYPE", bench.REGIME_MODELS[regime], "TRAINER.PRECISION", "bf16",
                 "AUGMENTATION.CROP_SIZE", str(crop),
                 "TRAINER.BATCH_SIZE", str(world * batch_per_rank), "SEED", str(bench.SEED)]
    if regime == "semisupervised":
        overrides += ["DATALOADER.INCLUDE_UNLABELED", "True"]
    return overrides + list(opts)


def count_collectives(regimes: list, world: int, batch_per_rank: int, crop: int,
                      device: torch.device, opts=()) -> dict:
    """One step of each regime in a world of ``world`` ranks on ``device``'s
    type, every collective counted (one launch: a ``step`` case per regime
    with ``count_collectives``, run in one ``dryrun`` case, which keeps
    their summaries). Returns ``{regime: rank 0's summary}`` (``counts``
    by site, ``param_count``, ``param_bytes``, ``metrics``, ``launches``)
    with the world's ``backend``; raises when a rank fails or the ranks'
    counts differ."""
    steps = [{"name": regime, "kind": "step", "config": "base",
              "overrides": regime_overrides(regime, world, batch_per_rank, crop, opts),
              "regime": regime, "synthetic": [world * batch_per_rank, crop, SEED],
              "count_collectives": True}
             for regime in regimes]
    backend = cluster_check.backend_for(device, world)
    job = {"device": device.type, "backend": backend,
           "cases": [{"name": "scaling", "kind": "dryrun", "surfaces": steps}]}
    with tempfile.TemporaryDirectory(prefix="model_scaling_") as tmp:
        rcs, outs = cluster_check.launch_cluster(job, tmp, world=world,
                                                 timeout=LAUNCH_TIMEOUT)
        if rcs != [0] * world:
            raise RuntimeError(f"the {world}-rank world exited {rcs}:\n"
                               + "\n".join(err[-3000:] for _, err in outs))
        ranks = [torch.load(Path(tmp) / f"scaling.rank{r}.pt", weights_only=False)
                 for r in range(world)]
    results = {}
    for regime in regimes:
        if any(r[regime]["counts"] != ranks[0][regime]["counts"] for r in ranks):
            raise RuntimeError(f"{regime}: the ranks counted different collectives")
        results[regime] = dict(ranks[0][regime], backend=backend)
    return results


def ring_model(allreduce_bytes: int, world: int, step_ms: float,
               link_gbps_per_dir: float) -> tuple:
    """``(wire ms, efficiency without overlap, efficiency overlapped)`` of a
    ring all-reduce of ``allreduce_bytes`` over ``world`` ranks beside a
    step of ``step_ms``: each rank moves ``2(n-1)/n`` of the bytes, split
    over both directions of a link of ``link_gbps_per_dir`` GB/s each way."""
    wire_bytes = 2 * (world - 1) / world * allreduce_bytes
    wire_ms = wire_bytes / (2 * link_gbps_per_dir * 1e9) * 1e3
    return wire_ms, step_ms / (step_ms + wire_ms), step_ms / max(step_ms, wire_ms)


def record(regime: str, world: int, batch_per_rank: int, crop: int, result: dict,
           step_ms: float, device_info: dict) -> dict:
    """A regime's JSON record (the module docstring) from its counted step
    ``result`` (:func:`count_collectives`)."""
    by_site = {site: {"calls": c["calls"], "bytes": c["bytes"]}
               for site, c in result["counts"].items()}
    kinds = {}
    for c in result["counts"].values():
        k = kinds.setdefault(c["kind"], {"count": 0, "bytes": 0})
        k["count"] += c["calls"]
        k["bytes"] += c["bytes"]
    allreduce = kinds.get("all_reduce", {}).get("bytes", 0)
    total = sum(k["bytes"] for k in kinds.values())
    wire_ms, no_overlap, overlapped = ring_model(allreduce, world, step_ms,
                                                 LINK_GBPS_PER_DIR)
    return {
        "regime": regime,
        "topology": f"{world} ranks over {result['backend']} on {device_info['name']}",
        "world": world,
        "batch_per_rank": batch_per_rank,
        "crop": crop,
        "param_mib": result["param_bytes"] / 2**20,
        "collectives": kinds,
        "allreduce_mib": allreduce / 2**20,
        "allreduce_vs_param_bytes": allreduce / result["param_bytes"],
        "total_collective_mib": total / 2**20,
        "measured_step_ms_1card": step_ms,
        "link_wire_ms_ring": wire_ms,
        "dp_efficiency_no_overlap": no_overlap,
        "dp_efficiency_overlapped": overlapped,
        "collective_calls": sum(k["count"] for k in kinds.values()),
        "by_site": by_site,
        "param_count": result["param_count"],
        "link_gbps_per_dir": LINK_GBPS_PER_DIR,
        "device": device_info,
    }


def host_feed_table(step_ms: float, batch_per_rank: int, loader_rate: float) -> list:
    """Patches/s a world of 1, 4, 8 and 16 cards demands at ``step_ms`` a
    step of ``batch_per_rank`` rows a card, and the loader cores of
    ``loader_rate`` samples/s each that it takes."""
    rows = []
    for cards in (1, 4, 8, 16):
        demand = cards * batch_per_rank / (step_ms / 1e3)
        rows.append({"cards": cards, "patches_per_s_demand": demand,
                     "loader_cores_required": math.ceil(demand / loader_rate)})
    return rows


def bench_step_ms(regime: str, batch_per_rank: int, crop: int, device: torch.device,
                  opts=()) -> float:
    """The regime's step time on one card by ``bench.measure`` at its
    defaults (K 20 steps a call, 2 warm-up and 5 timed calls)."""
    args = bench.parse_args(["--regime", regime, "--crop", str(crop),
                             "--batch-size", str(batch_per_rank)] + list(opts))
    cfg, model, optimizer = bench.setup(args, regime, bench.REGIME_MODELS[regime], device)
    ms = bench.measure(args, regime, cfg, model, optimizer, device)["step_ms"]
    del model, optimizer
    torch.cuda.empty_cache()
    return ms


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--regime", default=None, choices=list(bench.REGIME_MODELS),
                   help="count one regime only (default: all three)")
    p.add_argument("--world", type=int, default=8)
    p.add_argument("--crop", type=int, default=256)
    p.add_argument("--batch-per-rank", type=int, default=8)
    p.add_argument("--step-ms", default=None,
                   type=lambda text: [float(ms) for ms in text.split(",")],
                   help="the step time of each regime measured, comma-separated, "
                        "in order (default on the card: bench.measure in this "
                        "process)")
    p.add_argument("--loader-rate", type=float, default=None,
                   help="samples/s of one loader core (soak_loader's reading): "
                        "adds the host-feed table")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card; 'cpu' for the tests, "
                        "which needs --step-ms)")
    p.add_argument("opts", nargs="*", metavar="KEY VALUE",
                   help="config overrides applied to every regime")
    return p


def main(argv=None) -> int:
    p = parser()
    args = p.parse_args(argv)
    regimes = [args.regime] if args.regime else list(bench.REGIME_MODELS)
    if len(args.opts) % 2:
        p.error("overrides must come in KEY VALUE pairs")
    if args.step_ms is not None and len(args.step_ms) != len(regimes):
        p.error(f"--step-ms takes one value per regime ({len(regimes)})")
    device = resolve_device(args.device)
    if args.step_ms is None and device.type != "cuda":
        p.error("on the CPU --step-ms is required: a CPU step time is no card's")
    info = describe(device)
    counted = count_collectives(regimes, args.world, args.batch_per_rank, args.crop,
                                device, args.opts)
    step_ms = args.step_ms or [bench_step_ms(r, args.batch_per_rank, args.crop, device,
                                             args.opts) for r in regimes]
    for regime, ms in zip(regimes, step_ms):
        print(json.dumps(record(regime, args.world, args.batch_per_rank, args.crop,
                                counted[regime], ms, info)),
              flush=True)
    if args.loader_rate is not None:
        print(json.dumps({"host_feed": host_feed_table(step_ms[0], args.batch_per_rank,
                                                       args.loader_rate),
                          "regime": regimes[0], "step_ms": step_ms[0],
                          "loader_samples_per_s": args.loader_rate,
                          "source": "soak_loader"}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
