"""Subprocess worker certifying the port's multi-process path (the JAX
package's ``parallel/cluster_check.py``).

Run as::

    python -m multimodal_siamese_cd_tpu_torch.parallel.cluster_check \\
        <rank> <world> <rendezvous_file> <job_file> <out_dir>

:func:`launch_cluster` starts ``world`` such processes. Each joins the world
through the shipped env-gated path (:func:`.distributed.
maybe_initialize_distributed`, a ``file://`` rendezvous in a fresh temporary
directory, so no port is picked and none can be taken) and runs the job's
cases in order, each rank on its rows: ``step`` takes optimizer steps with
the rank feeding its rows of the global batch (on a
``TRAINER.SPATIAL_SHARDS`` grid, its data column's rows, of which the step
keeps its height block; with ``count_collectives``, every collective
counted by call site, :mod:`..model_scaling`), ``scanned`` a window of
``make_scanned_train_step``, ``measurer``
and ``dualtask_counts`` run the wire evaluations sharded over the ranks
(and the grid's space ranks; ``measurer`` also an item list, whole on
every rank), ``scene_probs`` runs :func:`..evaluation.
sharded_scene_probabilities`, ``halo`` the halo exchange and
:func:`.halo.whole` alone with their adjoints, ``train`` runs
:func:`..trainers.run_training`, ``errors`` records the messages of the
errors a world raises, ``dryrun`` runs a list of such cases in order and
keeps their summaries (:func:`..graft_entry.dryrun_multichip`,
:mod:`..model_scaling`). :func:`run_case` runs a case in
the calling process, where, without a process group, it is the
one-process reference of the same case. Each rank writes
``{name}.rank{rank}.pt`` into ``out_dir`` and prints::

    RESULT <rank> <loss> <param_abs_sum>      (a step case)
    EVALF1 <rank> <f1>                        (a measurer case)

A job (``torch.save``'d, tensors and plain values only) is ``{"device":
"cpu" | "cuda", "backend": "gloo" | "nccl", "cases": [case, ...]}``; a case
is ``{"name", "kind", "config", "overrides", "paths", ...}`` with the keys its kind
reads (:func:`run_case`). On the CPU each worker runs one torch thread.

The ``<rendezvous_file>`` argument ``env`` joins through ``env://``
instead: :func:`launch_cluster` then sets ``MSCD_DISTRIBUTED``,
``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK`` and
``LOCAL_RANK`` in each worker's environment, as ``torchrun`` sets them.
"""

from __future__ import annotations

import contextlib
import os
import shutil
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch


def main(argv=None) -> None:
    argv = list(sys.argv[1:] if argv is None else argv)
    rank, world, rendezvous = int(argv[0]), int(argv[1]), argv[2]
    job = torch.load(argv[3], weights_only=True)
    out_dir = Path(argv[4])
    cuda = job["device"] == "cuda"
    init_method = None      # env://: launch_cluster set the variables
    if rendezvous != "env":
        os.environ.update(MSCD_DISTRIBUTED="1", WORLD_SIZE=str(world),
                          RANK=str(rank), LOCAL_RANK=str(_local_rank(rank, cuda)))
        init_method = f"file://{rendezvous}"
    if not cuda:
        torch.set_num_threads(1)

    from . import group
    from .distributed import maybe_initialize_distributed, shutdown

    maybe_initialize_distributed(job["backend"], init_method=init_method)
    if (group.world_size(), group.rank()) != (world, rank):
        raise RuntimeError(f"joined as rank {group.rank()} of {group.world_size()}, "
                           f"expected rank {rank} of {world}")
    try:
        for case in job["cases"]:
            out = run_case(case, job["device"])
            torch.save(out, out_dir / f"{case['name']}.rank{rank}.pt")
            if "param_abs_sum" in out:
                print(f"RESULT {rank} {out['metrics']['loss']:.10f} "
                      f"{out['param_abs_sum']:.6f}", flush=True)
            if "f1" in out:
                print(f"EVALF1 {rank} {out['f1']:.10f}", flush=True)
            del out
            if cuda:    # the ranks share the card: hand back the case's cache
                torch.cuda.empty_cache()
        group.barrier()
    finally:
        shutdown()


def _local_rank(rank: int, cuda: bool) -> int:
    """The card of ``rank``: the ranks share the cards round-robin (more
    ranks than cards, the one-card check, is a world only gloo can run)."""
    return rank % torch.cuda.device_count() if cuda else rank


def backend_for(device, world: int) -> str:
    """The process group backend of a world of ``world`` ranks on
    ``device``'s type: NCCL with a card for every rank, else gloo (the
    ranks share the card, or run on the CPU)."""
    cuda = torch.device(device).type == "cuda"
    return "nccl" if cuda and torch.cuda.device_count() >= world else "gloo"


def case_cfg(case: dict):
    """The case's port config: ``config`` loaded, ``overrides`` merged,
    ``paths`` (``{"DATASET": ..., "OUTPUT": ...}``) set."""
    from ..config import load_cfg

    cfg = load_cfg(case["config"])
    cfg.merge_from_list(list(case.get("overrides", [])))
    for key, value in case.get("paths", {}).items():
        setattr(cfg.PATHS, key, value)
    return cfg


def _model(case: dict, cfg, device):
    """Model + AdamW: from ``checkpoint`` (a file), ``state`` (a state
    dict), or drawn from ``cfg.SEED``."""
    from .. import checkpoints, train_lib
    from ..models.factory import create_network

    if "checkpoint" in case:
        model, optimizer, _ = checkpoints.load_checkpoint(
            None, cfg, net_file=case["checkpoint"], device=device)
        return model, optimizer
    model = create_network(cfg, device=device,
                           generator=torch.Generator().manual_seed(cfg.SEED))
    if "state" in case:
        model.load_state_dict(case["state"], strict=True)
    return model, train_lib.make_optimizer(model, cfg)


def _keep_first_launches(kept: list):
    """A stand-in for ``models.batchnorm.bn_stats`` that launches the
    wrapper (which counts) and keeps host copies of the first launch of
    every (shape, dtype, a is b)."""
    from ..ops.bn_stats import bn_stats

    seen = set()

    def watched(a, b):
        out = bn_stats(a, b)
        key = (tuple(a.shape), str(a.dtype), a is b)
        if key not in seen:
            seen.add(key)
            host = lambda t: t.detach().to("cpu", copy=True)   # noqa: E731
            kept.append({"shape": list(a.shape), "dtype": str(a.dtype)[6:],
                         "same": a is b, "a": host(a),
                         "b": None if a is b else host(b),
                         "out": [host(o) for o in out]})
        return out

    return watched


@contextlib.contextmanager
def _bn_launches(case: dict, device, kept: list):
    """Count the bn_stats launches of the block (``out["launches"]`` once
    it closes) and those of train-mode BatchNorm's elementwise kernels
    (``out["elementwise"]``: batch_norm_apply's, batch_norm_dx's), with
    ``case["keep_bn"]`` the first launch of each
    signature kept in ``kept`` (:func:`_keep_first_launches`), and with
    ``case["dropout"]`` False siamunet_diff's spatial dropout the identity
    (its draws are each package's own, so a step held against the JAX
    package's runs without them)."""
    from ..models import batchnorm, networks
    from ..ops.batch_norm import batch_norm_apply, batch_norm_dx
    from ..ops.bn_stats import bn_stats

    out: dict = {}
    wrapper, dropout = batchnorm.bn_stats, networks.spatial_dropout
    if case.get("keep_bn"):
        batchnorm.bn_stats = _keep_first_launches(kept)
    if not case.get("dropout", True):
        networks.spatial_dropout = lambda x, p, generator, rows=None: x
    try:
        _sync(device)
        bn_stats.launches = batch_norm_apply.launches = batch_norm_dx.launches = 0
        yield out
        _sync(device)
        out["launches"] = bn_stats.launches
        out["elementwise"] = [batch_norm_apply.launches, batch_norm_dx.launches]
    finally:
        batchnorm.bn_stats, networks.spatial_dropout = wrapper, dropout


def _rank_rows(case: dict, cfg, batch: int):
    """This rank's rows of a global batch of ``batch`` (on a grid, its data
    column's): :func:`.group.batch_rows` under the config's GRAD_ACCUM."""
    from . import group

    grid = group.grid(group.space_shards(cfg))
    return torch.as_tensor(group.batch_rows(batch, int(cfg.TRAINER.get("GRAD_ACCUM", 1)),
                                            grid.data_index, grid.data_size))


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _step_case(case: dict, device) -> dict:
    """``steps`` optimizer steps (default 1) of ``regime`` on the global
    batch ``stack`` / ``is_labeled`` (or, without ``stack``, a batch drawn
    from ``synthetic``: :func:`_synthetic_batch`), this rank feeding its
    rows; the metrics of the last, the (summed) gradients, BatchNorm
    buffers and parameters after it, the bn_stats launches and the
    elementwise kernels' (:func:`_bn_launches`).
    ``keep_bn``: also the first launch of each signature
    (:func:`_keep_first_launches`); ``timed_steps``: then the median host
    time of that many more steps and, over one more, the host time inside
    all-reduces (each preceded by a device synchronisation), the halo
    exchanges' apart (:func:`.halo.exchange_`), and the peak device memory
    (on the card); ``count_collectives``: also every collective of the
    steps by call site (``counts``, :func:`_counted_collectives`) and the
    parameters' count and bytes; ``dropout: False`` makes siamunet_diff's
    spatial dropout the identity (its draws are each package's own, so a
    step held against the JAX package's runs without them)."""
    import torch.distributed as dist

    from .. import train_lib
    from ..models.factory import param_count
    from . import group, halo

    cfg = case_cfg(case)
    if "stack" not in case:
        case = dict(case, **_synthetic_batch(*case["synthetic"]))
    model, optimizer = _model(case, cfg, device)
    # the one-process reference computes in the layout of the world's ranks,
    # NCHW (the card's step of a world of one is channels-last): it then
    # differs from the world by the world's reductions, not by bf16 rounding
    # under other convolution algorithms
    memory_format = None if group.initialized() else torch.contiguous_format
    step_fn = train_lib.make_train_step(model, optimizer, cfg, case["regime"],
                                        memory_format)
    index = _rank_rows(case, cfg, case["stack"].shape[0])
    stack = case["stack"][index].to(device)
    is_labeled = case["is_labeled"][index].to(device)
    kept: list = []
    counts: dict = {}
    counting = (_counted_collectives(counts) if case.get("count_collectives")
                else contextlib.nullcontext())
    with _bn_launches(case, device, kept) as counted, counting:
        for i in range(int(case.get("steps", 1))):
            metrics = step_fn(stack, is_labeled, i)
    out = {
        "metrics": {k: float(v) for k, v in metrics.items()},
        "grads": {n: p.grad.detach().float().cpu()
                  for n, p in model.named_parameters()},
        "params": {n: p.detach().cpu() for n, p in model.named_parameters()},
        "buffers": {n: b.detach().cpu() for n, b in model.named_buffers()},
        "launches": counted["launches"],
        "elementwise": counted["elementwise"],
        "bn_kept": kept,
        "param_abs_sum": float(sum(p.detach().abs().double().sum()
                                   for p in model.parameters())),
    }
    if case.get("count_collectives"):
        out.update(counts=counts, param_count=param_count(model),
                   param_bytes=sum(p.numel() * p.element_size()
                                   for p in model.parameters()))
    n_timed = int(case.get("timed_steps", 0))
    cuda = torch.device(device).type == "cuda"
    if n_timed and cuda:
        torch.cuda.reset_peak_memory_stats()
    if n_timed:
        times = []
        for i in range(n_timed):
            _sync(device)
            t0 = time.perf_counter()
            step_fn(stack, is_labeled, i)
            _sync(device)
            times.append(time.perf_counter() - t0)
        # [seconds, calls, bytes] of the halo exchanges and of every other
        # all-reduce
        spent = {"halo": [0.0, 0, 0], "other": [0.0, 0, 0]}
        all_reduce, exchange = dist.all_reduce, halo.exchange_

        def timer(kind, fn):
            def timed(tensor, *args, **kwargs):
                _sync(device)
                t0 = time.perf_counter()
                work = fn(tensor, *args, **kwargs)
                _sync(device)
                acc = spent[kind]
                acc[0] += time.perf_counter() - t0
                acc[1] += 1
                acc[2] += tensor.numel() * tensor.element_size()
                return work
            return timed

        dist.all_reduce = timer("other", all_reduce)
        # the exchange's own all-reduce, untimed by the other wrapper
        halo.exchange_ = timer("halo", lambda buf, pg: all_reduce(buf, group=pg))
        try:
            _sync(device)
            t0 = time.perf_counter()
            step_fn(stack, is_labeled, n_timed)
            _sync(device)
            instrumented = time.perf_counter() - t0
        finally:
            dist.all_reduce, halo.exchange_ = all_reduce, exchange
        out["timing"] = {"step_s": float(np.median(times)), "steps_s": times,
                         "instrumented_s": instrumented,
                         "all_reduce_s": spent["other"][0],
                         "all_reduce_calls": spent["other"][1],
                         "all_reduce_bytes": spent["other"][2],
                         "halo_s": spent["halo"][0], "halo_calls": spent["halo"][1],
                         "halo_bytes": spent["halo"][2],
                         "peak_bytes": torch.cuda.max_memory_allocated() if cuda else 0}
    return out


def _scanned_case(case: dict, device) -> dict:
    """A window of ``make_scanned_train_step`` on the global super-batch
    ``stacks`` / ``is_labeled`` (``(K, B, ...)``), this rank feeding its
    rows of each step's batch; ``eager_steps``: the same K steps through
    ``make_train_step`` one at a time, their metrics reduced as the window
    reduces them (the window's reference). The window's metrics and mode,
    the BatchNorm buffers after it, the bn_stats launches and the
    elementwise kernels' (``keep_bn``: the first bn_stats launch of each
    signature)."""
    from .. import train_lib

    cfg = case_cfg(case)
    model, optimizer = _model(case, cfg, device)
    index = _rank_rows(case, cfg, case["stacks"].shape[1])
    stacks = case["stacks"][:, index].to(device)
    labs = case["is_labeled"][:, index].to(device)
    kept: list = []
    with _bn_launches(case, device, kept) as counted:
        if case.get("eager_steps"):
            step = train_lib.make_train_step(model, optimizer, cfg, case["regime"])
            metrics = train_lib._reduce_window_metrics(
                [step(stacks[i], labs[i], i) for i in range(len(stacks))])
            mode = "eager steps"
        else:
            window = train_lib.make_scanned_train_step(model, optimizer, cfg,
                                                       case["regime"])
            metrics, mode = window(stacks, labs, 0), window.mode
    return {"metrics": {k: float(v) for k, v in metrics.items()}, "mode": mode,
            "buffers": {n: b.detach().cpu() for n, b in model.named_buffers()},
            "launches": counted["launches"], "elementwise": counted["elementwise"],
            "bn_kept": kept}


@contextlib.contextmanager
def _counted_collectives(counts: dict):
    """Count every collective the port makes while the block runs, by call
    site: ``counts[site] = {"kind", "calls", "bytes"}``, the bytes those of
    the tensors handed to ``torch.distributed`` (what crosses the wire).
    The sites are the port's wrappers of its collectives: sync-BN's sums
    (``models.batchnorm._summed_over_ranks``, its flat ``2C`` float32
    all-reduce), ``gradient`` (``group.all_reduce_flat_``), ``global_rows``
    (the global outputs and labels, ``group.global_rows``), ``broadcast``
    (``group.broadcast_``) and ``halo`` (``halo.exchange_``, an all-reduce
    of kind ``halo``); a collective outside them counts under ``other``."""
    import torch.distributed as dist

    from ..models import batchnorm
    from . import group, halo

    open_sites: list = []

    def at(site: str, fn):
        def wrapped(*args, **kwargs):
            open_sites.append(site)
            try:
                return fn(*args, **kwargs)
            finally:
                open_sites.pop()
        return wrapped

    def sent(kind: str, fn):
        def wrapped(tensor, *args, **kwargs):
            site = open_sites[-1] if open_sites else "other"
            rec = counts.setdefault(site, {"kind": "halo" if site == "halo" else kind,
                                           "calls": 0, "bytes": 0})
            rec["calls"] += 1
            rec["bytes"] += tensor.numel() * tensor.element_size()
            return fn(tensor, *args, **kwargs)
        return wrapped

    patches = [(batchnorm, "_summed_over_ranks", "bn_sums"),
               (group, "all_reduce_flat_", "gradient"),
               (group, "global_rows", "global_rows"),
               (group, "broadcast_", "broadcast"), (halo, "exchange_", "halo")]
    saved = [(module, name, getattr(module, name)) for module, name, _ in patches]
    saved += [(dist, "all_reduce", dist.all_reduce), (dist, "broadcast", dist.broadcast)]
    for module, name, site in patches:
        setattr(module, name, at(site, getattr(module, name)))
    dist.all_reduce = sent("all_reduce", dist.all_reduce)
    dist.broadcast = sent("broadcast", dist.broadcast)
    try:
        yield counts
    finally:
        for module, name, fn in saved:
            setattr(module, name, fn)


def _synthetic_batch(batch: int, side: int, seed: int) -> dict:
    """A staged global batch of ``batch`` wire stacks of ``side``² pixels in
    the siamese layout (12 image channels of standard normals, then three
    {0, 1} label planes), all labeled, drawn from ``seed``."""
    gen = torch.Generator().manual_seed(seed)
    images = torch.randn((batch, 12, side, side), generator=gen)
    labels = (torch.rand((batch, 3, side, side), generator=gen) < 0.2).float()
    return {"stack": torch.cat([images, labels], dim=1),
            "is_labeled": torch.ones(batch)}


def _eval_dataset(case: dict, cfg):
    from ..data.dataset import MultimodalCDDataset

    return MultimodalCDDataset(cfg, case.get("split", "validation"),
                               no_augmentations=True, dataset_mode="first_last",
                               disable_multiplier=True, disable_unlabeled=True)


def _scene_items(case: dict) -> list:
    """The case's ``scenes``, full-scene items of ``(H, W, C)`` tensors, as
    the evaluation takes them (numpy arrays)."""
    return [{k: v.numpy() for k, v in item.items()} for item in case["scenes"]]


def _measurer_case(case: dict, device) -> dict:
    """``evaluation.run_measurer`` at threshold 0.5 over the case's split,
    sharded over the ranks (and over the space ranks of the config's
    ``TRAINER.SPATIAL_SHARDS`` grid), or over the item list ``scenes``,
    which every rank evaluates whole: the counts, F1 and confusion
    launches; ``keep_conf``: also host copies of every kernel launch's
    inputs and output."""
    from .. import evaluation
    from ..ops import confusion
    from . import group

    cfg = case_cfg(case)
    model, _ = _model(case, cfg, device)
    ds = _scene_items(case) if "scenes" in case else _eval_dataset(case, cfg)
    kept: list = []
    run = confusion._run
    if case.get("keep_conf"):
        def watched(probs, y, valid, thresholds, strict):
            got = run(probs, y, valid, thresholds, strict)
            kept.append({"args": [a.detach().to("cpu", copy=True)
                                  for a in (probs, y, valid, thresholds)],
                         "out": got.to("cpu", copy=True)})
            return got
        confusion._run = watched
    try:
        _sync(device)
        confusion.confusion_counts.launches = 0
        m = evaluation.run_measurer(model, ds, np.asarray([0.5]),
                                    bucket=evaluation.eval_bucket(cfg),
                                    device=device, shard=case.get("shard"),
                                    space=group.space_shards(cfg))
        _sync(device)
    finally:
        confusion._run = run
    out = {k: torch.as_tensor(np.asarray(getattr(m, k), np.float64))
           for k in ("TP", "TN", "FP", "FN")}
    out["f1"] = float(np.asarray(m.compute_f1()).max())
    out["launches"] = confusion.confusion_counts.launches
    out["conf_kept"] = kept
    return out


def _dualtask_counts_case(case: dict, device) -> dict:
    from .. import evaluation
    from . import group

    cfg = case_cfg(case)
    model, _ = _model(case, cfg, device)
    counts = evaluation.dualtask_quantitative_counts(
        model, _eval_dataset(case, cfg), bucket=evaluation.eval_bucket(cfg),
        device=device, space=group.space_shards(cfg))
    return {k: torch.tensor(v, dtype=torch.float64) for k, v in counts.items()}


def _scene_probs_case(case: dict, device) -> dict:
    """``evaluation.sharded_scene_probabilities`` of the split's scenes
    ``items`` (default: the first), or of the item list ``scenes``, the
    height over every rank of the world or, with ``ranks``, of the process
    group of those ranks (every rank creates it; the others return
    nothing); ``tf32: False`` turns TF32 off on the card. The maps and, on
    the card, the peak device memory."""
    import torch.distributed as dist

    from .. import evaluation
    from . import group

    cfg = case_cfg(case)
    model, _ = _model(case, cfg, device)
    if "scenes" in case:
        ds, items = _scene_items(case), range(len(case["scenes"]))
    else:
        ds, items = _eval_dataset(case, cfg), case.get("items", [0])
    ranks = case.get("ranks")
    process_group = None
    if ranks is not None and group.initialized():
        process_group = dist.new_group(ranks)
        if group.rank() not in ranks:
            return {}
    cuda = torch.device(device).type == "cuda"
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        if not case.get("tf32", True):
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
    try:
        probs = [torch.from_numpy(evaluation.sharded_scene_probabilities(
            model, ds[i], bucket=evaluation.eval_bucket(cfg), device=device,
            process_group=process_group)) for i in items]
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
    return {"probs": probs,
            "peak_bytes": torch.cuda.max_memory_allocated() if cuda else 0}


def _halo_case(case: dict, device) -> dict:
    """The halo exchange (:func:`.halo.halo`) and :func:`.halo.whole` alone
    on the grid of ``space`` space shards, in float64: this rank's block of
    its data column's map ``x[data index]`` (``(D, B, C, H, W)``), each
    ``(top, bottom)`` of ``halos`` applied, and the inner products with
    this rank's ``y`` of the output's shape before and after the adjoint:
    ``<halo(x), y>`` and ``<x, halo*(y)>`` (the backward of the first)."""
    from . import group, halo

    grid = group.grid(case["space"])
    x_all = case["x"][grid.data_index].to(device)
    rows = x_all.shape[2] // grid.space_size
    block = x_all[:, :, grid.space_index * rows:][:, :, :rows]
    out = {"rows": rows}
    gen = torch.Generator().manual_seed(1000 + group.rank())
    with halo.height_sharded(grid, rows):
        for top, bottom in case["halos"]:
            x = block.clone().requires_grad_(True)
            y_out = halo.halo(x, top, bottom)
            y = torch.randn(y_out.shape, generator=gen, dtype=x.dtype).to(device)
            inner = (y_out * y).sum()
            inner.backward()
            out[(top, bottom)] = {"out": y_out.detach().cpu(), "y": y.cpu(),
                                  "grad": x.grad.cpu(), "inner": float(inner.detach()),
                                  "adjoint": float((x * x.grad).sum())}
        x = block.clone().requires_grad_(True)
        y_out = halo.whole(x)
        y = torch.randn(y_out.shape, generator=gen, dtype=x.dtype).to(device)
        inner = (y_out * y).sum()
        inner.backward()
        out["whole"] = {"out": y_out.detach().cpu(), "y": y.cpu(),
                        "grad": x.grad.cpu(), "inner": float(inner.detach()),
                        "adjoint": float((x * x.grad).sum())}
    return out


def _train_case(case: dict, device) -> dict:
    """``trainers.run_training`` on the case's config, logging to
    ``{PATHS.OUTPUT}/logs`` from rank 0 alone, as the training CLIs do."""
    from .. import trainers, wandb_compat
    from ..ops.batch_norm import batch_norm_apply, batch_norm_dx
    from ..ops.bn_stats import bn_stats
    from . import group

    cfg = case_cfg(case)
    if group.rank() == 0:
        wandb_compat.init(name=cfg.NAME, config=cfg, mode="jsonl",
                          out_dir=cfg.PATHS.OUTPUT)
    bn_stats.launches = batch_norm_apply.launches = batch_norm_dx.launches = 0
    try:
        trainers.run_training(cfg, case["regime"], device=device)
    finally:
        wandb_compat.finish()
    return {"launches": bn_stats.launches,
            "elementwise": [batch_norm_apply.launches, batch_norm_dx.launches]}


def _errors_case(case: dict, device) -> dict:
    """The messages of the errors a world of several ranks raises: a
    GRAD_ACCUM micro-batch that does not split over the ranks (batch 2,
    GRAD_ACCUM 2), ``SYNC_BN: False`` and the trainer with a batch the
    world does not divide (batch 3)."""
    from .. import train_lib, trainers

    def message(fn) -> str:
        try:
            fn()
        except ValueError as e:
            return str(e)
        return ""

    cfg = case_cfg(case)
    model, optimizer = _model(case, cfg, device)
    nosync, odd = cfg.clone(), cfg.clone()
    nosync.MODEL.SYNC_BN = False
    nosync.TRAINER.BATCH_SIZE = odd.TRAINER.BATCH_SIZE = 3
    nosync_model, nosync_optimizer = _model(case, nosync, device)
    accum = cfg.clone()
    accum.TRAINER.GRAD_ACCUM = 2
    step_fn = train_lib.make_train_step(model, optimizer, accum, "supervised")
    stack = case["stack"][:1].to(device)
    return {
        "accum": message(lambda: step_fn(stack, None, 0)),
        "sync_bn": message(lambda: train_lib.make_train_step(
            nosync_model, nosync_optimizer, nosync, "supervised")),
        "batch": message(lambda: trainers.training_grid(odd)),
    }


def summary(result: dict) -> dict:
    """A case's result without its per-parameter tensors (gradients,
    parameters; the BatchNorm buffers, a few thousand numbers, stay): what
    a dry run reads."""
    return {k: v for k, v in result.items() if k not in ("grads", "params")}


def _dryrun_case(case: dict, device) -> dict:
    """Every case of ``surfaces`` in order (each with its ``name``), the
    device's cache handed back after each: ``{name: summary}``
    (:func:`summary`), each with the host ``seconds`` its case took."""
    out = {}
    for sub in case["surfaces"]:
        t0 = time.perf_counter()
        out[sub["name"]] = dict(summary(run_case(sub, device)),
                                seconds=time.perf_counter() - t0)
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
    return out


_CASES = {"step": _step_case, "measurer": _measurer_case,
          "dualtask_counts": _dualtask_counts_case, "train": _train_case,
          "errors": _errors_case, "scene_probs": _scene_probs_case,
          "halo": _halo_case, "scanned": _scanned_case, "dryrun": _dryrun_case}


def run_case(case: dict, device=None) -> dict:
    """Run one case of a job on ``device`` (default: the card, as
    :func:`..device.resolve_device` gives it): in a worker, as this rank; in
    a process without a process group, as the one-process reference."""
    from ..device import resolve_device

    return _CASES[case["kind"]](case, resolve_device(device))


def launch_cluster(job: dict, out_dir, world: int = 2, timeout: float = 600,
                   rendezvous: str = "file"):
    """Run ``job`` on a world of ``world`` worker processes (this module,
    ``python -m ... <rank> <world> <rendezvous_file> <job_file>
    <out_dir>``) and return ``(rcs, [(stdout, stderr), ...])``; the
    results are in ``out_dir``.

    ``rendezvous="file"``: a ``file://`` in a fresh temporary directory (no
    port to pick, so no race for one). ``"env"``: ``env://``, each worker's
    environment holding what ``torchrun`` sets (``MSCD_DISTRIBUTED=1``,
    ``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``,
    ``LOCAL_RANK``), on a free port picked here and released for rank 0's
    store to bind: another process may take it in between, and the launch
    then fails with rank 0's bind error in ``rank0.err`` (the caller may
    try again). ``timeout`` bounds the whole
    launch, one shared deadline. A worker that exits non-zero, or is still
    running at the deadline, has every other worker killed: its peers
    would wait for it in a collective. Each worker runs from, and imports
    from, the directory holding this package; its output goes to
    ``rank{r}.out`` / ``rank{r}.err`` in ``out_dir``."""
    repo_root = Path(__file__).resolve().parents[2]
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    job_file = out_dir / "job.pt"
    torch.save(job, job_file)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (str(repo_root), env.get("PYTHONPATH")) if p)
    rdv_dir = tempfile.mkdtemp(prefix="mscd_rendezvous_")
    cuda = job["device"] == "cuda"
    envs = [env] * world
    target = str(Path(rdv_dir) / "init")
    if rendezvous == "env":
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
        envs = [dict(env, MSCD_DISTRIBUTED="1", MASTER_ADDR="127.0.0.1",
                     MASTER_PORT=str(port), WORLD_SIZE=str(world), RANK=str(rank),
                     LOCAL_RANK=str(_local_rank(rank, cuda)))
                for rank in range(world)]
        target = "env"
    logs = [(out_dir / f"rank{r}.out", out_dir / f"rank{r}.err") for r in range(world)]
    procs = []
    try:
        for rank in range(world):
            with open(logs[rank][0], "w") as out, open(logs[rank][1], "w") as err:
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", __name__, str(rank), str(world), target,
                     str(job_file), str(out_dir)],
                    stdout=out, stderr=err, env=envs[rank], cwd=str(repo_root)))
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            rcs = [p.poll() for p in procs]
            if None not in rcs or any(rc not in (None, 0) for rc in rcs):
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        shutil.rmtree(rdv_dir, ignore_errors=True)
    return ([p.returncode for p in procs],
            [(out.read_text(), err.read_text()) for out, err in logs])


if __name__ == "__main__":
    main()
