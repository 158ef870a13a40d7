"""Training traffic: the trainer's inner loop (``trainers._run_epochs``
without its periodic evaluations and checkpoints, as its ``train_time``
leaves them out), built from the port's public pieces:
``MultimodalCDDataset(cfg, 'training')``, ``TrainLoader`` with the
config's thread workers, ``group_batches(·, k)``, ``prefetch_to_device``
and ``train_lib.make_scanned_train_step``'s windows of k steps, epoch after
epoch.

Set-up builds the model, AdamW and the feed once and drives them from the
seed through the first window: steps 1, 2 and 3 as windows of one step
each (the first is eager and captures the step's CUDA graph), the rest of
the window's batches as one call. Their readings (each step's loss, the
first gradient from AdamW's first moment, the change of every parameter
after step 3) are what the reference judges. The timed window continues
the same feed and the same object.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..reference import data as ref_data
from ..reference import judge, models
from ..reference import train as ref_train
from ..yardstick import costs
from ..yardstick.trace import trace

CHECKED_STEPS = 3


class Feed:
    """The trainer's batches, epoch after epoch: ``group_batches`` of the
    loader, staged on the device by ``prefetch_to_device``."""

    def __init__(self, loader, k: int, device):
        from multimodal_siamese_cd_tpu_torch.data.loader import (group_batches,
                                                                 prefetch_to_device)

        def epochs():
            while True:
                inner = prefetch_to_device(group_batches(loader, k), device)
                try:
                    yield from inner
                finally:
                    inner.close()

        self._gen = epochs()

    def next(self) -> dict:
        return next(self._gen)

    def close(self) -> None:
        self._gen.close()


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def build(cell):
    """The model (the seed's weights loaded), AdamW, the loader and the
    window of the configuration's regime; and the weights as made."""
    from multimodal_siamese_cd_tpu_torch import train_lib
    from multimodal_siamese_cd_tpu_torch.data.dataset import MultimodalCDDataset
    from multimodal_siamese_cd_tpu_torch.data.loader import TrainLoader
    from multimodal_siamese_cd_tpu_torch.models.factory import create_network

    cfg = cell.port_cfg()
    model = create_network(cfg, device=cell.device,
                           generator=torch.Generator().manual_seed(0))
    weights = cell.weights()
    model.load_state_dict(weights)
    optimizer = train_lib.make_optimizer(model, cfg)
    loader = TrainLoader(MultimodalCDDataset(cfg, "training"),
                         batch_size=cfg.TRAINER.BATCH_SIZE,
                         shuffle=cfg.DATALOADER.SHUFFLE,
                         num_workers=cfg.DATALOADER.NUM_WORKER, seed=cfg.SEED,
                         worker_type=cfg.DATALOADER.get("WORKER_TYPE", "thread"))
    k = int(cfg.TRAINER.STEPS_PER_EXECUTION)
    if len(loader) % k or cfg.LOG_FREQ % k:
        raise ValueError(f"{len(loader)} steps an epoch and LOG_FREQ {cfg.LOG_FREQ} "
                         f"must be whole windows of {k}, or the trainer runs k = 1")
    window = train_lib.make_scanned_train_step(model, optimizer, cfg,
                                               cell.config["regime"])
    return cfg, model, optimizer, loader, window, weights


def first_window(cell, model, optimizer, window, feed, weights) -> dict:
    """Steps 1..k of the feed's first group through the window's own call,
    steps 1-3 one at a time; returns their readings and the delivered rows
    of steps 1-3 on the host."""
    group = feed.next()
    stacks, labs = group["stack"], group["is_labeled"]
    names = [n for n, _ in model.named_parameters()]
    readings = {"loss": [], "grad": None, "stats": None}
    for i in range(CHECKED_STEPS):
        m = window(stacks[i:i + 1], labs[i:i + 1], i)
        readings["loss"].append(float(m["loss"]))
        if i == 0:
            readings["stats"] = judge.stats_change(model, weights)
            # AdamW's first moment after one step is (1 - beta1) * g; an
            # optimizer that kept no moment read no gradient
            state = optimizer.state
            readings["grad"] = judge.norms({
                n: state[p].get("exp_avg", torch.zeros_like(p))
                / (1 - optimizer.defaults["betas"][0])
                for n, p in zip(names, model.parameters())})
    readings["change"] = judge.norms({n: p.detach() - weights[n]
                                      for n, p in model.named_parameters()})
    rows = {"stack": stacks[:CHECKED_STEPS].cpu().numpy(),
            "is_labeled": labs[:CHECKED_STEPS].cpu().numpy(),
            "aoi_id": group["aoi_id"][:CHECKED_STEPS],
            "t1": [list(zip(y, m)) for y, m in zip(group["year_t1"][:CHECKED_STEPS],
                                                  group["month_t1"][:CHECKED_STEPS])],
            "t2": [list(zip(y, m)) for y, m in zip(group["year_t2"][:CHECKED_STEPS],
                                                  group["month_t2"][:CHECKED_STEPS])]}
    window(stacks[CHECKED_STEPS:], labs[CHECKED_STEPS:], CHECKED_STEPS)
    return {"readings": readings, "rows": rows, "k": len(stacks), "batch": stacks.shape[1]}


def reference_batches(cell, first: dict) -> tuple:
    """The batches the reference finds in the fixture where the program's
    checked rows came from, their label masks, and the count of delivered
    rows it could not find (or whose label flag is wrong)."""
    s = cell.settings
    fx = ref_data.Fixture(cell.fixture_root(), s["DATALOADER.S1_BANDS"],
                          s["DATALOADER.S2_BANDS"],
                          s["DATALOADER.INCLUDE_BUILDING_LABELS"])
    rows = first["rows"]
    unmatched, batches, labs = 0, [], []
    scenes = {}
    for i in range(CHECKED_STEPS):
        found = []
        for r, crop in enumerate(rows["stack"][i]):
            aoi = rows["aoi_id"][i][r]
            key = (aoi, tuple(map(int, rows["t1"][i][r])), tuple(map(int, rows["t2"][i][r])))
            if key not in scenes:
                scenes = {key: fx.stack(*key)}
            pos = ref_data.locate(scenes[key], crop)
            if pos is None or fx.labeled(aoi) != bool(rows["is_labeled"][i][r]):
                unmatched += 1
                found.append(crop)
            else:
                y, x = pos
                n = crop.shape[-1]
                found.append(scenes[key][:, y:y + n, x:x + n])
        batches.append(np.stack(found))
        labs.append(rows["is_labeled"][i])
    return batches, labs, unmatched


def reference(cell, batches: list, labs: list, weights: dict, quantized: bool = False,
              rows_kept: slice = slice(None), dtype=torch.float32) -> dict:
    """The reference's three steps from the same weights on ``batches``, in
    ``dtype`` (``quantized``: the control's float8; ``rows_kept``: the rows
    each step keeps, a planted fault): each step's loss, the first
    gradient's norms, every step's gradient norms, and the norms of the
    change, per leaf."""
    s = cell.settings
    spec = cell.model_spec()
    net = models.build(spec).to(cell.device, dtype)
    net.load_state_dict(weights)
    conf = {**spec, "regime": cell.config["regime"], "lr": s["TRAINER.LR"],
            "flip": s["AUGMENTATION.RANDOM_FLIP"], "rotate": s["AUGMENTATION.RANDOM_ROTATE"],
            "alpha": s.get("CONSISTENCY_TRAINER.LOSS_FACTOR", 0.0)}
    xs = [torch.from_numpy(b[rows_kept].astype(np.float32)).to(cell.device) for b in batches]
    ls = [torch.from_numpy(lab[rows_kept]).to(cell.device) for lab in labs]
    models.Quantized.on = quantized
    try:
        with judge.float32_exact():
            out = ref_train.run_steps(net, xs, ls, conf, cell.seed)
    finally:
        models.Quantized.on = False
    start = {k: v.to(dtype) for k, v in weights.items()}
    return {"loss": out["loss"], "grad": judge.norms(out["grad"]),
            "grad_steps": out["grad_norms"], "stats": out["stats"],
            "change": judge.norms({k: v - start[k] for k, v in out["params"].items()})}


def judged(cell, first: dict, weights: dict) -> dict:
    """The numbers of a run: the program's readings against the reference,
    run in float64. In float32 its round-off on a gradient that is nought
    (a step whose loss has none) is far above AdamW's eps, so it would move
    every leaf by a step the program, whose bf16 gradient there is exactly
    0, rightly does not take."""
    batches, labs, unmatched = reference_batches(cell, first)
    ref = reference(cell, batches, labs, weights, dtype=torch.float64)
    moved = judge.moved_leaves(ref["grad_steps"])
    return {**judge.train_numbers(first["readings"], ref, moved), "unmatched_rows": unmatched,
            "_ref": ref, "_moved": moved, "_batches": (batches, labs)}


def run(cell) -> dict:
    device = cell.device
    cfg, model, optimizer, loader, window, weights = build(cell)
    k, batch = int(cfg.TRAINER.STEPS_PER_EXECUTION), int(cfg.TRAINER.BATCH_SIZE)
    spans = cell.spans
    feed = Feed(loader, k, device)
    out = {}
    try:
        first = first_window(cell, model, optimizer, window, feed, weights)
        sync(device)
        out["setup_s"] = time.perf_counter() - cell.t0
        state = {"step": first["k"], "windows": 0}

        def windows(until=None, count=None):
            while True:
                with spans("data_wait"):
                    group = feed.next()
                with spans("window"):
                    window(group["stack"], group["is_labeled"], state["step"])
                state["step"] += k
                state["windows"] += 1
                if (count is not None and state["windows"] >= count) or \
                        (until is not None and time.perf_counter() >= until):
                    return

        if cell.trace:
            traced = trace(lambda: windows(count=cell.traffic["trace_windows"]), spans, device)
        else:
            t0 = time.perf_counter()
            windows(until=t0 + cell.seconds)
            sync(device)
            elapsed = time.perf_counter() - t0
            out["e2e"] = {"train_patches_per_s": state["windows"] * k * batch / elapsed}
        out["attempted"] = out_steps = state["windows"] * k
        out["failed"] = 0
        if device.type == "cuda":
            out["memory_peak_bytes"] = torch.cuda.max_memory_allocated(device)
    finally:
        feed.close()
        loader.close()
    del model, optimizer, window
    if device.type == "cuda":
        torch.cuda.empty_cache()

    numbers = {k: v for k, v in judged(cell, first, weights).items() if not k.startswith("_")}
    out["checks"] = judge.check(numbers, cell.limits)
    out["numbers"] = numbers
    if cell.trace:
        spec, side = cell.model_spec(), int(cfg.AUGMENTATION.CROP_SIZE)
        out["ctx"] = {
            "traced": traced, "spans": spans, "steps": out_steps, "windows": state["windows"],
            "patches": out_steps * batch, "device_name": _device_name(device),
            "forward_flops_per_patch": costs.forward_flops(spec, 1, side),
            "bn_stats_bytes_per_step": costs.bn_stats_bytes(spec, batch, side),
        }
    return out


def _device_name(device) -> str | None:
    return torch.cuda.get_device_name(device) if device.type == "cuda" else None
