"""Full-scene evaluation and offline inference (the JAX package's
``evaluation.py:47-352, 400-509``, single device).

Protocol (reference utils/evaluation.py:7-41): first_last / no-aug /
no-multiplier dataset, sigmoid probabilities of full scenes, threshold 0.5,
max-F1 over thresholds. Scenes are padded to bucketed sizes (multiples of 64
by default, ``TRAINER.EVAL_PAD_MULTIPLE``) and the padding is excluded from
the counts by a validity mask; scenes that share a padded shape run as one
batched forward. The per-scene counts go through
:func:`.ops.confusion.confusion_counts` — the CUDA kernel on the card.

``inference_loop`` is what assessment_change.py calls; ``model_evaluation``
is the trainer's in-training evaluation with its wandb logging (on a
dual-task model, of its change head). ``dualtask_quantitative_counts`` is
the dual-task assessment's pooled strict-threshold counts
(assessment_semantics.py), through the kernel's strict variant;
``dualtask_scene_outputs`` gives one scene's four heads.

In a world of several ranks (:mod:`.parallel`) the wire paths shard every
scene group over the ranks, as the JAX package's ``_shard_group`` shards it
over the data mesh: the group grows with the world, is padded to a multiple
of it with zero-valid scenes (their counts are exactly zero), and each rank
runs the forward of its contiguous share; the per-group counts are summed
over the ranks (exact integers), so every rank ends with the same
measurer, as the JAX package's replicated counts give every process. Every
rank builds the same groups from every wire and makes the same number of
forwards and collectives.

On a ``TRAINER.SPATIAL_SHARDS`` grid (``space > 1``, :class:`.parallel.
Grid`) the groups are sharded over the data columns as above, and each
scene's padded height over the column's space ranks whenever it divides
(the JAX package's ``_shard_group`` rule, evaluation.py:155-178): each rank
runs the height-sharded forward (:mod:`.parallel.halo`) on its block and
counts it with the confusion kernel, and the counts are summed over the
world, exactly. A height that does not divide runs whole on every space
rank and is counted by space index 0. :func:`sharded_scene_probabilities`
splits one scene's height over every rank of the world.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import wandb_compat
from .data.dataset import MultimodalCDDataset
from .device import resolve_device
from .metrics import MultiThresholdMetric
from .ops.confusion import confusion_counts, strict_confusion_counts
from .parallel import group as _group
from .parallel import halo
from .train_lib import autocast, eval_forward

EVAL_BUCKET = 64

# Scene-batched eval group policy: scenes per forward scale inversely with
# padded area inside a fixed memory envelope (16 scenes of 1024^2). The
# formula and values are the JAX package's; they have NOT been measured on
# the H100 — chip_smoke.py prints the peak device memory of one full group
# so they can be re-derived for 80 GB.
EVAL_GROUP_BUDGET_PX = 16 * 1024 * 1024
EVAL_GROUP_CAP = 16
# Host-side bound on one buffered wire group (np.stack transiently doubles
# the group, so the cap compares 2x wire bytes against this budget).
HOST_WIRE_BUDGET_BYTES = 2 << 30


def eval_bucket(cfg) -> int:
    """The padding bucket a config asks for: ``TRAINER.EVAL_PAD_MULTIPLE``
    (1 = exact shapes) or the 64-pixel default."""
    return int(cfg.TRAINER.get('EVAL_PAD_MULTIPLE', EVAL_BUCKET))


def eval_group_limit(shape) -> int:
    """Max scenes per batched eval forward for a padded scene ``shape``."""
    return max(1, min(EVAL_GROUP_CAP,
                      EVAL_GROUP_BUDGET_PX // (shape[0] * shape[1])))


def pad_to_bucket(arr: np.ndarray, bucket: int = EVAL_BUCKET):
    """Pad (H, W, C) up to multiples of ``bucket``; returns (padded, valid)
    where valid is the (H_pad, W_pad) float32 {0,1} mask of real pixels.
    ``bucket=1`` is the exact-shape (no padding) mode."""
    h, w = arr.shape[:2]
    hp = -(-h // bucket) * bucket
    wp = -(-w // bucket) * bucket
    padded = np.zeros((hp, wp) + arr.shape[2:], arr.dtype)
    padded[:h, :w] = arr
    valid = np.zeros((hp, wp), np.float32)
    valid[:h, :w] = 1.0
    return padded, valid


def _nchw(batch_hwc: np.ndarray, device: torch.device) -> torch.Tensor:
    """(B, H, W, C) host array -> (B, C, H, W) float32 tensor on device."""
    return torch.from_numpy(np.ascontiguousarray(
        batch_hwc.transpose(0, 3, 1, 2))).to(device).float()


def _check_model_device(model, device: torch.device) -> None:
    p = next(model.parameters())
    if p.device.type != device.type or (
            device.index is not None and p.device.index != device.index):
        raise ValueError(f"model is on {p.device}, evaluation asked for "
                         f"{device}")


def scene_probabilities(model, item: dict, bucket: int = EVAL_BUCKET,
                        device=None) -> np.ndarray:
    """Eval-mode change probabilities ``(h, w)`` for one full (unpadded)
    scene item — the serving forward, cropped back to the scene."""
    device = resolve_device(device)
    _check_model_device(model, device)
    x1, _ = pad_to_bucket(item["x_t1"], bucket)
    x2, _ = pad_to_bucket(item["x_t2"], bucket)
    probs = eval_forward(model, _nchw(x1[None], device), _nchw(x2[None], device))
    h, w = item["x_t1"].shape[:2]
    return probs[0, 0, :h, :w].cpu().numpy()


def sharded_scene_probabilities(model, item: dict, bucket: int = EVAL_BUCKET,
                                device=None, process_group=None) -> np.ndarray:
    """:func:`scene_probabilities` with the scene's height split over every
    rank of ``process_group`` (default: the world; the JAX package's
    ``sharded_scene_probabilities``, evaluation.py:355-398): each rank runs
    the height-sharded forward (:mod:`.parallel.halo`) on its block of the
    padded scene, and the blocks are made whole on every rank. When the
    ranks do not divide the padded height, the height (alone) is padded
    further, to a multiple of ``lcm(bucket, ranks)``, as the JAX package
    does. Every rank of the group must call it; each returns the whole
    ``(h, w)`` map."""
    device = resolve_device(device)
    _check_model_device(model, device)
    grid = _group.scene_grid(process_group)
    x1, _ = pad_to_bucket(item["x_t1"], bucket)
    x2, _ = pad_to_bucket(item["x_t2"], bucket)
    n = grid.space_size
    if x1.shape[0] % n:
        step = math.lcm(bucket, n)
        hp = -(-x1.shape[0] // step) * step
        x1, x2 = (np.concatenate([a, np.zeros((hp - a.shape[0],) + a.shape[1:],
                                              a.dtype)]) for a in (x1, x2))
    rows = x1.shape[0] // n
    block = slice(grid.space_index * rows, (grid.space_index + 1) * rows)
    with halo.height_sharded(grid, rows):
        probs = eval_forward(model, _nchw(x1[None, block], device),
                             _nchw(x2[None, block], device))
        if n > 1:
            with torch.inference_mode():
                probs = halo.whole(probs, grid)
    h, w = item["x_t1"].shape[:2]
    return probs[0, 0, :h, :w].cpu().numpy()


def _to_device(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host array -> device tensor; on the card through a pinned host
    buffer and a non-blocking copy on the current stream."""
    t = torch.from_numpy(arr)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def _eval_wire_counts(model, x1p: np.ndarray, x2p: np.ndarray, y: np.ndarray,
                      valid: np.ndarray, thresholds: torch.Tensor,
                      device: torch.device) -> torch.Tensor:
    """Eval forward + confusion for one padded scene group: planar wires
    ``(B, C, Hp, Wp)`` in the cache's storage dtype and uint8 ``(B, Hp,
    Wp)`` label / valid planes in, ``(B, 4, T)`` int64 tp/tn/fp/fn counts
    out, left on the device (no synchronisation here). The float32 upcast
    happens on the device, so the forward sees what the float32 item path
    sees."""
    x1 = _to_device(x1p, device).float()
    x2 = _to_device(x2p, device).float()
    yt = _to_device(y, device)
    vt = _to_device(valid, device)
    probs = eval_forward(model, x1, x2)
    n = probs.shape[0]
    return confusion_counts(probs.reshape(n, -1), yt.reshape(n, -1),
                            vt.reshape(n, -1), thresholds)


def _stream_wire_groups(wires, keys: tuple, run_group, accumulate,
                        group_scale: int = 1, shard=None, space: int = 1) -> None:
    """Group ``wires`` (an iterable of eval wires, as
    :meth:`.data.dataset.MultimodalCDDataset.eval_wire` or
    :func:`_dualtask_item_wire` give them) by padded shape and dispatch a
    group the moment it fills, with ONE group in flight: while the card
    runs group N the host assembles group N+1, and group N's counts are
    fetched only when group N+1 is dispatched. Tails are flushed at the
    end. Accumulation order equals a sequential loop's. The engine behind
    the fused eval paths (:func:`_measure_wired`,
    :func:`dualtask_quantitative_counts`, :func:`dualtask_item_counts`).

    ``run_group(arrs)`` dispatches one stacked group (the wire's ``keys``,
    in order) and returns its per-scene device counts; ``accumulate(counts)``
    folds their sum over the scenes (int64, on the device) into the host's
    totals. ``group_scale`` divides :func:`eval_group_limit`'s memory
    envelope for dispatches that hold more live bytes per scene than the
    change-head forward it was set for.

    ``shard = (rank, world)``: every group takes up to ``world`` times the
    envelope, is padded to a multiple of ``world`` with zero-valid scenes,
    and rank ``rank`` dispatches its contiguous share (the module
    docstring). Default: this process's data column in the grid of
    ``space`` space shards (:func:`.parallel.grid`; 1: the data-parallel
    world), each scene's padded height split over the column's space ranks
    when it divides, and each group's counts summed over the world; an
    explicit ``shard`` counts that share alone, whole (what one data rank
    contributes, reproduced in one process)."""
    grid = _group.grid(space) if shard is None else None
    if shard is None:
        rank, world, reduce = grid.data_index, grid.data_size, True
    else:
        (rank, world), reduce = shard, False
    pending: dict = {}
    inflight: list = []

    def consume() -> None:
        counts = inflight.pop(0).sum(dim=0)
        if reduce:
            _group.all_reduce_(counts)
        accumulate(counts)

    def dispatch(group: list) -> None:
        share = -(-len(group) // world)
        mine = group[rank * share:(rank + 1) * share]
        mine += [{k: np.zeros_like(group[0][k]) for k in keys}] * (share - len(mine))
        hp = group[0][keys[0]].shape[-2]
        n = 1 if grid is None else grid.space_size
        rows = hp // n if hp % n == 0 else hp
        # the height block of a (C, Hp, Wp) wire or an (Hp, Wp) plane
        start = grid.space_index * rows if rows < hp else 0
        arrs = tuple(np.stack([g[k][..., start:start + rows, :] for g in mine])
                     for k in keys)
        if inflight:  # bound device residency to one group + one staged
            consume()
        with halo.height_sharded(grid if rows < hp else None, rows):
            counts = run_group(arrs)
        if n > 1 and rows == hp and grid.space_index:
            counts = torch.zeros_like(counts)    # space index 0 counts it
        inflight.append(counts)

    for wire in wires:
        group = pending.setdefault(wire['x1'].shape, [])
        group.append(wire)
        wire_bytes = sum(v.nbytes for v in wire.values()
                         if isinstance(v, np.ndarray))
        host_cap = max(1, HOST_WIRE_BUDGET_BYTES // max(1, 2 * wire_bytes))
        target = min(max(1, eval_group_limit(wire['x1'].shape[1:]) // group_scale)
                     * world, host_cap)
        if len(group) >= target:
            dispatch(group)  # np.stack copies, so the list can be reused
            group.clear()
    for group in pending.values():
        if group:
            dispatch(group)
    while inflight:
        consume()


def _measure_wired(model, ds, measurer: MultiThresholdMetric, bucket: int,
                   device: torch.device, shard=None,
                   space: int = 1) -> MultiThresholdMetric:
    """Streaming group evaluation over ``ds.eval_wire`` wires with float64
    host accumulation of the kernel's counts."""
    thr = torch.as_tensor(measurer.thresholds, device=device)
    _stream_wire_groups(
        (ds.eval_wire(i, bucket) for i in range(len(ds))),
        ('x1', 'x2', 'y', 'valid'),
        run_group=lambda arrs: _eval_wire_counts(model, *arrs, thr, device),
        accumulate=lambda counts: measurer.add_counts(
            *counts.cpu().numpy().astype(np.float64)),
        shard=shard, space=space)
    return measurer


def run_measurer(model, ds, thresholds, bucket: int = EVAL_BUCKET, device=None,
                 shard=None, space: int = 1) -> MultiThresholdMetric:
    """Full-scene confusion accumulation over a dataset.

    A cache-backed :class:`.data.dataset.MultimodalCDDataset` takes the wire
    path (:func:`_measure_wired`), sharded over the ranks of a
    multi-process world (``shard``, ``space``: the grid's space shards,
    :func:`_stream_wire_groups`). Item
    lists and cache-disabled datasets take the item path, which every rank
    runs whole: padded float32 items, scenes of one padded shape stacked
    into one forward, counts per scene."""
    device = resolve_device(device)
    _check_model_device(model, device)
    measurer = MultiThresholdMetric(thresholds)
    if getattr(ds, 'supports_eval_wire', None) is not None and ds.supports_eval_wire():
        return _measure_wired(model, ds, measurer, bucket, device, shard, space)

    def flush(chunk: list) -> None:
        probs = eval_forward(model,
                             _nchw(np.stack([s[0] for s in chunk]), device),
                             _nchw(np.stack([s[1] for s in chunk]), device))
        for i, (_, _, y, valid) in enumerate(chunk):
            measurer.add_sample(torch.from_numpy(y[..., 0]).to(device),
                                probs[i, 0],
                                valid_mask=torch.from_numpy(valid).to(device))

    # each shape bucket is evaluated the moment it fills, so host memory is
    # bounded by (buckets in flight) * group_limit padded scenes
    pending: dict = {}
    for item in ds:
        x1, valid = pad_to_bucket(item["x_t1"], bucket)
        x2, _ = pad_to_bucket(item["x_t2"], bucket)
        y, _ = pad_to_bucket(item["y_change"], bucket)
        group = pending.setdefault(x1.shape, [])
        group.append((x1, x2, y, valid))
        if len(group) >= eval_group_limit(x1.shape):
            flush(group)
            group.clear()
    for group in pending.values():
        if group:
            flush(group)
    return measurer


def _summarize(measurer: MultiThresholdMetric):
    f1s = np.asarray(measurer.compute_f1())
    precisions = np.asarray(measurer.precision)
    recalls = np.asarray(measurer.recall)
    best = int(f1s.argmax())
    return float(f1s[best]), float(precisions[best]), float(recalls[best])


def model_evaluation(model, cfg, run_type: str, epoch: float, step: int,
                     device=None) -> float:
    """In-training eval + logging (reference evaluation.py:7-41; the JAX
    package's ``model_evaluation``): the ``run_type`` split's full scenes,
    first-last pairs, no augmentation, threshold 0.5. Logs
    ``{run_type} F1/precision/recall`` with the step and epoch and returns
    the F1. On the training grid (``TRAINER.SPATIAL_SHARDS``) the scenes'
    heights are split over its space ranks."""
    thresholds = np.linspace(0.5, 1, 1)
    ds = MultimodalCDDataset(cfg, run_type, no_augmentations=True,
                             dataset_mode='first_last', disable_multiplier=True,
                             disable_unlabeled=True)
    measurer = run_measurer(model, ds, thresholds, bucket=eval_bucket(cfg),
                            device=device, space=_group.space_shards(cfg))
    f1, precision, recall = _summarize(measurer)
    wandb_compat.log({
        f'{run_type} F1': f1,
        f'{run_type} precision': precision,
        f'{run_type} recall': recall,
        'step': step, 'epoch': epoch,
    })
    return f1


def inference_loop(model, ds, thresholds=None, bucket: int = EVAL_BUCKET,
                   device=None) -> dict:
    """Offline quantitative inference (the contract assessment_change.py
    expects): ``{'change': (f1, precision, recall)}`` over the dataset at
    threshold 0.5 (or the best of ``thresholds``). ``device`` defaults to
    the card."""
    thresholds = np.asarray([0.5]) if thresholds is None else np.asarray(thresholds)
    measurer = run_measurer(model, ds, thresholds, bucket=bucket, device=device)
    return {'change': _summarize(measurer)}


def _dualtask_forward(model, x_t1: torch.Tensor, x_t2: torch.Tensor) -> tuple:
    """Eval-mode sigmoid probabilities of every dual-task head for NCHW
    inputs, each ``(B, 1, H, W)`` float32: ``(change, sem_t1, sem_t2,
    change_sem)``, the last from the auxiliary head on the semantic logits
    (the JAX package's ``_dualtask_forward``). Runs under
    ``torch.inference_mode()`` and, on the card, the model's compute
    dtype."""
    model.eval()
    dtype = getattr(model, "compute_dtype", torch.float32)
    with torch.inference_mode(), autocast(dtype, x_t1.device):
        change, sem_t1, sem_t2 = model(x_t1, x_t2)
        change_sem = model.sem_change_head(sem_t1, sem_t2)
        return tuple(torch.sigmoid(t.float())
                     for t in (change, sem_t1, sem_t2, change_sem))


def dualtask_scene_outputs(model, item: dict, bucket: int = EVAL_BUCKET,
                           device=None) -> dict:
    """All sigmoid heads of a dual-task model for one full scene item,
    cropped back to the scene: ``{'change', 'sem_t1', 'sem_t2',
    'change_sem'}`` (h, w) float32 arrays (assessment_semantics.py:
    115-126)."""
    device = resolve_device(device)
    _check_model_device(model, device)
    x1, _ = pad_to_bucket(item["x_t1"], bucket)
    x2, _ = pad_to_bucket(item["x_t2"], bucket)
    heads = _dualtask_forward(model, _nchw(x1[None], device),
                              _nchw(x2[None], device))
    h, w = item["x_t1"].shape[:2]
    return {k: p[0, 0, :h, :w].cpu().numpy()
            for k, p in zip(("change", "sem_t1", "sem_t2", "change_sem"), heads)}


# row order of _dualtask_wire_counts' (B, 4, 3) result
_DUALTASK_BLOCKS = ("change", "change_sem", "sem_t1", "sem_t2")


def _dualtask_wire_counts(model, x1p: np.ndarray, x2p: np.ndarray,
                          ych: np.ndarray, ysem1: np.ndarray, ysem2: np.ndarray,
                          valid: np.ndarray, device: torch.device) -> torch.Tensor:
    """Dual-task forward and strict-threshold counts (``p > 0.5``) for one
    padded scene group: ``(B, 4, 3)`` int64 (tp, fp, fn) per scene, rows in
    :data:`_DUALTASK_BLOCKS` order, left on the device. One launch of the
    kernel's strict variant per head; the semantic heads are counted per
    date and pooled on the host."""
    x1 = _to_device(x1p, device).float()
    x2 = _to_device(x2p, device).float()
    labels = {k: _to_device(a, device) for k, a in
              (("y", ych), ("ysem1", ysem1), ("ysem2", ysem2), ("valid", valid))}
    change, sem_t1, sem_t2, change_sem = _dualtask_forward(model, x1, x2)
    n = change.shape[0]
    vt = labels["valid"].reshape(n, -1)
    thr = torch.tensor([0.5], dtype=torch.float32, device=device)
    rows = []
    for probs, truth in ((change, "y"), (change_sem, "y"), (sem_t1, "ysem1"),
                         (sem_t2, "ysem2")):
        counts = strict_confusion_counts(probs.reshape(n, -1),
                                         labels[truth].reshape(n, -1), vt, thr)
        rows.append(counts[:, [0, 2, 3], 0])           # tp, fp, fn
    return torch.stack(rows, dim=1)


def _pooled_dualtask_counts(model, wires, device, space: int = 1) -> dict:
    """Stream dual-task ``wires`` through :func:`_dualtask_wire_counts` and
    pool the per-scene counts on the host in float64, the semantic ones
    over both dates."""
    device = resolve_device(device)
    _check_model_device(model, device)
    totals = {k: np.zeros(3, np.float64) for k in ("change", "change_sem", "sem")}

    def accumulate(counts: torch.Tensor) -> None:
        pooled = counts.cpu().numpy().astype(np.float64)   # (4, 3)
        for row, k in zip(pooled, _DUALTASK_BLOCKS):
            totals["sem" if k.startswith("sem_") else k] += row

    # group_scale=2: a group holds about twice the change-head forward's live
    # bytes per scene (a second decoder pass on each date, four probability
    # rasters), so it takes half the scenes (the JAX package's choice)
    _stream_wire_groups(
        wires, ("x1", "x2", "y", "ysem1", "ysem2", "valid"),
        run_group=lambda arrs: _dualtask_wire_counts(model, *arrs, device),
        accumulate=accumulate, group_scale=2, space=space)
    return {k: tuple(v) for k, v in totals.items()}


def dualtask_quantitative_counts(model, ds, bucket: int = EVAL_BUCKET,
                                 device=None, space: int = 1) -> dict | None:
    """Pooled strict-threshold confusion counts of the dual-task offline
    assessment (the JAX package's ``dualtask_quantitative_counts``, behind
    assessment_semantics.py): ``{'change'|'change_sem'|'sem': (tp, fp,
    fn)}`` float64 over the split, the semantic counts pooled over both
    dates; feed them to :func:`.metrics.prob_metrics_from_counts`. Scenes
    are grouped by padded shape with one group in flight, per-scene counts
    summed on the host in float64. None when the dataset has no wire path
    (cache disabled or training mode): the caller then takes the item
    path, :func:`dualtask_item_counts`. ``space``: the grid's space shards
    (:func:`_stream_wire_groups`)."""
    if getattr(ds, "supports_eval_wire", None) is None \
            or not ds.supports_eval_wire():
        return None
    return _pooled_dualtask_counts(
        model, (ds.eval_wire(i, bucket, sem=True) for i in range(len(ds))),
        device, space)


def _dualtask_item_wire(item: dict, bucket: int) -> dict:
    """One full scene item in the dual-task wire layout: bucket-padded
    float32 ``x1``/``x2`` (C, Hp, Wp) and uint8 ``y``/``ysem1``/``ysem2``
    truth planes (``label > 0.5``) and ``valid`` plane (Hp, Wp)."""
    x1, valid = pad_to_bucket(item["x_t1"], bucket)
    x2, _ = pad_to_bucket(item["x_t2"], bucket)
    h, w = item["x_t1"].shape[:2]
    wire = {"x1": np.ascontiguousarray(x1.transpose(2, 0, 1), np.float32),
            "x2": np.ascontiguousarray(x2.transpose(2, 0, 1), np.float32),
            "valid": valid.astype(np.uint8)}
    for key, label in (("y", "y_change"), ("ysem1", "y_sem_t1"),
                       ("ysem2", "y_sem_t2")):
        truth, _ = pad_to_bucket(np.asarray(item[label]).reshape(h, w) > 0.5,
                                 bucket)
        wire[key] = truth.astype(np.uint8)
    return wire


def dualtask_item_counts(model, ds, bucket: int = EVAL_BUCKET,
                         device=None) -> dict:
    """:func:`dualtask_quantitative_counts` for a dataset without the wire
    path (scene cache off) or a list of scene items: each float32 item is
    padded into the wire layout and counted on the device by the kernel's
    strict variant, the counts pooled on the host in float64. Counting
    then summing equals pooling every scene's pixels then counting, the
    reference's protocol."""
    return _pooled_dualtask_counts(
        model, (_dualtask_item_wire(item, bucket) for item in ds), device)
