"""Training core and forward passes (the JAX package's ``train_lib.py``).

The supervised, semi-supervised and dual-task steps: the wire stack is cast
to the compute dtype and augmented on the device, the model runs in train
mode (bf16 autocast on the card, fp32 params; fp32 on the CPU), the losses
are taken on fp32 logits, and AdamW updates the parameters in place.

The step's activations are laid out as :func:`step_memory_format` decides
from what it can observe: channels-last on the card in a world of one rank
with no height shards (cuDNN's convolutions compute in NHWC, so they then
need no transposes, and BatchNorm's kernels take NHWC), NCHW everywhere
else. Logical shapes stay ``(B, C, H, W)`` at every function.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from . import losses, tracing
from .data.augmentations import apply_augmentation, draw_augmentation
from .models.batchnorm import BatchNorm2d
from .models.factory import compute_dtype
from .models.networks import DropoutDraws
from .parallel import group, halo


def make_optimizer(model, cfg) -> torch.optim.AdamW:
    """AdamW with the reference's hyperparameters: lr from TRAINER.LR,
    weight decay 0.01, betas (0.9, 0.999), eps 1e-8 (reference
    train_supervised.py:32). Algebraically the JAX package's
    ``optax.adamw``: both step ``p -= lr·(m̂ / (√v̂ + eps) + wd·p)``, with
    decay on every parameter."""
    return torch.optim.AdamW(model.parameters(), lr=cfg.TRAINER.LR,
                             betas=(0.9, 0.999), eps=1e-8, weight_decay=0.01)


# --------------------------------------------------------------------------
# Batch stack layout
# --------------------------------------------------------------------------

def stack_layout(cfg) -> dict:
    """Static channel offsets of the joint training stack:
    [s1_t1 | s1_t2 | s2_t1 | s2_t2 | buildings_t1 | buildings_t2 | change].
    The loader's planar ``(B, C, S, S)`` wire is already NCHW."""
    n_s1 = len(cfg.DATALOADER.S1_BANDS)
    n_s2 = len(cfg.DATALOADER.S2_BANDS)
    return {
        "n_s1": n_s1,
        "n_s2": n_s2,
        "n_img": 2 * n_s1 + 2 * n_s2,
        "input_mode": cfg.DATALOADER.INPUT_MODE,
    }


def step_memory_format(device, world: int, space_shards: int) -> torch.memory_format:
    """The memory layout of a training step's activations and weights:
    ``torch.channels_last`` on a CUDA ``device`` in a world of one rank with
    no height shards, where the step runs as one captured graph, else
    ``torch.contiguous_format`` (NCHW: the CPU, whose tests hold the port
    against the JAX package, worlds of several ranks and height-sharded
    grids)."""
    if torch.device(device).type == "cuda" and world == 1 and space_shards == 1:
        return torch.channels_last
    return torch.contiguous_format


def lay_out(model, optimizer, memory_format) -> None:
    """Put ``model``'s weights in ``memory_format`` and AdamW's moments in
    their parameters' layout. ``Module.to`` keeps each ``Parameter``
    object, so ``optimizer`` stays valid; moments already there (a resumed
    run's loaded state) follow their parameters. :func:`_make_step` calls
    it once, when it builds a step, and lays that step's inputs out in the
    same format."""
    model.to(memory_format=memory_format)
    for p in model.parameters():
        state = optimizer.state.get(p, {})
        for key, value in state.items():
            if (torch.is_tensor(value) and value.shape == p.shape
                    and value.stride() != p.stride()):
                state[key] = torch.empty_like(p, dtype=value.dtype).copy_(value)


def split_stack(stack: torch.Tensor, layout: dict,
                memory_format=torch.contiguous_format):
    """Split the NCHW stack into model inputs, dense in ``memory_format``,
    and float32 label planes ``(x_t1, x_t2, y_change, y_sem_t1,
    y_sem_t2)``."""
    n_s1, n_s2, n_img = layout["n_s1"], layout["n_s2"], layout["n_img"]
    s1_t1 = stack[:, :n_s1]
    s1_t2 = stack[:, n_s1:2 * n_s1]
    s2_t1 = stack[:, 2 * n_s1:2 * n_s1 + n_s2]
    s2_t2 = stack[:, 2 * n_s1 + n_s2:n_img]
    # labels in f32: loss reductions must not accumulate in bf16
    y_sem_t1 = stack[:, n_img:n_img + 1].float()
    y_sem_t2 = stack[:, n_img + 1:n_img + 2].float()
    y_change = stack[:, n_img + 2:n_img + 3].float()

    mode = layout["input_mode"]
    if mode == "s1":
        x_t1, x_t2 = s1_t1, s1_t2
    elif mode == "s2":
        x_t1, x_t2 = s2_t1, s2_t2
    else:
        x_t1 = torch.cat([s1_t1, s2_t1], dim=1)
        x_t2 = torch.cat([s1_t2, s2_t2], dim=1)
    return (x_t1.contiguous(memory_format=memory_format),
            x_t2.contiguous(memory_format=memory_format), y_change, y_sem_t1,
            y_sem_t2)


def autocast(dtype: torch.dtype, device: torch.device):
    """bf16 autocast on the card when ``dtype`` is bf16, else nothing."""
    if device.type == "cuda" and dtype == torch.bfloat16:
        return torch.autocast("cuda", dtype=torch.bfloat16)
    return contextlib.nullcontext()


def augment_generator(seed: int, step: int, device: torch.device) -> torch.Generator:
    """The generator of one step's augmentation draws and then its dropout
    masks, a function of (seed, step) alone — like the JAX package's
    ``fold_in(rng, step)``, so a resumed run draws what the unbroken run
    would have."""
    state = np.random.SeedSequence([seed, step]).generate_state(2, np.uint32)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(state[0]) << 32 | int(state[1]))
    return gen


def augment_decisions(cfg, layout: dict, n: int, dtype: torch.dtype,
                      generator: torch.Generator, device) -> dict:
    """The config's per-sample augmentation decisions for a batch of ``n``,
    drawn from ``generator`` on ``device``
    (:func:`..data.augmentations.draw_augmentation`)."""
    a = cfg.AUGMENTATION
    return draw_augmentation(
        n, layout["n_img"], flip=bool(a.RANDOM_FLIP),
        rotate=bool(a.RANDOM_ROTATE), color_shift=bool(a.COLOR_SHIFT),
        gamma=bool(a.GAMMA_CORRECTION), generator=generator, dtype=dtype,
        device=device)


def _augmented(stack: torch.Tensor, layout: dict, dtype: torch.dtype,
               decisions: dict, rows: np.ndarray | None = None) -> torch.Tensor:
    """``stack`` cast to ``dtype`` with ``decisions`` applied; ``rows``: the
    decisions are the global batch's and ``stack`` holds these rows of it."""
    stack = stack.to(dtype)
    if rows is not None:
        index = torch.as_tensor(rows, device=stack.device)
        decisions = {k: None if v is None else v[index]
                     for k, v in decisions.items()}
    return apply_augmentation(stack, n_img_channels=layout["n_img"],
                              **decisions)


def augment(stack: torch.Tensor, cfg, layout: dict, dtype: torch.dtype,
            generator: torch.Generator, rows: np.ndarray | None = None,
            total: int | None = None) -> torch.Tensor:
    """Cast the wire to ``dtype`` and apply the config's per-sample device
    augmentation (flips and rotations exact in any dtype; labels {0, 1}
    exact in bf16). ``rows``: ``stack`` holds these rows of a global batch
    of ``total`` (one data column's share, :func:`..parallel.batch_rows`);
    the decisions are drawn for the global batch and each row takes its
    own."""
    n = stack.shape[0] if rows is None else total
    decisions = augment_decisions(cfg, layout, n, dtype, generator, stack.device)
    return _augmented(stack, layout, dtype, decisions, rows)


def _make_step(model, optimizer, cfg, losses_of, memory_format=None):
    """One optimizer step around ``losses_of(outputs, is_labeled, y_change,
    y_sem_t1, y_sem_t2) -> {"loss": ..., ...}`` (fp32 scalars; ``loss`` is
    the one differentiated).

    Returns ``step(stack, is_labeled, global_step) -> metrics``: ``stack``
    is the wire batch on the model's device, ``is_labeled`` its float32
    ``(B,)`` label mask there, ``global_step`` the number of steps taken
    before this one (with ``cfg.SEED`` it seeds the
    augmentation and, for a model with dropout, its masks). The step
    computes in the config's dtype on the card and
    in float32 on the CPU; the metrics are left on the device (no
    synchronisation). Its parts are ``step.draw(batch, global_step) ->
    (generator, decisions)``, the step's random decisions seeded on the
    host; ``step.grads(stack, is_labeled, decisions, dropout) -> metrics``,
    the augmentation, forward and backward, which :class:`StepGraph`
    captures; and ``step.update()``, AdamW.

    ``TRAINER.GRAD_ACCUM: a > 1`` (the JAX package's train_lib.py:229-304)
    splits the batch into ``a`` contiguous micro-batches (a size ``a`` does
    not divide raises ``ValueError``), each a forward and a backward of
    ``loss / a``, then one ``optimizer.step()`` on the averaged gradients.
    Each micro-batch's BatchNorm normalises over that micro-batch, and the
    running statistics chain through the micro-batches in order. The
    augmentation is drawn once for the whole batch from the step's
    generator and then split; a model with dropout draws its masks from
    the same generator, micro-batch after micro-batch. (The JAX package
    folds the micro-batch index into its key instead: the randomness is
    each package's own, as the augmentation already is.) The metrics reduce
    over the micro-batches by :func:`_reduce_window_metrics`. With ``a =
    1`` the step is the plain one.

    A parameter the loss does not reach (the dual-task model's auxiliary
    head) gets a zero gradient before the update, as ``jax.value_and_grad``
    gives it in the JAX package: ``optax.adamw`` then still decays it by
    ``lr·wd`` every step, where ``torch.optim.AdamW`` would skip a parameter
    whose gradient is None.

    In a world of W > 1 ranks (:mod:`.parallel`) the step computes what the
    JAX package's GSPMD step computes on the global batch. ``stack`` holds
    this rank's rows of it (:func:`.parallel.batch_rows`: contiguous
    shares of each micro-batch); the augmentation and dropout decisions
    are drawn for the global batch and each rank keeps its rows. Each
    micro-batch's outputs, labels and label mask are made global (every
    rank fills its rows of zeroed global buffers, one all-reduce), with
    the rank's live outputs put back in its own rows, and the unchanged
    ``losses_of`` runs on the global batch: the ratio losses, the
    semi-supervised presence gates and the metrics are the global ones,
    equal on every rank. A rank's backward then gives its rows' share of
    the gradient; one flat all-reduce sums the shares (after the last
    micro-batch, zero gradients of unreached parameters included) before
    AdamW. BatchNorm is synchronised over the ranks (``MODEL.SYNC_BN``,
    default True); with ``SYNC_BN: False`` each rank normalises over its
    own rows and every rank then takes rank 0's running statistics, as the
    JAX package keeps group 0's (train_lib.py:151-181).

    ``TRAINER.SPATIAL_SHARDS n`` on a world the grid accepts
    (:func:`.parallel.space_shards`; the JAX package's 2-D mesh,
    train_lib.py:206-225) makes the world a ``(W / n, n)`` grid
    (:class:`.parallel.Grid`): ``stack`` holds the data column's rows at
    full crop height, the augmentation (whose rot90 mixes height and width)
    runs on the full crops, and then each space rank keeps its ``1/n`` of
    the height; the model runs height-sharded (:mod:`.parallel.halo`, in
    the forward and the backward), the global batch is made of (rows,
    height) blocks, the micro-batches split over the data axis alone, and
    the gradient all-reduce sums over the whole world. BatchNorm groups
    follow the data axis (the JAX package's ``bn_group_count``): without
    sync-BN a column's space ranks share its statistics.

    Building the step puts the model's weights and AdamW's moments in
    ``memory_format`` (:func:`lay_out`), by default the layout
    :func:`step_memory_format` gives for the device and the world; each
    step lays its inputs out in it too."""
    accum = int(cfg.TRAINER.get("GRAD_ACCUM", 1))
    layout = stack_layout(cfg)
    device = next(model.parameters()).device
    dtype = compute_dtype(cfg) if device.type == "cuda" else torch.float32
    world = group.world_size()
    grid = group.grid(group.space_shards(cfg))
    data, column, n_space = grid.data_size, grid.data_index, grid.space_size
    if memory_format is None:
        memory_format = step_memory_format(device, world, n_space)
    lay_out(model, optimizer, memory_format)
    bns = [m for m in model.modules() if isinstance(m, BatchNorm2d)]
    # the model's BatchNorms (the factory set them from MODEL.SYNC_BN) decide
    sync_bn = all(m.sync for m in bns)
    if data > 1 and not sync_bn and cfg.TRAINER.BATCH_SIZE % data:
        raise ValueError(
            f"MODEL.SYNC_BN: False needs TRAINER.BATCH_SIZE "
            f"({cfg.TRAINER.BATCH_SIZE}) divisible by the {data}-device mesh")
    bn_buffers = [b for m in bns for b in (m.running_mean, m.running_var)]

    # a model with dropout (siamunet_diff) draws its masks from the step's
    # generator, after the augmentation's draws
    draws_dropout = getattr(model, "draws_dropout", False)

    def draw(batch: int, global_step: int) -> tuple:
        """The step's random decisions: its generator, and from it the
        augmentation of the global batch of ``batch`` rows (a model with
        dropout then draws its masks from the same generator)."""
        generator = augment_generator(cfg.SEED, global_step, device)
        return generator, augment_decisions(cfg, layout, batch, dtype,
                                            generator, device)

    def grads(stack: torch.Tensor, is_labeled, decisions: dict, dropout) -> dict:
        """The step's augmentation, forward and backward on drawn decisions,
        leaving every parameter's gradient; ``dropout``: the generator (or
        :class:`.models.networks.DropoutDraws`) of the model's masks.
        Returns the metrics."""
        batch = stack.shape[0] * data
        rows = group.batch_rows(batch, accum, column, data)
        share = stack.shape[0] // accum        # the column's rows per micro-batch
        model.train()
        stack_aug = _augmented(stack, layout, dtype, decisions,
                               rows if data > 1 else None)
        height = stack_aug.shape[2] // n_space   # this space rank's crop rows
        stack_aug = stack_aug.narrow(2, grid.space_index * height, height)
        labs = [None] * accum if is_labeled is None else is_labeled.chunk(accum)
        optimizer.zero_grad(set_to_none=True)
        micro = []
        for part, lab in zip(stack_aug.chunk(accum), labs):
            x_t1, x_t2, *labels = split_stack(part, layout, memory_format)
            kwargs = {}
            if draws_dropout:
                kwargs["generator"] = dropout
                if data > 1:
                    kwargs["rows"] = (column * share, share * data)
            # REMAT's recompute runs the sharded stages again in the backward
            with halo.height_sharded(grid, height):
                with autocast(dtype, device):
                    outputs = model(x_t1, x_t2, **kwargs)
                if world > 1:
                    outputs, lab, labels = _global_batch(
                        outputs, lab, labels, column * share, share * data, grid)
                metrics = losses_of(outputs, lab, *labels)
                loss = metrics["loss"]
                (loss / accum if accum > 1 else loss).backward()
            micro.append({k: v.detach() for k, v in metrics.items()})
        for p in model.parameters():
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        return micro[0] if accum == 1 else _reduce_window_metrics(micro)

    def update() -> None:
        """The gradients summed over the ranks, AdamW, and without sync-BN
        rank 0's running statistics."""
        if world > 1:
            group.all_reduce_flat_([p.grad for p in model.parameters()])
        optimizer.step()
        if world > 1 and not sync_bn:
            group.broadcast_(bn_buffers, src=0)

    def step(stack: torch.Tensor, is_labeled, global_step: int) -> dict:
        generator, decisions = draw(stack.shape[0] * data, global_step)
        metrics = grads(stack, is_labeled, decisions, generator)
        update()
        return metrics

    step.draw, step.grads, step.update = draw, grads, update
    return step


def _global_batch(outputs, lab, labels, start: int, total: int, grid):
    """One micro-batch's ``(outputs, is_labeled, labels)`` over the global
    batch of ``total`` rows, of which this rank holds ``[start, start +
    k)`` (on a grid of several space shards, its height block of them):
    float32 global copies (:func:`.parallel.global_rows`, one all-reduce),
    the outputs with this rank's live block put back in, so the backward
    reaches it."""
    heads = outputs if isinstance(outputs, tuple) else (outputs,)
    live = [h.float() for h in heads]
    fixed = list(labels) + ([] if lab is None else [lab])
    full = group.global_rows(live + fixed, start, total, grid)

    def splice(g, h):
        end = start + h.shape[0]
        if grid.space_size > 1:
            h0 = grid.space_index * h.shape[2]
            h = torch.cat([g[start:end, :, :h0], h, g[start:end, :, h0 + h.shape[2]:]],
                          dim=2)
        return torch.cat([g[:start], h, g[end:]])

    spliced = tuple(splice(g, h) for g, h in zip(full, live))
    out = spliced if isinstance(outputs, tuple) else spliced[0]
    rest = full[len(live):]
    return out, (None if lab is None else rest[-1]), rest[:len(labels)]


def _reduce_window_metrics(metrics: list) -> dict:
    """Reduce per-micro-batch metric dicts to one (the JAX package's
    train_lib.py:307-341). The semi-supervised component losses are means
    over the entries where their partition was present, weighted by each
    entry's count of batches that had it (``n_lab_steps`` /
    ``n_notlab_steps``, else 0/1 presence); ``n_labeled`` and
    ``n_notlabeled`` are sums, and the weights come back summed as
    ``n_lab_steps`` / ``n_notlab_steps``, so a log window weighs an
    accumulated step as the batches it holds. Every other key is a mean."""
    stacked = {k: torch.stack([m[k] for m in metrics]) for k in metrics[0]}
    if "n_labeled" not in stacked:
        return {k: v.mean() for k, v in stacked.items()}
    w_lab = stacked.get("n_lab_steps", (stacked["n_labeled"] > 0).float())
    w_unl = stacked.get("n_notlab_steps", (stacked["n_notlabeled"] > 0).float())

    def wmean(key, w):
        return (stacked[key] * w).sum() / w.sum().clamp_min(1.0)

    return {
        "loss": stacked["loss"].mean(),
        "sup_loss": wmean("sup_loss", w_lab),
        "cons_loss": wmean("cons_loss", w_unl),
        "fusion_loss": wmean("fusion_loss", w_lab),
        "stream1_loss": wmean("stream1_loss", w_lab),
        "stream2_loss": wmean("stream2_loss", w_lab),
        "n_labeled": stacked["n_labeled"].sum(),
        "n_notlabeled": stacked["n_notlabeled"].sum(),
        "n_lab_steps": w_lab.sum(),
        "n_notlab_steps": w_unl.sum(),
    }


def _layout(memory_format) -> tuple:
    """:func:`_make_step`'s optional last argument: ``(memory_format,)``, or
    nothing for :func:`step_memory_format`'s layout (a stand-in for
    ``_make_step`` may then take its first four arguments alone)."""
    return () if memory_format is None else (memory_format,)


def make_supervised_train_step(model, optimizer, cfg, memory_format=None):
    """Supervised change-detection step (reference train_supervised.py:63-77;
    the JAX package's ``make_supervised_train_step``):
    ``loss = criterion(logits, y_change)``. Metrics ``{"loss"}``; see
    :func:`_make_step` for the step's contract."""
    criterion = losses.get_criterion(cfg.MODEL.LOSS_TYPE)

    def losses_of(logits, is_labeled, y_change, y_sem_t1, y_sem_t2) -> dict:
        return {"loss": criterion(logits.float(), y_change)}

    return _make_step(model, optimizer, cfg, losses_of, *_layout(memory_format))


def make_dualtask_train_step(model, optimizer, cfg, memory_format=None):
    """Dual-task step (the JAX package's ``make_dualtask_train_step``, the
    intended semantics of the reference's train_supervised_dualtask.py:
    64-92): ``loss = (change_loss + (sem_t1_loss + sem_t2_loss) / 2) / 2``.
    Metrics ``{"loss", "change_loss", "sem_loss"}``; see :func:`_make_step`
    for the step's contract."""
    criterion = losses.get_criterion(cfg.MODEL.LOSS_TYPE)

    def losses_of(outputs, is_labeled, y_change, y_sem_t1, y_sem_t2) -> dict:
        logits_change, logits_sem_t1, logits_sem_t2 = (o.float() for o in outputs)
        change_loss = criterion(logits_change, y_change)
        sem_loss = (criterion(logits_sem_t1, y_sem_t1)
                    + criterion(logits_sem_t2, y_sem_t2)) / 2.0
        return {"loss": (change_loss + sem_loss) / 2.0,
                "change_loss": change_loss, "sem_loss": sem_loss}

    return _make_step(model, optimizer, cfg, losses_of, *_layout(memory_format))


def make_semisupervised_train_step(model, optimizer, cfg, memory_format=None):
    """Cross-modal consistency step (reference train_semisupervised.py:
    66-118; the JAX package's ``make_semisupervised_train_step``), for a
    three-head model: ``whatevernet``, ``whatevernet2``, or
    ``dtsiameseunet`` with its change head as the fusion and its semantic
    heads as the consistency pair.

    ``sup = α·(fusion + stream1 + stream2)/3``, each term over the labeled
    rows; ``cons = (1 - α)·consistency`` over the unlabeled rows, between
    the two streams' probabilities for 'L2', else between stream 1's logits
    and stream 2's probabilities (differentiated through both, as the JAX
    package does); ``loss = has_lab·sup + has_unlab·cons``, where the
    presence flags are maxima on the device, so the step never waits for
    the host. Metrics: ``loss``, ``sup_loss``, ``cons_loss``,
    ``fusion_loss``, ``stream1_loss``, ``stream2_loss`` (each 0 when its
    partition is absent), ``n_labeled``, ``n_notlabeled``; see
    :func:`_make_step` for the step's contract."""
    if cfg.MODEL.TYPE not in ("whatevernet", "whatevernet2", "dtsiameseunet"):
        raise ValueError(
            f"semisupervised training needs a 3-head model "
            f"(whatevernet/whatevernet2/dtsiameseunet), got "
            f"MODEL.TYPE={cfg.MODEL.TYPE!r}")
    sup_criterion = losses.get_criterion(cfg.MODEL.LOSS_TYPE)
    cons_criterion = losses.get_criterion(cfg.CONSISTENCY_TRAINER.LOSS_TYPE)
    cons_is_l2 = cfg.CONSISTENCY_TRAINER.LOSS_TYPE == "L2"
    alpha = float(cfg.CONSISTENCY_TRAINER.LOSS_FACTOR)

    def losses_of(outputs, is_labeled, y_change, y_sem_t1, y_sem_t2) -> dict:
        logits_fusion, logits_s1, logits_s2 = (o.float() for o in outputs)
        lab = is_labeled.to(device=logits_fusion.device, dtype=torch.float32)
        unlab = 1.0 - lab
        has_lab, has_unlab = lab.max(), unlab.max()
        probs_s2 = torch.sigmoid(logits_s2)

        fusion_loss = sup_criterion(logits_fusion, y_change, mask=lab)
        stream1_loss = sup_criterion(logits_s1, y_change, mask=lab)
        stream2_loss = sup_criterion(logits_s2, y_change, mask=lab)
        sup_loss = alpha * (fusion_loss + stream1_loss + stream2_loss) / 3.0
        first = torch.sigmoid(logits_s1) if cons_is_l2 else logits_s1
        cons_loss = (1.0 - alpha) * cons_criterion(first, probs_s2, mask=unlab)
        return {
            "loss": has_lab * sup_loss + has_unlab * cons_loss,
            "sup_loss": has_lab * sup_loss,
            "cons_loss": has_unlab * cons_loss,
            "fusion_loss": has_lab * fusion_loss,
            "stream1_loss": has_lab * stream1_loss,
            "stream2_loss": has_lab * stream2_loss,
            "n_labeled": lab.sum(),
            "n_notlabeled": unlab.sum(),
        }

    return _make_step(model, optimizer, cfg, losses_of, *_layout(memory_format))


_STEPS = {"supervised": make_supervised_train_step,
          "semisupervised": make_semisupervised_train_step,
          "dualtask": make_dualtask_train_step}


def make_train_step(model, optimizer, cfg, regime: str, memory_format=None):
    """The step of ``regime``: 'supervised', 'semisupervised' or
    'dualtask', in ``memory_format`` (default: :func:`step_memory_format`'s
    rule; a one-process reference of a world of several ranks gives that
    world's layout, :mod:`.parallel.cluster_check`)."""
    if regime not in _STEPS:
        raise ValueError(f"unknown training regime {regime!r}; "
                         f"known: {sorted(_STEPS)}")
    return _STEPS[regime](model, optimizer, cfg, memory_format)


# --------------------------------------------------------------------------
# Multi-step execution (TRAINER.STEPS_PER_EXECUTION)
# --------------------------------------------------------------------------

class StepGraph:
    """The augmentation, forward and backward of one train step captured as
    a CUDA graph, replayed once per step and followed by the step's AdamW
    update, run eagerly (the card's counterpart of the JAX package's
    ``lax.scan`` over steps).

    The static inputs are the wire batch, its label mask, the augmentation
    decisions and the dropout uniforms (:class:`.models.networks.
    DropoutDraws`). The graph holds the augmentation, forward and backward,
    and the gradients: they are set to None before the capture, so the
    backward writes them in the graph's memory, and the zero gradient of an
    unreached parameter is a captured fill. Before each replay the step's
    decisions are drawn on the host-seeded generator of ``(cfg.SEED,
    global_step)`` exactly as the eager step draws them (the
    augmentation's, then the dropout's) and copied in; after it the metric
    scalars are cloned out and AdamW runs as in the eager step (not
    capturable, its step counters on the host), so a replayed step's
    numbers equal the eager step's bit for bit and checkpoints are the
    same whatever the grouping.

    The first call runs its steps eagerly, on a side stream, as the real
    steps (torch's warm-up before a capture; the last of them records its
    dropout draws), then captures; every later call replays. Every static
    input is made before the capture: one made during it would share memory
    with the graph's temporaries. After the capture nothing may replace a
    parameter or buffer; the batch shape is fixed (the loader drops the
    last partial batch). A capture or replay that fails raises."""

    def __init__(self, step, device: torch.device):
        self.step, self.device = step, device
        self.graph = None
        self.capture_s = None      # host seconds the capture took

    def __call__(self, stacks: torch.Tensor, labs: list, global_step: int) -> list:
        """Steps ``global_step + i`` on ``stacks[i]``, ``labs[i]``; returns
        each step's metrics."""
        if self.graph is None:
            return self._warm_up_and_capture(stacks, labs, global_step)
        out = []
        for i in range(len(stacks)):
            # the step's draws and its inputs copied into the static ones
            with tracing.span("step.prepare"):
                generator, decisions = self.step.draw(stacks.shape[1], global_step + i)
                for key, value in decisions.items():
                    if value is not None:
                        self.decisions[key].copy_(value)
                self.dropout.refill(generator)
                self.stack.copy_(stacks[i])
                if labs[i] is not None:
                    self.lab.copy_(labs[i])
            self.graph.replay()
            # the metrics cloned out of the graph's memory, then AdamW
            with tracing.span("step.update"):
                out.append({k: v.clone() for k, v in self.metrics.items()})
                self.step.update()
        return out

    def _warm_up_and_capture(self, stacks, labs, global_step) -> list:
        k = len(stacks)
        current = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(current)
        self.dropout = DropoutDraws()
        with torch.cuda.stream(side):
            out = [self.step(stacks[i], labs[i], global_step + i)
                   for i in range(k - 1)]
            # the last one keeps its dropout draws: their shapes and order
            generator, decisions = self.step.draw(stacks.shape[1], global_step + k - 1)
            self.dropout.record(generator)
            out.append(self.step.grads(stacks[k - 1], labs[k - 1], decisions,
                                       self.dropout))
            self.step.update()
        current.wait_stream(side)
        # static inputs, all made outside the graph's memory pool
        self.dropout.rewind()
        self.stack = torch.empty_like(stacks[0])
        self.lab = None if labs[0] is None else torch.empty_like(labs[0])
        self.decisions = {key: None if v is None else torch.empty_like(v)
                          for key, v in decisions.items()}
        graph = torch.cuda.CUDAGraph()
        t0 = time.perf_counter()
        # thread_local: the loader's staging thread keeps copying meanwhile
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            self.metrics = self.step.grads(self.stack, self.lab, self.decisions,
                                           self.dropout)
        self.capture_s = time.perf_counter() - t0
        self.graph = graph
        return out


def make_scanned_train_step(model, optimizer, cfg, regime: str):
    """k optimizer steps per call (``TRAINER.STEPS_PER_EXECUTION``; the JAX
    package's ``make_scanned_train_step``, train_lib.py:489-522).

    Returns ``window(stacks, is_labeled, global_step) -> metrics``:
    ``stacks`` is a ``(k, B, C, S, S)`` super-batch on the model's device
    (:func:`.data.loader.group_batches`), ``is_labeled`` its ``(k, B)``
    label masks or None; step ``i`` is :func:`make_train_step`'s at global
    step ``global_step + i``, with the same draws. The metrics are reduced
    over the window by :func:`_reduce_window_metrics` (semi-supervised: the
    presence weights ``n_lab_steps`` / ``n_notlab_steps`` summed).
    ``TRAINER.GRAD_ACCUM`` and ``MODEL.REMAT`` compose as in the step.

    ``window.mode`` says how the steps run: ``'graph'`` on the card in a
    world of one rank (one :class:`StepGraph`, ``window.graph``), else
    ``'eager'``, the k steps in turn (the CPU, and a world of several
    ranks, whose collectives are not captured)."""
    step = make_train_step(model, optimizer, cfg, regime)
    device = next(model.parameters()).device
    graph = None
    if device.type == "cuda" and group.world_size() == 1:
        graph = StepGraph(step, device)

    def window(stacks: torch.Tensor, is_labeled, global_step: int) -> dict:
        tracing.follow_profiler()
        with tracing.span("train.window", global_step):
            labs = [None] * len(stacks) if is_labeled is None else list(is_labeled)
            if graph is not None:
                return _reduce_window_metrics(graph(stacks, labs, global_step))
            return _reduce_window_metrics([step(stacks[i], labs[i], global_step + i)
                                           for i in range(len(stacks))])

    window.mode = "eager" if graph is None else "graph"
    window.graph = graph
    return window


# --------------------------------------------------------------------------
# Eval forward
# --------------------------------------------------------------------------

def eval_forward(model, x_t1: torch.Tensor, x_t2: torch.Tensor) -> torch.Tensor:
    """Eval-mode change probabilities ``(B, 1, H, W)`` float32 for NCHW
    inputs: sigmoid of the change head, the first output of a multi-head
    model (the JAX package's ``eval_forward``, train_lib.py:529-537;
    reference evaluation.py:22). Puts ``model`` in
    eval mode and runs :func:`probabilities` under
    ``torch.inference_mode()``."""
    model.eval()
    with torch.inference_mode():
        return probabilities(model, x_t1, x_t2)


def probabilities(model, x_t1: torch.Tensor, x_t2: torch.Tensor) -> torch.Tensor:
    """The arithmetic of :func:`eval_forward` for a model already in eval
    mode, with no grad mode of its own (the serving export traces it). On
    the card the forward runs under bf16 autocast when the model's compute
    dtype is bf16 (``TRAINER.PRECISION``, default bf16) and in fp32
    otherwise; on the CPU it runs in fp32. An fp32 run on the card follows
    ``torch.backends.cudnn.allow_tf32`` for its convolutions."""
    dtype = getattr(model, "compute_dtype", torch.float32)
    with autocast(dtype, x_t1.device):
        out = model(x_t1, x_t2)
        if isinstance(out, tuple):
            out = out[0]
        return torch.sigmoid(out.float())
