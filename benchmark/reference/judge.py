"""The numbers that decide ``correct``, each from the program's readings and
the reference's, and the check of each against its limit."""

from __future__ import annotations

import contextlib

import numpy as np
import torch


@contextlib.contextmanager
def float32_exact():
    """float32 matrix products and convolutions without TF32."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def norms(tensors: dict) -> dict:
    return {k: float(v.double().norm()) for k, v in tensors.items()}


def leaf_gaps(program: dict, reference: dict, leaves: list) -> dict:
    """Per leaf, the gap between the program's norm and the reference's,
    over the larger of the reference's norm of that leaf and of the median
    leaf."""
    median = float(np.median([reference[k] for k in leaves]))
    return {k: abs(program[k] - reference[k]) / max(reference[k], median, 1e-30)
            for k in leaves}


def stats_change(net: torch.nn.Module, start: dict) -> dict:
    """BatchNorm's running means in ``net`` less those of ``start``, per
    layer, in float64 on the host. (Not the running variances: the port
    updates them with the biased batch variance, as flax does, where the
    published ``nn.BatchNorm2d`` takes the unbiased one.)"""
    return {n: (b.detach().double() - start[n].to(b.device).double()).cpu()
            for n, b in net.named_buffers() if n.endswith("running_mean")}


def stats_gaps(program: dict, reference: dict) -> dict:
    """Per layer, the norm of the program's change of its running mean less
    the reference's, over the larger of the norm of the reference's change
    and of the median layer's."""
    ref = {k: float(v.norm()) for k, v in reference.items()}
    median = float(np.median(list(ref.values())))
    return {k: float((program[k] - reference[k]).norm()) / max(ref[k], median, 1e-30)
            for k in reference}


def worst_leaf(program: dict, reference: dict, leaves: list) -> float:
    return max(leaf_gaps(program, reference, leaves).values(), default=0.0)


def moved_leaves(steps: list) -> dict:
    """The leaves whose reference gradient counts: at least a thousandth of
    the median leaf's, the median taken in the step where it is largest
    (``steps``: per-leaf norms of each step). The others (a convolution's
    bias before BatchNorm; every leaf in a step whose loss has no gradient
    but round-off, as one whose labeled rows show no change) move under
    AdamW by round-off alone. ``first``: those of the first step; ``any``:
    those of any step."""
    medians = [float(np.median(live)) for live in
               ([g for g in n.values() if g > 0] for n in steps) if live]
    floor = 1e-3 * max(medians, default=0.0)
    first = [k for k, g in steps[0].items() if g >= floor and g > 0]
    return {"first": first,
            "any": [k for k in steps[0] if max(n[k] for n in steps) >= floor
                    and max(n[k] for n in steps) > 0]}


def train_numbers(program: dict, reference: dict, moved: dict) -> dict:
    """``program``: the change of BatchNorm's running means in the first
    step, step losses, the first gradient's norms and the norms of the
    change after the steps, per leaf; ``reference``: the same. ``moved``:
    the leaves of the first step (``first``) and of any step (``any``),
    :func:`moved_leaves`. ``stats_gap`` is the worst layer's
    :func:`stats_gaps`: the first step's forward alone, from the same
    weights and batch, where the precision shows and AdamW's steps do not
    yet."""
    losses = [abs(p - r) / max(abs(r), 1e-30)
              for p, r in zip(program["loss"], reference["loss"])]
    change = leaf_gaps(program["change"], reference["change"], moved["any"])
    return {
        "stats_gap": max(stats_gaps(program["stats"], reference["stats"]).values()),
        "loss_gap": max(losses),
        "grad_gap": worst_leaf(program["grad"], reference["grad"], moved["first"]),
        "change_gap": max(change.values(), default=0.0),
    }


def worst_leaves(program: dict, reference: dict, moved: dict, n: int = 3) -> dict:
    """The ``n`` worst moved leaves of the gradient and of the change, with
    their gaps (a diagnosis, not compared)."""
    out = {}
    for key, leaves in (("grad", moved["first"]), ("change", moved["any"])):
        gaps = leaf_gaps(program[key], reference[key], leaves)
        out[key] = sorted(gaps.items(), key=lambda kv: -kv[1])[:n]
    return out


def check(numbers: dict, limits: dict) -> list:
    """``[(name, value, limit, ok)]`` for every number that has a limit."""
    return [(k, float(numbers[k]), float(limits[k]), float(numbers[k]) <= float(limits[k]))
            for k in limits]
