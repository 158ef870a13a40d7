"""Full-scene inference throughput, the forward alone (the JAX package's
``tools/bench_eval.py``).

    python -m multimodal_siamese_cd_tpu_torch.bench_eval [--sol] [KEY VALUE ...]

Times ``train_lib.eval_forward`` of ``siameseunet`` (the base config: full
width, bf16) on a ``(group, 6, S, S)`` NCHW pair of uniform scenes, S 1024
by default, the shape class real SpaceNet7 AOIs pad to, in the scene groups
``evaluation.run_measurer`` forms (``evaluation.eval_group_limit``: 16 at
1024^2). A warm call first, then ``--calls`` calls back to back closed by
one ``torch.cuda.synchronize()``. Prints scenes/s and the rate in 256^2
patch equivalents (a 1024^2 scene is 16 patches), the peak device memory,
and one JSON line naming the card. ``--sol`` adds the forward's
floating-point operations (:func:`model_flops`) and the effective TFLOP/s,
beside the share of the card's dense bf16 peak.

``--device cpu`` runs it on the CPU, for the tests; without it the module
needs the card and raises where there is none.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch
from torch import nn

from . import evaluation, train_lib
from .bench import SEED
from .config import load_cfg
from .device import describe, resolve_device
from .models.factory import create_network
from .trainers import sync

# dense bf16 tensor-core peak of an H100 SXM at its 700 W limit (NVIDIA's
# data sheet), the yardstick of --sol's share
H100_BF16_PEAK_FLOPS = 989e12


def model_flops(model, x1: torch.Tensor, x2: torch.Tensor) -> int:
    """Floating-point operations of one forward of ``model`` on ``(x1,
    x2)``, counted by forward hooks on every convolution during one call:
    ``2 · Cin/groups · Cout · kh · kw · B · Hout · Wout`` per
    ``nn.Conv2d`` (each output pixel meets every tap once), and ``2 ·
    Cin · Cout/groups · kh · kw · B · Hin · Win`` per
    ``nn.ConvTranspose2d`` (each input pixel meets every tap once; the
    U-Net's stride-2 2x2 upsample writes each output pixel from one tap).
    Convolutions only: BatchNorm, activations, pooling and the other
    elementwise work are not counted (XLA's ``cost_analysis``, which the
    JAX tool reads, counts them too)."""
    total = []

    def conv(module, inputs, out):
        kh, kw = module.kernel_size
        b, _, h, w = out.shape
        total.append(2 * module.in_channels // module.groups * module.out_channels
                     * kh * kw * b * h * w)

    def transposed(module, inputs, out):
        kh, kw = module.kernel_size
        b, _, h, w = inputs[0].shape
        total.append(2 * module.in_channels * module.out_channels // module.groups
                     * kh * kw * b * h * w)

    hooks = [m.register_forward_hook(transposed if isinstance(m, nn.ConvTranspose2d)
                                     else conv)
             for m in model.modules() if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d))]
    try:
        train_lib.eval_forward(model, x1, x2)
    finally:
        for h in hooks:
            h.remove()
    return sum(total)


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--scene", type=int, default=1024)
    p.add_argument("--group", type=int, default=None,
                   help="scenes per forward (default: the shipped adaptive "
                        "policy, evaluation.eval_group_limit)")
    p.add_argument("--calls", type=int, default=8)
    p.add_argument("--sol", action="store_true",
                   help="also print the forward's FLOPs (convolutions) and "
                        "the effective TFLOP/s at the measured rate")
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
    device = resolve_device(args.device)
    info = describe(device)
    group = args.group or evaluation.eval_group_limit((args.scene, args.scene))

    cfg = load_cfg("base")
    cfg.MODEL.TYPE = "siameseunet"
    cfg.merge_from_list(args.opts)
    model = create_network(cfg, device=device,
                           generator=torch.Generator().manual_seed(SEED))

    rng = np.random.default_rng(0)
    shape = (group, 6, args.scene, args.scene)
    x1 = torch.from_numpy(rng.uniform(0, 1, shape).astype(np.float32)).to(device)
    x2 = torch.from_numpy(rng.uniform(0, 1, shape).astype(np.float32)).to(device)

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    probs = train_lib.eval_forward(model, x1, x2)    # warm: cuDNN's choices
    sync(device)
    t0 = time.perf_counter()
    for _ in range(args.calls):
        probs = train_lib.eval_forward(model, x1, x2)
    sync(device)
    dt = time.perf_counter() - t0
    if probs.shape != (group, 1, args.scene, args.scene):
        raise AssertionError(f"probabilities of shape {tuple(probs.shape)}")

    n = args.calls * group
    sc_s = n / dt
    patch_eq = sc_s * (args.scene / 256) ** 2
    peak = ("not measured" if device.type != "cuda"
            else torch.cuda.max_memory_allocated(device) / 2**30)
    print(f"eval {args.scene}^2 scenes: {sc_s:.2f} scenes/s/chip "
          f"({dt / n * 1e3:.1f} ms/scene, {patch_eq:.0f} patch-equiv/s, "
          f"group={group}) on {info['name']} ({info['power_limit']})")
    line = {"metric": "eval_scenes_per_sec", "value": sc_s, "unit": "scenes/s/chip",
            "scene": args.scene, "group": group, "calls": args.calls,
            "ms_per_scene": dt / n * 1e3, "patch_equiv_per_sec": patch_eq,
            "peak_gib": peak, "device": info}
    if args.sol:
        flops = model_flops(model, x1, x2)
        eff = flops * args.calls / dt
        line.update(tflop_per_group=flops / 1e12, gflop_per_scene=flops / group / 1e9,
                    effective_tflops=eff / 1e12)
        print(f"convolution FLOPs: {flops / 1e12:.3f} TFLOP/group "
              f"({flops / group / 1e9:.1f} GFLOP/scene) -> {eff / 1e12:.1f} "
              f"effective TFLOP/s at the measured rate")
        if device.type == "cuda":
            line["bf16_peak_share"] = eff / H100_BF16_PEAK_FLOPS
            print(f"  {eff / H100_BF16_PEAK_FLOPS * 100:.1f}% of the H100's "
                  f"{H100_BF16_PEAK_FLOPS / 1e12:.0f} TFLOP/s dense bf16 peak "
                  f"(the 700 W part; this card: {info['name']}, "
                  f"{info['power_limit']})")
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
