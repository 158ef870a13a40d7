"""Entry points of the port (the repository's ``__graft_entry__.py``):
the single-card check of the flagship forward, and the dry run of every
production surface over a world of ranks.

    python -m multimodal_siamese_cd_tpu_torch.graft_entry [N] [--surfaces smoke] [--device cpu]

:func:`entry` returns ``(fn, example_args)``: the eval-mode change
probabilities of the flagship siameseunet [64,128,256,512] (``base``
config, 256² crops, batch 8) on a bitemporal s1s2 batch drawn as the JAX
entry draws it.

:func:`dryrun_multichip` starts one world of ``n_ranks`` processes
(:func:`.parallel.cluster_check.launch_cluster`, one ``dryrun`` case that
runs every surface in turn, each rank feeding its rows). The ranks join
through :func:`.parallel.distributed.maybe_initialize_distributed`'s
environment (``env://``: ``MSCD_DISTRIBUTED=1``, ``MASTER_ADDR``,
``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``, as ``torchrun``
sets them). A world whose store could not bind its port (another process
took it between its choice and the bind) is tried once more; any other
failure raises at once. Each surface is held against the same work in this
process (the JAX dry run's checks, ``__graft_entry__.py:44-350``), with
one ``dryrun surface OK: <surface> — <detail>`` line per surface that
passes and the closing ``dryrun_multichip OK`` line. The surfaces, in the
JAX order:

  1-3. each regime's step (supervised siameseunet, dualtask dtsiameseunet,
       semisupervised whatevernet): the loss within ``LOSS_LIMITS`` and the
       BatchNorm running statistics within ``STATS_LIMITS`` of the
       one-process step on the same global batch;
  4.   the production-precision step (bf16; ``MODEL.PACKED_FULLRES`` is a
       declared no-op of the port): the loss finite and equal on every rank
       (on the CPU the port computes in float32 whatever the precision);
  5.   a scanned window of K = 2 steps (``make_scanned_train_step``, eager
       in a world of ranks): the window's loss and running statistics held
       as above against the same two steps at K = 1 in one process;
  6.   the same with ``MODEL.SYNC_BN: False``, held against the world's own
       two K = 1 steps (per-replica statistics differ from one process by
       design); and the control of the limits: the same window's running
       statistics must lie beyond ``STATS_LIMITS`` of one process's
       (whole-batch statistics), so that a world whose sync-BN all-reduce
       were dropped fails surfaces 1-3, 5 and 10-12 (its loss gap is
       reported: at these sizes the loss barely sees the statistics);
  7.   bucketed full-scene evaluation of 3 scenes in 2 shape buckets
       (``run_measurer`` over an item list, which every rank evaluates
       whole): counts and F1 equal to one process;
  8.   height-sharded scene inference (``sharded_scene_probabilities`` over
       the n ranks, float32, TF32 off): within ``SCENE_LIMIT`` of
       ``scene_probabilities``, equal on every rank;
  9.   the fused wire evaluation of the fixture's validation split with its
       scene groups sharded over the ranks (zero-valid padding): counts
       equal to one process;
  10.  height-sharded training on a ``(data 2, space n/2)`` grid
       (``TRAINER.SPATIAL_SHARDS``): the loss within ``LOSS_LIMITS`` of the
       one-process step;
  11.  ``MODEL.REMAT`` with ``TRAINER.GRAD_ACCUM 2`` on that grid: the same;
  12.  the JAX cluster check's work in that ``env://`` world (the JAX
       dry run starts a cluster of its own for it; every surface of the
       port's is already one): one supervised step at batch n and the
       wire evaluation, the loss within ``LOSS_LIMITS`` and the counts and
       F1 equal to one process.

Surfaces 10-12 run where ``n_ranks`` is even and at least 4, as in the JAX
dry run; ``surfaces="smoke"`` stops after the first six. Shapes: the JAX
dry run's own (crop 32, batch 2·n, float32 but in surface 4) on a fixture
dataset generated from a seed; topology [8, 16] on the CPU, the flagship's
[64,128,256,512] on the card. On the card the ranks take one card each
over NCCL when there are ``n_ranks`` cards, else they share it over gloo;
``device="cpu"`` runs gloo on the CPU. Any failure raises (the closing line
is not printed) and the module's process exits non-zero.
"""

from __future__ import annotations

import argparse
import math
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from . import train_lib
from .bench import REGIME_MODELS
from .config import load_cfg
from .data.synthetic import fixture_cfg_overrides, generate_fixture_dataset
from .device import resolve_device
from .models.factory import create_network
from .parallel import cluster_check

FLAGSHIP_TOPOLOGY = [64, 128, 256, 512]
# the dry run's crop and scanned K (the JAX dry run's, __graft_entry__.py:
# 117-172); its topology on the CPU (the card runs the flagship's)
DRYRUN_CROP, DRYRUN_K = 32, 2
CPU_TOPOLOGY = [8, 16]
# the largest relative differences of a world's step from the one-process
# step, of the loss and of the BatchNorm running statistics (L2 over all of
# them): float32 on the CPU; on the card, where the convolutions run in
# TF32 and the batch splits differently, each between the sound worlds'
# readings and surface 6's control (a world with per-replica statistics
# against one process). Two steps (a window) drift further than one, as
# AdamW's first update amplifies the rounding. PERF.md gives the readings
LOSS_LIMITS = {"cpu": 1e-6, "cuda": 1e-4}
STATS_LIMITS = {"cpu": 1e-4, "cuda": 5e-3}
# sharded scene probabilities against scene_probabilities (float32, TF32 off)
SCENE_LIMIT = 1e-5
# the whole launch of each world, one deadline
LAUNCH_TIMEOUT = 900
COUNT_KEYS = ("TP", "TN", "FP", "FN")


def entry(device=None):
    """``(fn, (model, x_t1, x_t2))``: the flagship siameseunet
    [64,128,256,512] (``base`` config, weights drawn from seed 0) and two
    s1s2 batches drawn as ``np.random.default_rng(0).uniform(0, 1, (8, 256,
    256, 6))`` twice, laid out NCHW in float32 on ``device`` (default: the
    card). ``fn(model_or_state, x_t1, x_t2)`` puts the model (or the
    flagship with the state dict loaded) in eval mode and returns
    :func:`.train_lib.probabilities`, ``(8, 1, 256, 256)`` float32."""
    device = resolve_device(device)
    cfg = load_cfg("base")      # topology [64,128,256,512], 256² crops, batch 8
    cfg.MODEL.TYPE = "siameseunet"
    model = create_network(cfg, device=device, generator=torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    x1, x2 = (torch.from_numpy(rng.uniform(0, 1, (8, 256, 256, 6)).astype(np.float32))
              .permute(0, 3, 1, 2).contiguous().to(device) for _ in range(2))

    def fn(model_or_state, x_t1: torch.Tensor, x_t2: torch.Tensor) -> torch.Tensor:
        net = model_or_state
        if isinstance(model_or_state, dict):
            model.load_state_dict(model_or_state, strict=True)
            net = model
        net.eval()
        with torch.inference_mode():
            return train_lib.probabilities(net, x_t1, x_t2)

    return fn, (model, x1, x2)


def _ok(surface: str, detail: str) -> None:
    print(f"dryrun surface OK: {surface} — {detail}", flush=True)


def _rel(got: float, want: float) -> float:
    return abs(got - want) / max(abs(want), 1e-12)


def _stats_gap(got: dict, want: dict) -> float:
    """The L2 norm of ``got - want`` over that of ``want``, over the
    BatchNorm running statistics of two buffer dicts."""
    keys = [k for k in want if "running" in k]
    diff = sum(float((got[k].double() - want[k].double()).square().sum()) for k in keys)
    norm = sum(float(want[k].double().square().sum()) for k in keys)
    return (diff / max(norm, 1e-300)) ** 0.5


class _Plan:
    """The dry run's cases, in the JAX order and with the JAX dry run's
    numpy draws (``np.random.default_rng(0)``, draw for draw), and the
    checks that hold the world's results against this process's."""

    def __init__(self, n: int, device: torch.device):
        self.n, self.device = n, device
        self.topology = FLAGSHIP_TOPOLOGY if device.type == "cuda" else CPU_TOPOLOGY
        self.batch = 2 * n
        self.limit = LOSS_LIMITS[device.type]
        self.stats_limit = STATS_LIMITS[device.type]
        self.host = np.random.default_rng(0)

    def case(self, name: str, kind: str, model_type: str, extra=(), batch=None,
             **keys) -> dict:
        """A case of ``kind`` on the base config with ``model_type`` at the
        dry run's shapes, float32, then ``extra``; the weights drawn from
        the config's seed. Every bn_stats and confusion launch signature is
        kept."""
        overrides = ["MODEL.TYPE", model_type, "MODEL.TOPOLOGY", repr(self.topology),
                     "AUGMENTATION.CROP_SIZE", str(DRYRUN_CROP),
                     "TRAINER.BATCH_SIZE", str(batch or self.batch),
                     "TRAINER.PRECISION", "fp32"]
        if model_type == "whatevernet":
            overrides += ["DATALOADER.INCLUDE_UNLABELED", "True"]
        return dict(name=name, kind=kind, config="base",
                    overrides=overrides + list(extra), keep_bn=True, keep_conf=True,
                    **keys)

    def stack(self, k: int | None = None) -> torch.Tensor:
        """A planar wire batch ``(B, 15, S, S)`` (``(k, B, ...)``): uniform
        imagery, label planes thresholded at 0.8."""
        shape = (self.batch, 15, DRYRUN_CROP, DRYRUN_CROP)
        stack = self.host.uniform(0, 1, shape if k is None else (k,) + shape
                                  ).astype(np.float32)
        stack[..., 12:, :, :] = (stack[..., 12:, :, :] > 0.8).astype(np.float32)
        return torch.from_numpy(stack)

    def scene(self, h: int, w: int) -> dict:
        x = self.host.uniform(0, 1, (h, w, 6)).astype(np.float32)
        y = (self.host.uniform(size=(h, w, 1)) > 0.8).astype(np.float32)
        return {"x_t1": torch.from_numpy(x), "x_t2": torch.from_numpy(x[::-1].copy()),
                "y_change": torch.from_numpy(y)}

    def surfaces(self, which: str, fixture: str | None) -> list:
        """``[(surface, cases run in the world, check), ...]`` in the JAX
        order; ``check(world, one)`` reads the world's results (``world[r]
        [name]``) and runs the references in this process, returning the
        line's detail or raising."""
        n, out = self.n, []
        for regime, model_type in REGIME_MODELS.items():
            stack = self.stack()
            is_labeled = torch.from_numpy(
                (self.host.uniform(size=(self.batch,)) > 0.5).astype(np.float32))
            case = self.case(regime, "step", model_type, regime=regime, stack=stack,
                             is_labeled=is_labeled)
            out.append((f"{regime} step ({model_type})", [case], self._step(case)))
        case = self.case("bf16", "step", "siameseunet",
                         ["TRAINER.PRECISION", "bf16", "MODEL.PACKED_FULLRES", "True"],
                         regime="supervised", stack=self.stack(),
                         is_labeled=torch.ones(self.batch))
        out.append(("production-precision step (bf16 + PACKED_FULLRES)", [case],
                    self._bf16(case)))
        for sync_bn, label in ((True, "scanned K=2 step"),
                               (False, "scanned K=2 step, per-replica BN "
                                       "(MODEL.SYNC_BN: False)")):
            case = self.case(f"scanned_sync{int(sync_bn)}", "scanned", "siameseunet",
                             ["MODEL.SYNC_BN", str(sync_bn)], regime="supervised",
                             stacks=self.stack(DRYRUN_K),
                             is_labeled=torch.ones(DRYRUN_K, self.batch))
            steps = dict(case, name=f"{case['name']}_k1", eager_steps=True)
            out.append((label, [case] + ([] if sync_bn else [steps]),
                        self._scanned(case, steps, sync_bn)))
        if which == "smoke":
            return out

        items = [self.scene(48, 48), self.scene(70, 50), self.scene(48, 48)]
        case = self.case("bucketed_eval", "measurer", "siameseunet", scenes=items)
        out.append(("bucketed full-scene eval", [case], self._bucketed(case)))
        item = self.scene(64 * max(n // 2, 1), 64)
        case = self.case("scene_probs", "scene_probs", "siameseunet", scenes=[item],
                         tf32=False)
        out.append(("height-sharded scene inference", [case], self._scene(case)))
        fixture_opts = fixture_cfg_overrides() + ["AUGMENTATION.CROP_SIZE",
                                                  str(DRYRUN_CROP)]
        case = self.case("wire_eval", "measurer", "siameseunet", fixture_opts,
                         paths={"DATASET": fixture})
        out.append(("mesh-sharded fused wire eval", [case], self._wire(case)))
        if n % 2 or n < 4:
            return out

        stack = self.stack()
        grid = ["TRAINER.SPATIAL_SHARDS", str(n // 2)]
        case = self.case("space", "step", "siameseunet", grid, regime="supervised",
                         stack=stack, is_labeled=torch.ones(self.batch))
        out.append(("height-sharded training (2-D data x space mesh)", [case],
                    self._step(case, f"grid (data 2, space {n // 2}), halo exchanges "
                                     f"+ cross-space BN,")))
        case = self.case("triad", "step", "siameseunet",
                         grid + ["MODEL.REMAT", "True", "TRAINER.GRAD_ACCUM", "2"],
                         regime="supervised", stack=stack, is_labeled=torch.ones(self.batch))
        out.append(("memory triad (REMAT + GRAD_ACCUM=2 on the 2-D mesh)", [case],
                    self._step(case, "stage checkpointing + 2 micro-batches,")))
        # the JAX cluster check's supervised step (cluster_check.worker_cfg /
        # worker_batch: batch n, its own default_rng(0) batch, every row
        # labeled) and wire evaluation
        rng = np.random.default_rng(0)
        stack = rng.uniform(0, 1, (n, 15, DRYRUN_CROP, DRYRUN_CROP)).astype(np.float32)
        stack[:, 12:] = (stack[:, 12:] > 0.8).astype(np.float32)
        step = self.case("cluster_step", "step", "siameseunet", batch=n,
                         regime="supervised", stack=torch.from_numpy(stack),
                         is_labeled=torch.ones(n))
        wire = self.case("cluster_eval", "measurer", "siameseunet", fixture_opts,
                         batch=n, paths={"DATASET": fixture})
        out.append((f"{n}-process torch.distributed world (env://)", [step, wire],
                    self._cluster(step, wire)))
        return out

    # ---- the checks -------------------------------------------------------

    def reference(self, case: dict) -> dict:
        """``case`` run in this process: the one-process reference."""
        return cluster_check.summary(cluster_check.run_case(case, self.device))

    def _ranks(self, world: list, name: str) -> list:
        return [ranks[name] for ranks in world]

    def _held(self, name: str, got: list, ref: dict, against: str) -> tuple:
        """The ranks' results ``got`` of case ``name`` held against
        ``ref``: the losses within ``LOSS_LIMITS``, the running statistics
        within ``STATS_LIMITS``; returns (loss, worst loss gap, worst
        statistics gap)."""
        losses = [r["metrics"]["loss"] for r in got]
        want = ref["metrics"]["loss"]
        worst = max(_rel(x, want) for x in losses)
        stats = max(_stats_gap(r["buffers"], ref["buffers"]) for r in got)
        if (not all(math.isfinite(x) for x in losses) or worst > self.limit
                or stats > self.stats_limit):
            raise AssertionError(f"{name}: the ranks' losses {losses} against "
                                 f"{against} {want} (limit {self.limit:g} relative), "
                                 f"running statistics {stats:.1e} away (limit "
                                 f"{self.stats_limit:g})")
        return losses[0], worst, stats

    def _step(self, case: dict, what: str = ""):
        def check(world, one):
            ref = one[case["name"]] = self.reference(case)
            loss, worst, stats = self._held(case["name"], self._ranks(world, case["name"]),
                                            ref, "one process")
            return (f"{what} {self.n}-rank world, loss={loss:.4f} (one process "
                    f"{ref['metrics']['loss']:.4f}, worst relative difference "
                    f"{worst:.1e}; running statistics {stats:.1e})").strip()
        return check

    def _bf16(self, case: dict):
        def check(world, one):
            losses = [r["metrics"]["loss"] for r in self._ranks(world, case["name"])]
            if not math.isfinite(losses[0]) or len(set(losses)) != 1:
                raise AssertionError(f"the bf16 step's losses {losses}: not finite, "
                                     f"or not equal on every rank")
            compute = "bf16 autocast" if self.device.type == "cuda" else \
                "float32 (the CPU computes in float32)"
            return (f"{self.n}-rank world, {compute}, MODEL.PACKED_FULLRES a "
                    f"declared no-op, loss={losses[0]:.4f} on every rank")
        return check

    def _scanned(self, case: dict, steps: dict, sync_bn: bool):
        def check(world, one):
            got = self._ranks(world, case["name"])
            if any(r["mode"] != "eager" for r in got):
                raise AssertionError(f"{case['name']}: window modes "
                                     f"{[r['mode'] for r in got]}")
            single = one[steps["name"]] = self.reference(steps)
            if sync_bn:
                ref, against = single, "the two K=1 steps in one process"
            else:
                ref, against = self._ranks(world, steps["name"])[0], \
                    "the world's two K=1 steps"
            loss, worst, stats = self._held(case["name"], got, ref, against)
            detail = (f"loss={loss:.4f}, {against} {ref['metrics']['loss']:.4f} "
                      f"(worst relative difference {worst:.1e}; running statistics "
                      f"{stats:.1e})")
            if sync_bn:
                return detail
            # the control: per-replica statistics against one process
            control = min(_stats_gap(r["buffers"], single["buffers"]) for r in got)
            loss_gap = min(_rel(r["metrics"]["loss"], single["metrics"]["loss"])
                           for r in got)
            if not control > self.stats_limit:
                raise AssertionError(f"{case['name']}: per-replica running statistics "
                                     f"are within {control:.1e} of one process's, "
                                     f"inside the limit {self.stats_limit:g}: the limit "
                                     f"cannot tell a world without sync-BN")
            return (f"{detail}; one process {single['metrics']['loss']:.4f}, "
                    f"{loss_gap:.1e} away, its running statistics {control:.1e} away "
                    f"(limit {self.stats_limit:g})")
        return check

    def _counts_equal(self, got: list, ref: dict, name: str) -> None:
        for r in got:
            for k in COUNT_KEYS:
                if not torch.equal(r[k], ref[k]):
                    raise AssertionError(f"{name}: a rank's {k} {r[k].tolist()} != "
                                         f"one process's {ref[k].tolist()}")

    def _bucketed(self, case: dict):
        def check(world, one):
            got = self._ranks(world, case["name"])
            ref = one[case["name"]] = self.reference(case)
            self._counts_equal(got, ref, case["name"])
            if not math.isfinite(got[0]["f1"]):
                raise AssertionError(f"bucketed eval: non-finite F1 {got[0]['f1']}")
            return (f"{len(case['scenes'])} scenes, 2 shape buckets, "
                    f"F1={got[0]['f1']:.3f}, counts == one process on every rank")
        return check

    def _scene(self, case: dict):
        def check(world, one):
            got = [r["probs"][0] for r in self._ranks(world, case["name"])]
            ref = one[case["name"]] = self.reference(case)
            diff = float((got[0] - ref["probs"][0]).abs().max())
            equal = all(torch.equal(g, got[0]) for g in got)
            if not equal or not diff <= SCENE_LIMIT:
                raise AssertionError(f"sharded scene probabilities: max |sharded - "
                                     f"single| {diff} (limit {SCENE_LIMIT}), equal "
                                     f"on the ranks {equal}")
            return (f"{got[0].shape[0]}px height over {self.n} ranks, max |sharded "
                    f"- single| {diff:.1e} (float32, TF32 off)")
        return check

    def _wire(self, case: dict):
        def check(world, one):
            got = self._ranks(world, case["name"])
            ref = one[case["name"]] = self.reference(case)
            self._counts_equal(got, ref, case["name"])
            pixels = int(sum(ref[k][0] for k in COUNT_KEYS))
            return (f"{pixels} valid pixels, batch axis over {self.n} ranks "
                    f"(zero-valid padded), counts == one process, "
                    f"F1={got[0]['f1']:.3f}")
        return check

    def _cluster(self, step: dict, wire: dict):
        check_step = self._step(step)

        def check(world, one):
            check_step(world, one)
            want = one[step["name"]]["metrics"]["loss"]
            ref = one[wire["name"]] = self.reference(wire)
            self._counts_equal(self._ranks(world, wire["name"]), ref, wire["name"])
            return (f"{self.n} processes joined through env:// (MASTER_ADDR/PORT, "
                    f"WORLD_SIZE, RANK, LOCAL_RANK), cross-process gradient "
                    f"all-reduce + sharded fused eval == one process (loss "
                    f"{want:.4f}, F1 {ref['f1']:.3f})")
        return check


def _port_taken(stderr: str) -> bool:
    """Whether rank 0's store failed to bind its port."""
    return "EADDRINUSE" in stderr or "address already in use" in stderr.lower()


def _launch(cases: list, device: torch.device, n: int, out_dir: Path) -> list:
    """The world of ``n`` ranks, joined through ``env://``, running
    ``cases`` in one ``dryrun`` case; returns each rank's ``{name:
    result}``. A world whose store found its port taken (the free port is
    picked before rank 0 binds it) is reported and tried once more; any
    other failure raises at once."""
    job = {"device": device.type, "backend": cluster_check.backend_for(device, n),
           "cases": [{"name": "dryrun", "kind": "dryrun", "surfaces": cases}]}
    for attempt in range(2):
        rcs, outs = cluster_check.launch_cluster(job, out_dir / str(attempt), world=n,
                                                 timeout=LAUNCH_TIMEOUT,
                                                 rendezvous="env")
        if rcs == [0] * n:
            return [torch.load(out_dir / str(attempt) / f"dryrun.rank{r}.pt",
                               weights_only=False) for r in range(n)]
        failed = (f"the {n}-rank world exited {rcs}:\n"
                  + "\n".join(f"[rank {r}] {err[-3000:]}"
                              for r, (_, err) in enumerate(outs) if rcs[r]))
        if attempt or not _port_taken(outs[0][1]):
            raise RuntimeError(failed)
        print(f"{failed}\nrank 0's store found its port taken: trying once more",
              file=sys.stderr, flush=True)


def dryrun_multichip(n_ranks: int, surfaces: str = "all", device=None) -> dict:
    """Run the dry run's surfaces (the module docstring) over a world of
    ``n_ranks`` processes on ``device`` (default: the card; ``"cpu"``: gloo
    on the CPU), printing a line per surface that passes. Returns ``{"surfaces":
    [(surface, detail), ...], "world": [rank -> {case name: result}],
    "one": {case name: the one-process result}, "seconds": {"world",
    "checks"}, "wall_s": s}``; raises at the first surface that fails."""
    if surfaces not in ("all", "smoke"):
        raise ValueError(f"surfaces must be 'all' or 'smoke', got {surfaces!r}")
    device = resolve_device(device)
    t0 = time.perf_counter()
    plan = _Plan(int(n_ranks), device)
    passed, one = [], {}
    with tempfile.TemporaryDirectory(prefix="dryrun_") as tmp:
        fixture = None
        if surfaces == "all":
            fixture = str(Path(tmp) / "fixture")
            generate_fixture_dataset(fixture, seed=3)
        plan_surfaces = plan.surfaces(surfaces, fixture)
        t1 = time.perf_counter()
        world = _launch([c for _, cases, _ in plan_surfaces for c in cases], device,
                        plan.n, Path(tmp) / "world")
        seconds = {"world": time.perf_counter() - t1}
        for label, _, check in plan_surfaces:
            detail = check(world, one)
            _ok(label, detail)
            passed.append((label, detail))
        seconds["checks"] = time.perf_counter() - t1 - seconds["world"]
    print(f"dryrun_multichip OK: {plan.n}-rank world, {len(passed)} surfaces"
          + (" (smoke subset)" if surfaces == "smoke" else ""), flush=True)
    return {"surfaces": passed, "world": world, "one": one, "seconds": seconds,
            "wall_s": time.perf_counter() - t0}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("n_ranks", nargs="?", type=int, default=8)
    p.add_argument("--surfaces", default="all", choices=("all", "smoke"))
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card; 'cpu' for the tests)")
    args = p.parse_args(argv)
    dryrun_multichip(args.n_ranks, args.surfaces, args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
