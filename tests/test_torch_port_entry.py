"""The port's entry points (``multimodal_siamese_cd_tpu_torch.
graft_entry``) against the repository's ``__graft_entry__.py``, on the CPU.

* ``entry``: the example batches are the JAX entry's draws, laid out NCHW
  (bit for bit); ``fn`` on the JAX entry's weights, moved with
  ``weights.state_dict_from_jax``, equals the JAX ``fn`` on the same
  batches within atol 1e-5 (fp32, ``PACKED_FULLRES False``; the JAX
  flagship config is cut to topology [8, 16] here, which changes neither
  function: a full-width forward is the card's, ``chip_smoke.py`` 15a; its
  ``create_train_state`` runs the flax init jitted, which draws the same
  variables).
* ``dryrun_multichip(4, "all", device="cpu")``: a world of four gloo
  processes prints the 12 surface lines and the closing line. Started from
  the JAX dry run's weights (``create_train_state(cfg, PRNGKey(0))`` of
  each model type) with augmentation off on both sides (the draws are
  each package's own; the test substitutes the dry run's case builder to
  give its cases both), each surface's number equals the JAX dry run's on
  the same global batch, computed here on the 4-device mesh as the JAX dry
  run computes it: losses rel 1e-5 (the JAX mesh step's own bound,
  tests/test_train_lib.py:124-178) — rel 2e-2 for the production-precision
  step, which the JAX side runs in bf16 and the port on the CPU in float32
  — and F1 atol 1e-3 (the JAX mesh's counts are held within 1.0 of a
  device's, tests/test_train_lib.py:685-747).
* ``dryrun_multichip(8, "smoke", device="cpu")``: the world of eight ranks,
  its 6 lines, at its defaults (seeded weights, augmentation on).
* A surface made to fail (its limit patched below zero) raises, and the
  module's process exits non-zero without the closing line, as does
  surface 6's control under a statistics limit too loose to see
  per-replica BatchNorm; a world whose
  store found its port taken is tried once more, any other failed world
  raises at once; without a card ``dryrun_multichip(4)`` raises
  ``RuntimeError``.
"""

import contextlib
import io
import subprocess
import sys
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

import __graft_entry__ as jax_entry
from multimodal_siamese_cd_tpu import evaluation as jax_eval
from multimodal_siamese_cd_tpu import train_lib as jax_train_lib
from multimodal_siamese_cd_tpu.data.dataset import MultimodalCDDataset as JaxDataset
from multimodal_siamese_cd_tpu.data.synthetic import (
    fixture_cfg_overrides, generate_fixture_dataset)
from multimodal_siamese_cd_tpu.models import create_network as jax_create_network
from multimodal_siamese_cd_tpu.models.factory import init_variables
from multimodal_siamese_cd_tpu.parallel import data_mesh, data_space_mesh, wire_sharding
from multimodal_siamese_cd_tpu.parallel.cluster_check import worker_cfg
from multimodal_siamese_cd_tpu_torch import graft_entry
from multimodal_siamese_cd_tpu_torch.config import load_cfg
from multimodal_siamese_cd_tpu_torch.models.factory import create_network
from multimodal_siamese_cd_tpu_torch.weights import state_dict_from_jax

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
N = 4
NO_AUG = ["AUGMENTATION.RANDOM_FLIP", "False", "AUGMENTATION.RANDOM_ROTATE", "False"]
RNG = jax.random.PRNGKey(7)       # the JAX dry run's step key
LOSS_RTOL, BF16_RTOL, F1_ATOL = 1e-5, 2e-2, 1e-3


def _jax_cfg(model_type, **extra):
    """The JAX dry run's ``make_cfg`` (__graft_entry__.py:117-126),
    augmentation off."""
    cfg = jax_entry._flagship_cfg(topology=graft_entry.CPU_TOPOLOGY,
                                  crop=graft_entry.DRYRUN_CROP, batch=2 * N)
    cfg.MODEL.TYPE = model_type
    cfg.TRAINER.PRECISION = "fp32"
    if model_type == "whatevernet":
        cfg.DATALOADER.INCLUDE_UNLABELED = True
    cfg.merge_from_list(NO_AUG)
    for key, value in extra.items():
        section, name = key.split("__")
        setattr(cfg[section], name, value)
    return cfg


def _init(model_type: str) -> dict:
    """The variables ``create_train_state(cfg, PRNGKey(0))`` draws for the
    dry run's config of ``model_type`` (its ``init_variables``, jitted: the
    same values), on the host. One set serves every surface of the type:
    the JAX dry run draws the same ones for each."""
    cfg = _jax_cfg(model_type)
    model = jax_create_network(cfg)
    return jax.device_get(jax.jit(lambda r: init_variables(model, cfg, r))(
        jax.random.PRNGKey(0)))


def _state(cfg, weights: dict):
    """``create_train_state(cfg, PRNGKey(0))`` from the drawn ``weights``."""
    model = jax_create_network(cfg)
    w = weights[cfg.MODEL.TYPE]
    return model, jax_train_lib.TrainState.create(
        apply_fn=model.apply, params=w["params"], batch_stats=w["batch_stats"],
        tx=jax_train_lib.make_optimizer(cfg))


def _jax_step_loss(weights, cfg, regime, mesh, stack, is_labeled, sharding,
                   scanned=False):
    model, state = _state(cfg, weights)
    make = jax_train_lib.make_scanned_train_step if scanned else \
        jax_train_lib.make_train_step
    step = make(model, cfg, regime, mesh=mesh)
    # a scanned window's (k, B) label masks share the stacks' sharding
    labels = jax.device_put(is_labeled, sharding) if scanned else is_labeled
    _, m = step(state, jax.device_put(stack, sharding), labels, RNG)
    return float(m["loss"])


def _jax_surfaces(weights: dict, cases: dict, fixture: Path) -> dict:
    """The JAX dry run's numbers (its code, __graft_entry__.py:136-336, on
    the 4-device meshes, augmentation off), each on the inputs of the
    port's case of the same surface (``cases``: name -> case); the
    surfaces compile in threads, each on its own state."""
    mesh = data_mesh(jax.devices()[:N])
    mesh2 = data_space_mesh(N // 2, jax.devices()[:N])
    data = NamedSharding(mesh, P("data"))
    jobs = {}
    for regime, model_type in jax_train_lib.REGIME_MODELS.items():
        case = cases[regime]
        jobs[regime] = (_jax_step_loss, _jax_cfg(model_type), regime, mesh,
                        case["stack"].numpy(), case["is_labeled"].numpy(), data)
    ones = np.ones(2 * N, np.float32)
    jobs["bf16"] = (_jax_step_loss, _jax_cfg("siameseunet", TRAINER__PRECISION="bf16",
                                             MODEL__PACKED_FULLRES=True),
                    "supervised", mesh, cases["bf16"]["stack"].numpy(), ones, data)
    for sync in (1, 0):
        case = cases[f"scanned_sync{sync}"]
        jobs[f"scanned_sync{sync}"] = (
            _jax_step_loss, _jax_cfg("siameseunet", MODEL__SYNC_BN=bool(sync)),
            "supervised", mesh, case["stacks"].numpy(), case["is_labeled"].numpy(),
            NamedSharding(mesh, P(None, "data")), True)
    for name, extra in (("space", {}), ("triad", {"MODEL__REMAT": True,
                                                  "TRAINER__GRAD_ACCUM": 2})):
        jobs[name] = (_jax_step_loss, _jax_cfg("siameseunet", **extra), "supervised",
                      mesh2, cases[name]["stack"].numpy(), ones, wire_sharding(mesh2))
    jobs["bucketed_eval"] = (_jax_items_f1, cases["bucketed_eval"]["scenes"])
    jobs["cluster"] = (_jax_cluster, cases["cluster_step"]["stack"].numpy(), mesh,
                       fixture)
    with ThreadPoolExecutor(4) as pool:
        futures = {name: pool.submit(job[0], weights, *job[1:])
                   for name, job in jobs.items()}
        out = {name: f.result() for name, f in futures.items()}
    out["cluster_step"], out["cluster_eval"] = out.pop("cluster")
    return out


def _jax_items_f1(weights: dict, scenes: list) -> float:
    model, state = _state(_jax_cfg("siameseunet"), weights)
    items = [{k: v.numpy() for k, v in item.items()} for item in scenes]
    m = jax_eval.run_measurer(model, state, items, np.asarray([0.5]))
    return float(np.asarray(m.compute_f1()).max())


def _jax_cluster(weights: dict, stack: np.ndarray, mesh, fixture: Path) -> tuple:
    """The JAX cluster check's ``single_process_reference``
    (parallel/cluster_check.py:176-218), augmentation off: the loss and
    the wire evaluation's F1."""
    cfg = worker_cfg(N)
    cfg.merge_from_list(NO_AUG)
    model, state = _state(cfg, weights)
    step = jax_train_lib.make_supervised_train_step(model, cfg, mesh=mesh)
    data = NamedSharding(mesh, P("data"))
    _, m = step(jax.device_get(state), jax.device_put(stack, data),
                jax.device_put(np.ones(N, np.float32), data), RNG)
    cfg.merge_from_list(fixture_cfg_overrides())
    cfg.PATHS.DATASET = str(fixture)
    ds = JaxDataset(cfg, "validation", no_augmentations=True, dataset_mode="first_last",
                    disable_multiplier=True, disable_unlabeled=True)
    f1 = jax_eval.run_measurer(model, state, ds, np.asarray([0.5])).compute_f1()
    return float(m["loss"]), float(np.asarray(f1).max())


@pytest.fixture(scope="module")
def dryrun(tmp_path_factory):
    """The port's 4-rank dry run from the JAX weights (run in a thread,
    its printed lines captured) beside the JAX side's numbers."""
    types = list(jax_train_lib.REGIME_MODELS.values())
    with ThreadPoolExecutor(len(types)) as pool:
        jax_weights = dict(zip(types, pool.map(_init, types)))
    weights = {t: state_dict_from_jax(w) for t, w in jax_weights.items()}
    make_case = graft_entry._Plan.case

    def case(plan, name, kind, model_type, extra=(), batch=None, **keys):
        """The port's case from the JAX weights, augmentation off."""
        return make_case(plan, name, kind, model_type, list(extra) + NO_AUG, batch,
                         state=weights[model_type], **keys)

    printed, result = io.StringIO(), {}

    def port():
        with contextlib.redirect_stdout(printed):
            result["out"] = graft_entry.dryrun_multichip(N, "all", device="cpu")

    fixture = tmp_path_factory.mktemp("jax_fixture")
    generate_fixture_dataset(fixture, seed=3)
    with pytest.MonkeyPatch.context() as patch:
        patch.setattr(graft_entry._Plan, "case", case)
        thread = threading.Thread(target=port)
        thread.start()
        # the same inputs, drawn as the port's dry run draws them
        plan = graft_entry._Plan(N, torch.device("cpu"))
        cases = {c["name"]: c for _, cs, _ in plan.surfaces("all", str(fixture))
                 for c in cs}
        jax_side = _jax_surfaces(jax_weights, cases, fixture)
        thread.join(timeout=600)
    assert not thread.is_alive() and "out" in result, printed.getvalue()
    return {"printed": printed.getvalue().splitlines(), "out": result["out"],
            "jax": jax_side}


def _port_loss(out: dict, name: str) -> float:
    losses = {r[name]["metrics"]["loss"] for r in out["world"]}
    assert len(losses) == 1, (name, losses)
    return losses.pop()


def test_dryrun_prints_twelve_surfaces_in_the_jax_order(dryrun):
    lines = dryrun["printed"]
    surfaces = [line for line in lines if line.startswith("dryrun surface OK: ")]
    assert [s.split(": ", 1)[1].split(" — ")[0] for s in surfaces] == [
        "supervised step (siameseunet)", "dualtask step (dtsiameseunet)",
        "semisupervised step (whatevernet)",
        "production-precision step (bf16 + PACKED_FULLRES)", "scanned K=2 step",
        "scanned K=2 step, per-replica BN (MODEL.SYNC_BN: False)",
        "bucketed full-scene eval", "height-sharded scene inference",
        "mesh-sharded fused wire eval",
        "height-sharded training (2-D data x space mesh)",
        "memory triad (REMAT + GRAD_ACCUM=2 on the 2-D mesh)",
        "4-process torch.distributed world (env://)"]
    assert lines[-1] == "dryrun_multichip OK: 4-rank world, 12 surfaces"
    assert len(dryrun["out"]["surfaces"]) == 12


@pytest.mark.parametrize("name", ["supervised", "dualtask", "semisupervised",
                                  "scanned_sync1", "scanned_sync0", "space", "triad",
                                  "cluster_step"])
def test_dryrun_losses_match_the_jax_dry_run(dryrun, name):
    """Every step surface's loss (every rank's, equal) within rel 1e-5 of
    the JAX dry run's on the same global batch and weights."""
    np.testing.assert_allclose(_port_loss(dryrun["out"], name), dryrun["jax"][name],
                               rtol=LOSS_RTOL)


def test_dryrun_production_precision_step_near_the_jax_bf16_step(dryrun):
    """The JAX side runs the bf16 + PACKED_FULLRES step in bf16; the port on
    the CPU computes it in float32: rel 2e-2."""
    np.testing.assert_allclose(_port_loss(dryrun["out"], "bf16"), dryrun["jax"]["bf16"],
                               rtol=BF16_RTOL)


@pytest.mark.parametrize("name", ["bucketed_eval", "cluster_eval"])
def test_dryrun_f1_matches_the_jax_dry_run(dryrun, name):
    f1s = {r[name]["f1"] for r in dryrun["out"]["world"]}
    assert len(f1s) == 1
    np.testing.assert_allclose(f1s.pop(), dryrun["jax"][name], atol=F1_ATOL, rtol=0)


def test_dryrun_smoke_over_eight_ranks(capsys):
    """The world of eight ranks the port had not run before: the first six
    surfaces at the dry run's defaults."""
    out = graft_entry.dryrun_multichip(8, "smoke", device="cpu")
    lines = capsys.readouterr().out.splitlines()
    assert sum(line.startswith("dryrun surface OK: ") for line in lines) == 6
    assert lines[-1] == "dryrun_multichip OK: 8-rank world, 6 surfaces (smoke subset)"
    assert len(out["world"]) == 8


@pytest.mark.parametrize("limit,passed,message", [
    ("LOSS_LIMITS['cpu'] = -1.0", 0, "limit -1"),
    ("STATS_LIMITS['cpu'] = 1.0", 5, "cannot tell a world without sync-BN")])
def test_a_failing_surface_fails_the_process(limit, passed, message):
    """A surface held to a limit below zero raises, and the module's
    process exits non-zero with no closing line; so does surface 6's
    control when the statistics' limit is too loose to see a world
    without sync-BN."""
    code = ("import sys\n"
            "from multimodal_siamese_cd_tpu_torch import graft_entry as g\n"
            f"g.{limit}\n"
            "sys.exit(g.main(['2', '--surfaces', 'smoke', '--device', 'cpu']))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode != 0
    assert proc.stdout.count("dryrun surface OK") == passed
    assert "dryrun_multichip OK" not in proc.stdout
    assert "AssertionError" in proc.stderr and message in proc.stderr


def _fake_worlds(monkeypatch, errs: list) -> list:
    """``launch_cluster`` standing in for the worlds: the i-th launch's
    rank 0 fails with ``errs[i]`` (None: every rank succeeds)."""
    launches = []

    def launch(job, out_dir, world, timeout, rendezvous):
        launches.append(rendezvous)
        err = errs[len(launches) - 1]
        Path(out_dir).mkdir(parents=True, exist_ok=True)
        if err is None:
            for r in range(world):
                torch.save({"case": r}, Path(out_dir) / f"dryrun.rank{r}.pt")
        return [0 if err is None or r else 1 for r in range(world)], \
            [("", "" if err is None or r else err) for r in range(world)]

    monkeypatch.setattr(graft_entry.cluster_check, "launch_cluster", launch)
    return launches


def test_a_world_whose_port_was_taken_is_tried_once_more(monkeypatch, tmp_path, capsys):
    """Rank 0's store could not bind: the first world is reported on
    stderr and a second one started."""
    taken = "RuntimeError: ... code: -98, name: EADDRINUSE, message: address already in use"
    launches = _fake_worlds(monkeypatch, [taken, None])
    got = graft_entry._launch([], torch.device("cpu"), 2, tmp_path)
    assert got == [{"case": 0}, {"case": 1}] and launches == ["env", "env"]
    err = capsys.readouterr().err
    assert "exited [1, 0]" in err and "EADDRINUSE" in err and "once more" in err


@pytest.mark.parametrize("errs", [["AssertionError: a rank failed", None],
                                  ["address already in use", "address already in use"]])
def test_any_other_failed_world_raises_at_once(monkeypatch, tmp_path, errs):
    """A failure that is not the port's raises with the world's stderr,
    without another world; a port taken twice raises after the second."""
    launches = _fake_worlds(monkeypatch, errs)
    with pytest.raises(RuntimeError, match="exited \\[1, 0\\]") as failed:
        graft_entry._launch([], torch.device("cpu"), 2, tmp_path)
    assert errs[len(launches) - 1] in str(failed.value)
    assert len(launches) == (1 if "Assertion" in errs[0] else 2)


def test_dryrun_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        graft_entry.dryrun_multichip(4)


def test_entry_matches_the_jax_entry(monkeypatch):
    """The example batches are the JAX entry's, NCHW; ``fn`` on the JAX
    entry's weights equals the JAX ``fn`` (atol 1e-5), on a model or its
    state dict alike."""
    def small(topology=None, crop=256, batch=8):
        cfg = load_jax_flagship(topology, crop, batch)
        cfg.MODEL.TOPOLOGY = list(graft_entry.CPU_TOPOLOGY)
        cfg.TRAINER.PRECISION = "fp32"
        cfg.MODEL.PACKED_FULLRES = False
        return cfg

    def create_train_state(cfg, rng):
        # the same variables, jitted (an eager flax init first compiles each
        # of its primitives, ~20 s in a fresh process)
        model = jax_create_network(cfg)
        variables = jax.jit(lambda r: init_variables(model, cfg, r))(rng)
        return model, jax_train_lib.TrainState.create(
            apply_fn=model.apply, params=variables["params"],
            batch_stats=variables["batch_stats"], tx=jax_train_lib.make_optimizer(cfg))

    load_jax_flagship = jax_entry._flagship_cfg
    monkeypatch.setattr(jax_entry, "_flagship_cfg", small)
    monkeypatch.setattr(jax_train_lib, "create_train_state", create_train_state)
    jfn, (variables, jx1, jx2) = jax_entry.entry()
    fn, (model, x1, x2) = graft_entry.entry(device="cpu")
    for port, jx in ((x1, jx1), (x2, jx2)):
        assert port.dtype == torch.float32 and port.shape == (8, 6, 256, 256)
        assert np.array_equal(port.numpy(), np.asarray(jx).transpose(0, 3, 1, 2))
    assert list(model.inc.conv.conv[0].weight.shape[:2]) == [64, 6]

    cfg = load_cfg("base")
    cfg.merge_from_list(["MODEL.TYPE", "siameseunet", "MODEL.TOPOLOGY",
                         repr(graft_entry.CPU_TOPOLOGY)])
    small_model = create_network(cfg, device="cpu")
    small_model.load_state_dict(state_dict_from_jax(jax.device_get(variables)))
    got = fn(small_model, x1, x2)
    want = np.asarray(jfn(variables, jx1, jx2)).transpose(0, 3, 1, 2)
    assert got.shape == (8, 1, 256, 256) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    crop = (x1[:1, :, :32, :32], x2[:1, :, :32, :32])
    assert torch.equal(fn(model.state_dict(), *crop), fn(model, *crop))
