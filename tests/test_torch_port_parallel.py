"""The port's data parallelism (``multimodal_siamese_cd_tpu_torch.parallel``)
against the JAX package's 2-device virtual mesh, on the CPU and the
synthetic fixture (``fixture_dataset``).

The port runs a real world of two processes over gloo
(``parallel.cluster_check.launch_cluster``, once for the module: every case
that needs the world goes into one job), each rank feeding its rows of the
global batch; the JAX side runs its jitted steps and evaluations on
``data_mesh(jax.devices()[:2])`` (conftest gives 8 CPU devices). Topology
[8, 16], 32 px crops, fp32, global batch 4, augmentation off where the JAX
package is compared; weights drawn with numpy and moved with
``weights.state_dict_from_jax``. Tolerances, each stated at its test:

* one step: loss rel 1e-5; gradients rtol 1e-3, atol 1e-5 (the JAX
  package's own bound for its mesh step, tests/test_train_lib.py:124-178);
  BatchNorm running statistics atol 1e-5; the two ranks' gradients,
  parameters and buffers bit-equal;
* sharded evaluation counts: atol 1.0 against the JAX mesh's (its own
  bound, tests/test_train_lib.py:685-747); exact between the ranks and
  against the same shares counted in one process;
* the error messages: the JAX package's texts.
"""

from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import struct

from multimodal_siamese_cd_tpu import evaluation as jax_eval
from multimodal_siamese_cd_tpu import train_lib as jax_train_lib
from multimodal_siamese_cd_tpu.config import load_cfg as jax_load_cfg
from multimodal_siamese_cd_tpu.data.dataset import MultimodalCDDataset as JaxDataset
from multimodal_siamese_cd_tpu.data.loader import TrainLoader as JaxTrainLoader
from multimodal_siamese_cd_tpu.data.synthetic import fixture_cfg_overrides
from multimodal_siamese_cd_tpu.models import create_network as jax_create_network
from multimodal_siamese_cd_tpu.parallel import data_mesh
from multimodal_siamese_cd_tpu.parallel import distributed as jax_distributed
from multimodal_siamese_cd_tpu_torch import parallel, wandb_compat
from multimodal_siamese_cd_tpu_torch.data.dataset import MultimodalCDDataset
from multimodal_siamese_cd_tpu_torch.data.loader import TrainLoader
from multimodal_siamese_cd_tpu_torch.parallel import cluster_check
from multimodal_siamese_cd_tpu_torch.parallel import distributed
from multimodal_siamese_cd_tpu_torch.weights import state_dict_from_jax
from test_torch_port_train import _random_variables, _sd

torch.set_num_threads(1)

WORLD, BATCH = 2, 4
# the launch of the world of two, every case included (~10 s here)
LAUNCH_TIMEOUT = 240
BASE = fixture_cfg_overrides() + [
    "MODEL.TOPOLOGY", "[8, 16]", "TRAINER.PRECISION", "fp32",
    "TRAINER.BATCH_SIZE", str(BATCH), "MODEL.PACKED_FULLRES", "False"]
NO_AUG = ["AUGMENTATION.RANDOM_FLIP", "False", "AUGMENTATION.RANDOM_ROTATE", "False"]
# (config, regime, extra overrides) of the step cases held against JAX
JAX_STEPS = {
    "sup": ("siamese", "supervised", []),
    "sup_nosync": ("siamese", "supervised", ["MODEL.SYNC_BN", "False"]),
    "sup_accum": ("siamese", "supervised", ["TRAINER.GRAD_ACCUM", "2"]),
    "dual": ("dtsiamese", "dualtask", []),
    "semi": ("siamese_mmcr_alpha0500", "semisupervised", []),
}
# one labeled row, on rank 0: rank 1 holds none, so the gate is the world's
SEMI_LABELED = [1.0, 0.0, 0.0, 0.0]


class _GradState(jax_train_lib.TrainState):
    """The JAX train state, also keeping the gradients its step applied."""
    grads: Any = struct.field(default=None)

    def apply_gradients(self, *, grads, **kwargs):
        return super().apply_gradients(grads=grads, **kwargs).replace(grads=grads)


def _jax_cfg(root, config, overrides):
    cfg = jax_load_cfg(config)
    cfg.merge_from_list(BASE + list(overrides))
    cfg.PATHS.DATASET = str(root)
    return cfg


def _global_batch(root, config, overrides) -> dict:
    """The first global batch of the JAX package's loader (crops only)."""
    jcfg = _jax_cfg(root, config, overrides)
    jds = JaxDataset(jcfg, "training", return_stack=True, crop_only=True)
    return next(iter(JaxTrainLoader(jds, batch_size=BATCH, num_workers=0, seed=5)))


def _jax_step(jcfg, jmodel, variables, batch) -> dict:
    """One jitted step on the 2-device mesh: metrics, gradients and running
    statistics, torch-named."""
    tree = jax.tree_util.tree_map(jnp.asarray, variables)
    state = _GradState.create(apply_fn=jmodel.apply, params=tree["params"],
                              tx=jax_train_lib.make_optimizer(jcfg),
                              batch_stats=tree["batch_stats"])
    regime = JAX_STEPS_BY_CFG[jcfg.MODEL.TYPE]
    step = jax_train_lib.make_train_step(jmodel, jcfg, regime,
                                         mesh=data_mesh(jax.devices()[:WORLD]))
    new, aux = step(state, batch["stack"], batch["is_labeled"],
                    jax.random.PRNGKey(0))
    return {"metrics": {k: float(v) for k, v in aux.items()},
            "grads": _sd(jax.device_get(new.grads), "params"),
            "stats": _sd(jax.device_get(new.batch_stats), "batch_stats")}


JAX_STEPS_BY_CFG = {"siameseunet": "supervised", "dtsiameseunet": "dualtask",
                    "whatevernet": "semisupervised"}


@pytest.fixture(scope="module")
def world(fixture_dataset, tmp_path_factory):
    """Every case's inputs, the world of two's results (``out[name][rank]``),
    the one-process results (``one[name]``) and the JAX mesh's
    (``jax[name]``)."""
    root = str(fixture_dataset)
    paths = {"DATASET": root}
    cases, jax_steps, weights = [], {}, {}
    for name, (config, regime, extra) in JAX_STEPS.items():
        overrides = NO_AUG + extra
        jcfg = _jax_cfg(root, config, overrides)
        jmodel = jax_create_network(jcfg)
        if config not in weights:
            weights[config] = _random_variables(jmodel, jcfg)
        variables = weights[config]
        batch = dict(_global_batch(root, config, overrides))
        if regime == "semisupervised":
            batch["is_labeled"] = np.asarray(SEMI_LABELED, np.float32)
        jax_steps[name] = (jcfg, jmodel, variables, batch)
        cases.append(dict(name=name, kind="step", config=config,
                          overrides=BASE + overrides, paths=paths, regime=regime,
                          state=state_dict_from_jax(variables),
                          stack=torch.from_numpy(batch["stack"]),
                          is_labeled=torch.from_numpy(batch["is_labeled"])))
    sup = cases[0]
    # REMAT: the recompute's all-reduces; augmentation and dropout: each
    # rank's rows of the world's draws (held against one process)
    cases.append(dict(sup, name="sup_remat",
                      overrides=sup["overrides"] + ["MODEL.REMAT", "True"]))
    aug = dict(_global_batch(root, "siamese", []))
    cases.append(dict(sup, name="sup_aug", overrides=BASE,
                      stack=torch.from_numpy(aug["stack"])))
    cases.append(dict(name="diff", kind="step", config="siamese", paths=paths,
                      overrides=BASE + ["MODEL.TYPE", "siamunet_diff"],
                      regime="supervised", stack=torch.from_numpy(aug["stack"]),
                      is_labeled=torch.ones(BATCH)))
    dual = cases[3]
    cases += [
        dict(name="eval", kind="measurer", config="siamese", paths=paths,
             overrides=sup["overrides"], state=sup["state"]),
        dict(name="dual_eval", kind="dualtask_counts", config="dtsiamese",
             paths=paths, overrides=dual["overrides"], state=dual["state"]),
        dict(name="errors", kind="errors", config="siamese", paths=paths,
             overrides=sup["overrides"], stack=sup["stack"]),
    ]
    train_overrides = BASE + ["DATALOADER.TRAINING_MULTIPLIER", "4", "LOG_FREQ",
                              "2", "TRAINER.EPOCHS", "1", "SAVE_CHECKPOINTS", "[1]"]
    tmp = tmp_path_factory.mktemp("parallel")
    cases.append(dict(name="train", kind="train", config="siamese",
                      overrides=train_overrides, regime="supervised",
                      paths={"DATASET": root, "OUTPUT": str(tmp / "train_world")}))

    # the world runs in its own processes while this one runs the JAX side;
    # so does the training CLI under torchrun, as a user starts it
    pool = ThreadPoolExecutor(2)
    launch = pool.submit(cluster_check.launch_cluster,
                         {"device": "cpu", "backend": "gloo", "cases": cases},
                         tmp / "out", world=WORLD, timeout=LAUNCH_TIMEOUT)
    (tmp / "torchrun").mkdir()
    cli = pool.submit(_torchrun, ["-c", "siamese", "-p", "proj", "-o",
                                  str(tmp / "torchrun"), "-d", root, "--device",
                                  "cpu"] + train_overrides)
    pool.shutdown(wait=False)
    jax_side = {name: _jax_step(*args) for name, args in jax_steps.items()}
    one = {}
    for case in cases:
        if case["kind"] == "step":
            one[case["name"]] = cluster_check.run_case(case, "cpu")
    one_train = dict(cases[-1], paths={"DATASET": root,
                                       "OUTPUT": str(tmp / "train_one")})
    cluster_check.run_case(one_train, "cpu")
    wandb_compat.finish()
    one["shares"] = [cluster_check.run_case(dict(cases[-4], shard=(r, WORLD)), "cpu")
                     for r in range(WORLD)]
    one["unsharded"] = cluster_check.run_case(cases[-4], "cpu")

    # the JAX mesh's sharded evaluations, on the same weights
    evals = {}
    for name, config, w in (("eval", "siamese", weights["siamese"]),
                            ("dual_eval", "dtsiamese", weights["dtsiamese"])):
        jcfg = _jax_cfg(root, config, NO_AUG)
        jmodel, state = jax_train_lib.create_train_state(jcfg, jax.random.PRNGKey(0))
        state = state.replace(params=w["params"], batch_stats=w["batch_stats"])
        ds = JaxDataset(jcfg, "validation", no_augmentations=True,
                        dataset_mode="first_last", disable_multiplier=True,
                        disable_unlabeled=True)
        mesh = data_mesh(jax.devices()[:WORLD])
        if name == "eval":
            m = jax_eval.run_measurer(jmodel, state, ds, np.array([0.5]), mesh=mesh)
            evals[name] = {k: np.asarray(getattr(m, k), np.float64)
                           for k in ("TP", "TN", "FP", "FN")}
        else:
            evals[name] = jax_eval.dualtask_quantitative_counts(jmodel, state, ds,
                                                                mesh=mesh)
    jax_side.update(evals)
    rcs, outs = launch.result()
    assert rcs == [0] * WORLD, "\n".join(o + e[-4000:] for o, e in outs)
    torchrun = cli.result()
    out = {c["name"]: [torch.load(tmp / "out" / f"{c['name']}.rank{r}.pt",
                                  weights_only=False) for r in range(WORLD)]
           for c in cases}
    return dict(out=out, one=one, jax=jax_side, outs=outs, tmp=tmp, cases=cases,
                torchrun=torchrun)


def _torchrun(argv: list):
    """``MSCD_DISTRIBUTED=1 torchrun --standalone --nproc_per_node=2 -m
    ...train_supervised argv``; the whole process group is killed at the
    deadline. Returns the CompletedProcess."""
    import os
    import signal
    import subprocess
    import sys

    repo = Path(__file__).resolve().parent.parent
    env = dict(os.environ, MSCD_DISTRIBUTED="1",
               PYTHONPATH=os.pathsep.join(p for p in (str(repo),
                                                      os.environ.get("PYTHONPATH"))
                                          if p))
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc_per_node={WORLD}", "-m",
           "multimodal_siamese_cd_tpu_torch.train_supervised"] + argv
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=env, cwd=str(repo),
                            start_new_session=True)
    try:
        out, err = proc.communicate(timeout=LAUNCH_TIMEOUT)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, err = proc.communicate()
    return subprocess.CompletedProcess(cmd, proc.returncode, out, err)


def _hold_step(got: dict, want: dict, stats: bool = True) -> None:
    np.testing.assert_allclose(got["metrics"]["loss"], want["metrics"]["loss"],
                               rtol=1e-5)
    for name, g in got["grads"].items():
        np.testing.assert_allclose(g.numpy(), want["grads"][name], rtol=1e-3,
                                   atol=1e-5, err_msg=name)
    if stats:
        for name, s in want["stats"].items():
            np.testing.assert_allclose(got["buffers"][name].numpy(), s, atol=1e-5,
                                       rtol=0, err_msg=name)


def _ranks_equal(results: list) -> None:
    """Every rank's gradients, parameters and buffers, bit for bit."""
    first = results[0]
    for other in results[1:]:
        for part in ("grads", "params", "buffers"):
            for name, t in first[part].items():
                assert torch.equal(t, other[part][name]), (part, name)
        assert first["metrics"] == other["metrics"]


# --- pure functions and errors ----------------------------------------------

@pytest.mark.parametrize("n_items", [0, 1, 3, 4, 7, 20])
@pytest.mark.parametrize("world_size", [1, 2, 3, 8])
def test_process_shard_matches_jax(monkeypatch, n_items, world_size):
    for i in range(world_size):
        monkeypatch.setattr(jax, "process_count", lambda: world_size)
        monkeypatch.setattr(jax, "process_index", lambda: i)
        monkeypatch.setattr(parallel.group, "world_size", lambda: world_size)
        monkeypatch.setattr(parallel.group, "rank", lambda: i)
        assert distributed.process_shard(n_items) == \
            jax_distributed.process_shard(n_items)


@pytest.mark.parametrize("batch,accum", [(4, 1), (8, 2), (8, 4), (12, 3)])
def test_batch_rows_match_jax_micro_batch_sharding(batch, accum):
    """A rank's rows are the rows the JAX package's 2-device mesh gives each
    device: the micro-batch axis of ``(accum, batch / accum)`` sharded over
    the data axis (train_lib.py:261-281)."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    mesh = data_mesh(jax.devices()[:WORLD])
    sharding = NamedSharding(mesh, P(None, "data"))
    index = np.arange(batch).reshape(accum, batch // accum)
    for rank, device in enumerate(mesh.devices.flat):
        want = index[sharding.devices_indices_map(index.shape)[device]].reshape(-1)
        np.testing.assert_array_equal(
            parallel.batch_rows(batch, accum, rank, WORLD), want)


@pytest.mark.parametrize("port_env,jax_env", [
    ({"MASTER_ADDR": "localhost"}, {"JAX_COORDINATOR_ADDRESS": "localhost:1"}),
    ({"WORLD_SIZE": "2", "RANK": "0"}, {"JAX_NUM_PROCESSES": "2"}),
])
def test_partial_distributed_env_raises_like_jax(monkeypatch, port_env, jax_env):
    """``MSCD_DISTRIBUTED=1`` with part of the coordinator spec raises
    before any init, as the JAX package's does (distributed.py:37-46)."""
    for key in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK",
                "JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES", "JAX_PROCESS_ID"):
        monkeypatch.delenv(key, raising=False)
    monkeypatch.setenv("MSCD_DISTRIBUTED", "1")
    for key, value in {**port_env, **jax_env}.items():
        monkeypatch.setenv(key, value)
    prefix = "MSCD_DISTRIBUTED=1 with a partial coordinator spec: set ALL of "
    with pytest.raises(ValueError, match=prefix) as jax_err:
        jax_distributed.maybe_initialize_distributed()
    with pytest.raises(ValueError, match=prefix) as port_err:
        distributed.maybe_initialize_distributed()
    assert str(port_err.value).startswith(str(jax_err.value)[:len(prefix)])
    assert not parallel.group.initialized()


def test_distributed_env_without_a_spec_raises(monkeypatch):
    """The port has no auto-detection: ``MSCD_DISTRIBUTED=1`` alone raises
    instead of training alone; without it nothing is initialised."""
    for key in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(key, raising=False)
    monkeypatch.delenv("MSCD_DISTRIBUTED", raising=False)
    assert distributed.maybe_initialize_distributed() is False
    monkeypatch.setenv("MSCD_DISTRIBUTED", "1")
    with pytest.raises(ValueError, match="with no coordinator spec"):
        distributed.maybe_initialize_distributed()
    assert not parallel.group.initialized()


@pytest.mark.parametrize("workers,worker_type", [(0, "thread"), (2, "thread"),
                                                 (2, "process")])
def test_loader_rows_are_the_global_batch_rows(fixture_dataset, workers,
                                               worker_type):
    """A rank's loader (``rows``) yields exactly its rows of every global
    batch, crop draws included, for every worker type."""
    from multimodal_siamese_cd_tpu_torch.config import load_cfg

    cfg = load_cfg("siamese")
    cfg.merge_from_list(BASE + ["DATALOADER.TRAINING_MULTIPLIER", "4"])
    cfg.PATHS.DATASET = str(fixture_dataset)
    ds = MultimodalCDDataset(cfg, "training")
    whole = list(TrainLoader(ds, BATCH, num_workers=0, seed=3))
    for rank in range(WORLD):
        rows = parallel.batch_rows(BATCH, 2, rank, WORLD)
        loader = TrainLoader(ds, BATCH, num_workers=workers, seed=3,
                             worker_type=worker_type, rows=rows)
        try:
            got = list(loader)
        finally:
            loader.close()
        assert len(got) == len(whole) == len(loader) == 2
        for g, w in zip(got, whole):
            assert g["stack"].tobytes() == w["stack"][rows].tobytes()
            np.testing.assert_array_equal(g["is_labeled"], w["is_labeled"][rows])
            assert g["aoi_id"] == [w["aoi_id"][r] for r in rows]


def test_world_errors_match_jax(world, fixture_dataset):
    """The errors a world of two raises carry the JAX package's texts: a
    GRAD_ACCUM micro-batch that does not split over the ranks
    (train_lib.py:270-276), ``SYNC_BN: False`` with a batch the world does
    not divide (train_lib.py:196-199), and the trainer's indivisible batch
    (trainers.py:68-76, which needs more than one JAX process to raise)."""
    got = world["out"]["errors"]
    assert got[0] == got[1]
    errors = got[0]
    jcfg = _jax_cfg(fixture_dataset, "siamese", NO_AUG + ["TRAINER.GRAD_ACCUM", "2"])
    jmodel, state = jax_train_lib.create_train_state(jcfg, jax.random.PRNGKey(0))
    mesh = data_mesh(jax.devices()[:WORLD])
    step = jax_train_lib.make_supervised_train_step(jmodel, jcfg, mesh=mesh)
    stack = world["cases"][0]["stack"][:2].numpy()
    with pytest.raises(ValueError) as jax_err:
        step(state, stack, np.ones(2, np.float32), jax.random.PRNGKey(0))
    want = str(jax_err.value)
    assert errors["accum"].startswith(want[:want.index("axis") + len("axis")])
    jcfg = _jax_cfg(fixture_dataset, "siamese",
                    ["MODEL.SYNC_BN", "False", "TRAINER.BATCH_SIZE", "3"])
    with pytest.raises(ValueError) as jax_err:
        jax_train_lib.bn_group_count(jcfg, mesh)
    assert errors["sync_bn"] == str(jax_err.value)
    assert errors["batch"] == (
        "TRAINER.BATCH_SIZE=3 is not divisible by the 2-device global mesh of "
        "this 2-process run; pick a divisible batch")


# --- the steps ----------------------------------------------------------------

@pytest.mark.parametrize("name", ["sup", "sup_accum"])
def test_step_matches_the_jax_mesh(world, name):
    """Sync-BN over the world: the supervised step, plain and with
    GRAD_ACCUM 2 (each micro-batch's share of one row per rank), equals the
    JAX package's GSPMD step on the 2-device mesh; both ranks hold the same
    summed gradients and buffers."""
    ranks = world["out"][name]
    _ranks_equal(ranks)
    _hold_step(ranks[0], world["jax"][name])
    _hold_step(world["one"][name], world["jax"][name])


def test_per_replica_bn_matches_jax_groups(world):
    """``MODEL.SYNC_BN: False``: each rank normalises over its own rows, as
    the JAX package's ``bn_groups = 2`` step does on the mesh, and the
    running statistics are rank 0's (group 0's) on both ranks; they differ
    from the synchronised step's."""
    ranks = world["out"]["sup_nosync"]
    _ranks_equal(ranks)
    _hold_step(ranks[0], world["jax"]["sup_nosync"])
    sync = world["out"]["sup"][0]["buffers"]
    assert max(float((ranks[0]["buffers"][k] - sync[k]).abs().max())
               for k in sync if k.endswith("running_var")) > 1e-4


def test_remat_step_reduces_in_the_recompute(world):
    """``MODEL.REMAT``: the recompute runs the forward's all-reduces again
    in the same order on both ranks; the step equals the JAX mesh's plain
    step, and its running statistics equal the plain world step's bit for
    bit (the recompute leaves them alone)."""
    ranks = world["out"]["sup_remat"]
    _ranks_equal(ranks)
    _hold_step(ranks[0], world["jax"]["sup"])
    for name, b in world["out"]["sup"][0]["buffers"].items():
        assert torch.equal(ranks[0]["buffers"][name], b), name


@pytest.mark.parametrize("name", ["dual", "semi"])
def test_multi_head_steps_match_jax_and_one_process(world, name):
    """Dual-task, and semi-supervised with the one labeled row on rank 0
    (rank 1 holds none: its supervised terms come from the world's gate,
    ``max(is_labeled)`` over the global batch): the world's step equals the
    JAX mesh step and the port's one-process step on the same global
    batch, every metric included (rel 1e-5)."""
    ranks = world["out"][name]
    _ranks_equal(ranks)
    _hold_step(ranks[0], world["jax"][name])
    one = world["one"][name]
    _hold_step(ranks[0], {"metrics": one["metrics"],
                          "grads": {k: v.numpy() for k, v in one["grads"].items()},
                          "stats": {k: v.numpy() for k, v in one["buffers"].items()
                                    if "running" in k}})
    for key, value in world["jax"][name]["metrics"].items():
        np.testing.assert_allclose(ranks[0]["metrics"][key], value, rtol=1e-5,
                                   atol=1e-7, err_msg=key)
    if name == "semi":
        assert ranks[0]["metrics"]["n_labeled"] == 1.0
        assert ranks[0]["metrics"]["sup_loss"] > 0 and ranks[0]["metrics"]["cons_loss"] > 0


@pytest.mark.parametrize("name", ["sup_aug", "diff"])
def test_augmentation_and_dropout_are_the_worlds_draws(world, name):
    """Flip and rot90 (``sup_aug``) and siamunet_diff's spatial dropout
    (``diff``): each rank applies its rows of the draws for the global
    batch, so the world's step equals the one-process step on the same
    batch (loss rel 1e-5, gradients rtol 1e-3 / atol 1e-5)."""
    ranks = world["out"][name]
    _ranks_equal(ranks)
    one = world["one"][name]
    _hold_step(ranks[0], {"metrics": one["metrics"],
                          "grads": {k: v.numpy() for k, v in one["grads"].items()}},
               stats=False)


# --- evaluation -----------------------------------------------------------------

def test_sharded_measurer_matches_jax_mesh(world):
    """``run_measurer`` over the validation split, scene groups sharded over
    the two ranks with zero-valid padding: every rank ends with the same
    counts, within 1.0 of the JAX mesh's sharded counts, and exactly the
    sum of the two shares counted in one process."""
    ranks = world["out"]["eval"]
    shares = world["one"]["shares"]
    for k in ("TP", "TN", "FP", "FN"):
        assert torch.equal(ranks[0][k], ranks[1][k]), k
        np.testing.assert_allclose(ranks[0][k].numpy(), world["jax"]["eval"][k],
                                   atol=1.0, err_msg=k)
        assert torch.equal(ranks[0][k], shares[0][k] + shares[1][k]), k
        np.testing.assert_allclose(ranks[0][k].numpy(),
                                   world["one"]["unsharded"][k].numpy(),
                                   atol=1.0, err_msg=k)
    assert ranks[0]["f1"] == ranks[1]["f1"]
    assert ranks[0]["launches"] == ranks[1]["launches"] == 0   # plain on the CPU


def test_sharded_dualtask_counts_match_jax_mesh(world):
    ranks = world["out"]["dual_eval"]
    for key in ("change", "change_sem", "sem"):
        assert torch.equal(ranks[0][key], ranks[1][key]), key
        np.testing.assert_allclose(ranks[0][key].numpy(),
                                   np.asarray(world["jax"]["dual_eval"][key]),
                                   atol=1.0, err_msg=key)


# --- the trainer ------------------------------------------------------------------

def _records(world, name) -> list:
    import json

    path = world["tmp"] / name / "logs" / "siamese.jsonl"
    return [r for r in map(json.loads, path.read_text().splitlines())
            if "_event" not in r]


def _hold_records(got: list, want: list) -> None:
    """Log records of one run against another's: the same keys in the same
    records, losses rel 1e-4 (after the first AdamW step both runs' roundoff
    on the pre-BN biases has been turned into lr-sized moves), F1,
    precision and recall atol 1e-3, steps and epochs equal."""
    assert [sorted(r) for r in got] == [sorted(r) for r in want]
    for g, w in zip(got, want):
        for key, value in w.items():
            if key == "loss":
                np.testing.assert_allclose(g[key], value, rtol=1e-4)
            elif key.endswith(("F1", "precision", "recall")):
                np.testing.assert_allclose(g[key], value, atol=1e-3)
            elif key in ("step", "epoch", "labeled_percentage"):
                assert g[key] == value


def test_run_training_over_two_ranks_matches_one_process(world):
    """``trainers.run_training`` in the world of two (augmentation on, 2
    steps of 4, LOG_FREQ 2, one checkpoint) logs from rank 0 alone the
    window and evaluations of the same run in one process
    (:func:`_hold_records`); rank 0 alone wrote the checkpoint."""
    _hold_records(_records(world, "train_world"), _records(world, "train_one"))
    ckpts = sorted((world["tmp"] / "train_world" / "networks").iterdir())
    assert [c.name for c in ckpts] == ["siamese_checkpoint1.pt"]
    assert world["out"]["train"][0]["launches"] == 0     # plain on the CPU


def test_torchrun_cli_trains_over_two_ranks(world):
    """The training CLI as a user starts it on several cards
    (``MSCD_DISTRIBUTED=1 torchrun --nproc_per_node=2 -m
    ...train_supervised``, here ``--device cpu`` over gloo): both ranks join
    through ``env://`` and report a world of two, rank 0 alone logs, and
    the log equals the one-process run's (:func:`_hold_records`); one
    checkpoint."""
    run = world["torchrun"]
    assert run.returncode == 0, run.stdout[-4000:] + run.stderr[-4000:]
    assert run.stdout.count("device        : cpu[2]") == WORLD
    assert run.stdout.count("[siamese] loss=") == 1
    _hold_records(_records(world, "torchrun"), _records(world, "train_one"))
    ckpts = sorted((world["tmp"] / "torchrun" / "networks").iterdir())
    assert [c.name for c in ckpts] == ["siamese_checkpoint1.pt"]
