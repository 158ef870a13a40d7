"""The port's height sharding (``TRAINER.SPATIAL_SHARDS``,
``multimodal_siamese_cd_tpu_torch.parallel.halo``) against the JAX
package's ``(data, space)`` mesh, on the CPU and the synthetic fixture
(``fixture_dataset``).

The port runs a real world of four processes over gloo
(``parallel.cluster_check.launch_cluster``, once for the module: every case
that needs the world goes into one job), on two grids: ``SPATIAL_SHARDS 2``
(data 2 x space 2) and ``SPATIAL_SHARDS 4`` (data 1 x space 4). The 32 px
crops of the 1 x 4 grid hold 8 rows a rank; at topology [8, 8, 8, 8] they
pool to 1 row at level 3, so level 4 does not split: the encoder makes its
input whole and the level runs redundantly on every space rank (so does
siamunet_diff's bottleneck there). The JAX side runs its jitted steps and
evaluations on ``data_space_mesh(n, jax.devices()[:4])`` (conftest gives 8
CPU devices) at fp32, ``PACKED_FULLRES False``, augmentation off where it
is compared; weights drawn with numpy and moved with
``weights.state_dict_from_jax``. Tolerances, each stated at its test:

* one step against the port's one-process step on the same global batch:
  loss rel 1e-5, gradients rtol 1e-3 / atol 1e-5, running statistics atol
  1e-5; the four ranks' gradients, parameters and buffers bit-equal;
* one step against the JAX mesh step: loss rel 1e-4, running statistics
  rtol 1e-3 / atol 1e-5 (the JAX package's own bounds for its 2-D mesh,
  tests/test_train_lib.py:180-207), gradients rtol 1e-3 / atol 1e-5;
* ``sharded_scene_probabilities``: rtol 1e-5 / atol 1e-6 against
  ``scene_probabilities`` and the JAX function (tests/test_train_lib.py:
  561-583);
* the grid's evaluation counts: atol 1.0 against the JAX mesh's, exact
  against the port's one-process counts;
* the halo exchange: its rows exact, its adjoint identity in float64 to
  rel 1e-12.
"""

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_siamese_cd_tpu import evaluation as jax_eval
from multimodal_siamese_cd_tpu import train_lib as jax_train_lib
from multimodal_siamese_cd_tpu.data.dataset import MultimodalCDDataset as JaxDataset
from multimodal_siamese_cd_tpu.models import create_network as jax_create_network
from multimodal_siamese_cd_tpu.parallel import data_mesh, data_space_mesh
from multimodal_siamese_cd_tpu_torch import checkpoints, evaluation, wandb_compat
from multimodal_siamese_cd_tpu_torch.parallel import cluster_check
from multimodal_siamese_cd_tpu_torch.weights import state_dict_from_jax
from test_torch_port_parallel import (BASE, NO_AUG, SEMI_LABELED, _global_batch,
                                      _GradState, _hold_records, _hold_step,
                                      _jax_cfg, _ranks_equal, _records)
from test_torch_port_siamunet_diff import _NoDropout
from test_torch_port_train import _random_variables, _sd

torch.set_num_threads(1)

WORLD = 4
# the launch of the world of four, every case included (~30 s here)
LAUNCH_TIMEOUT = 300
DEEP = ["MODEL.TOPOLOGY", "[8, 8, 8, 8]"]
GRID2, GRID4 = ["TRAINER.SPATIAL_SHARDS", "2"], ["TRAINER.SPATIAL_SHARDS", "4"]
# name: (config, regime, grid overrides, extra overrides, the JAX mesh step
# it is held against (its name in JAX_STEPS) or None, dropout)
STEPS = {
    "sup4": ("siamese", "supervised", GRID4, NO_AUG + DEEP, "sup4", True),
    "remat4": ("siamese", "supervised", GRID4,
               NO_AUG + DEEP + ["MODEL.REMAT", "True"], "sup4", True),
    "nosync2": ("siamese", "supervised", GRID2, NO_AUG + ["MODEL.SYNC_BN", "False"],
                "nosync2", True),
    "nosync4": ("siamese", "supervised", GRID4,
                NO_AUG + DEEP + ["MODEL.SYNC_BN", "False"], "sup4", True),
    "accum2": ("siamese", "supervised", GRID2, NO_AUG + ["TRAINER.GRAD_ACCUM", "2"],
               "accum2", True),
    "dual2": ("dtsiamese", "dualtask", GRID2, NO_AUG, "dual2", True),
    "semi2": ("siamese_mmcr_alpha0500", "semisupervised", GRID2, NO_AUG, "semi2",
              True),
    "diff4": ("siamese", "supervised", GRID4,
              NO_AUG + ["MODEL.TYPE", "siamunet_diff"], "diff4", False),
    # held against the one-process step alone: the plain and REMAT steps on
    # 2 x 2, augmentation and dropout on (the world's draws), and the
    # factory's other models (from the factory's seeded weights, MODEL_CASES)
    "sup2": ("siamese", "supervised", GRID2, NO_AUG, None, True),
    "remat2": ("siamese", "supervised", GRID2, NO_AUG + ["MODEL.REMAT", "True"],
               None, True),
    "aug2": ("siamese", "supervised", GRID2, [], None, True),
    "diff2": ("siamese", "supervised", GRID2, ["MODEL.TYPE", "siamunet_diff"], None,
              True),
    "unet4": ("siamese", "supervised", GRID4, NO_AUG + DEEP + ["MODEL.TYPE", "unet"],
              None, True),
    "dualstream4": ("siamese", "supervised", GRID4,
                    NO_AUG + DEEP + ["MODEL.TYPE", "dualstreamunet"], None, True),
    "whatever2_4": ("siamese_mmcr_alpha0500", "semisupervised", GRID4,
                    NO_AUG + DEEP + ["MODEL.TYPE", "whatevernet2"], None, True),
}
# the cases that start from the port factory's weights drawn from cfg.SEED
# (moved into flax by the JAX package's torch_port where JAX runs them): on
# _random_variables' weights the float32 gradients of unet and siamunet_diff
# on the fixture are ill-conditioned in one process already (reversing the
# order of the batch's rows moves them past the bound)
MODEL_CASES = ("diff4", "diff2", "unet4", "dualstream4", "whatever2_4")
# the JAX mesh steps (each on the config of the case of its name) and their
# SPATIAL_SHARDS
JAX_STEPS = {"sup4": 4, "nosync2": 2, "accum2": 2, "dual2": 2, "semi2": 2,
             "diff4": 4}
JAX_REGIMES = {"siameseunet": "supervised", "dtsiameseunet": "dualtask",
               "whatevernet": "semisupervised", "siamunet_diff": "supervised"}


def _jax_step(jcfg, jmodel, variables, batch, n_space) -> dict:
    """One jitted step on the ``(4 / n_space, n_space)`` mesh: metrics,
    gradients and running statistics, torch-named."""
    tree = jax.tree_util.tree_map(jnp.asarray, variables)
    state = _GradState.create(apply_fn=jmodel.apply, params=tree["params"],
                              tx=jax_train_lib.make_optimizer(jcfg),
                              batch_stats=tree["batch_stats"])
    mesh = data_space_mesh(n_space, jax.devices()[:WORLD])
    step = jax_train_lib.make_train_step(jmodel, jcfg, JAX_REGIMES[jcfg.MODEL.TYPE],
                                         mesh=mesh)
    new, aux = step(state, batch["stack"], batch["is_labeled"], jax.random.PRNGKey(0))
    return {"metrics": {k: float(v) for k, v in aux.items()},
            "grads": _sd(jax.device_get(new.grads), "params"),
            "stats": _sd(jax.device_get(new.batch_stats), "batch_stats")}


def _factory_state(config, overrides) -> dict:
    """The port factory's weights drawn from ``cfg.SEED``."""
    from multimodal_siamese_cd_tpu_torch.models.factory import create_network

    cfg = cluster_check.case_cfg({"config": config, "overrides": BASE + overrides})
    return create_network(cfg, device="cpu", generator=torch.Generator().manual_seed(
        cfg.SEED)).state_dict()


def _flax_variables(state: dict, jmodel, jcfg):
    """A port state dict as flax variables (the JAX package's ``torch_port``
    converters)."""
    from multimodal_siamese_cd_tpu import torch_port
    from multimodal_siamese_cd_tpu.models import init_variables

    port = (torch_port.port_siamunet_diff_state_dict
            if jcfg.MODEL.TYPE == "siamunet_diff"
            else torch_port.port_reference_state_dict)
    template = jax.eval_shape(
        lambda: init_variables(jmodel, jcfg, jax.random.PRNGKey(0)))
    return jax.device_get(port(state, template))


def _weights_key(jcfg) -> tuple:
    return jcfg.MODEL.TYPE, tuple(jcfg.MODEL.TOPOLOGY)


def _jax_eval(root, weights, name: str):
    """The JAX package's side of an evaluation case, on the cases' weights:
    ``probs4`` / ``probs3`` its sharded scene probabilities of the first
    validation scene over 4 devices at depth 4 and over 3 at depth 2 (as
    its own test: the lcm re-pad changes the zero border below the scene,
    which a depth-4 receptive field reaches from the scene's last rows),
    ``eval`` its counts on the 2 x 2 mesh."""
    jcfg = _jax_cfg(root, "siamese", NO_AUG + (DEEP if name == "probs4" else []))
    jmodel, state = jax_train_lib.create_train_state(jcfg, jax.random.PRNGKey(0))
    w = weights[_weights_key(jcfg)]
    state = state.replace(params=w["params"], batch_stats=w["batch_stats"])
    ds = JaxDataset(jcfg, "validation", no_augmentations=True,
                    dataset_mode="first_last", disable_multiplier=True,
                    disable_unlabeled=True)
    if name.startswith("probs"):
        return {name: jax_eval.sharded_scene_probabilities(
            jmodel, state, ds[0], data_mesh(jax.devices()[:int(name[-1])]))}
    m = jax_eval.run_measurer(jmodel, state, ds, np.array([0.5]),
                              mesh=data_space_mesh(2, jax.devices()[:WORLD]))
    return {"eval": {k: np.asarray(getattr(m, k), np.float64)
                     for k in ("TP", "TN", "FP", "FN")}}


def _one_process(cases: list, trains: list) -> dict:
    """The port's one-process results of the step and count cases, and its
    runs of the train cases (each logged to its own output)."""
    one = {c["name"]: cluster_check.run_case(c) for c in cases
           if c["kind"] in ("step", "measurer", "dualtask_counts")}
    for train in trains:
        try:
            cluster_check.run_case(train)
        finally:
            wandb_compat.finish()
    return one


@pytest.fixture(scope="module")
def space(fixture_dataset, tmp_path_factory):
    """Every case's inputs, the world of four's results (``out[name][rank]``),
    the one-process results (``one[name]``) and the JAX mesh's
    (``jax[name]``)."""
    root = str(fixture_dataset)
    paths = {"DATASET": root}
    cases, jax_args, weights, batches = [], {}, {}, {}
    for name, (config, regime, grid, overrides, _, dropout) in STEPS.items():
        jcfg = _jax_cfg(root, config, overrides)
        jmodel = jax_create_network(jcfg)
        if name in MODEL_CASES:
            state = _factory_state(config, overrides)
            variables = (_flax_variables(state, jmodel, jcfg) if name in JAX_STEPS
                         else None)
        else:
            if _weights_key(jcfg) not in weights:
                weights[_weights_key(jcfg)] = _random_variables(jmodel, jcfg)
            variables = weights[_weights_key(jcfg)]
            state = state_dict_from_jax(variables)
        # the loader's crops depend on the config's data keys alone
        if config not in batches:
            batches[config] = dict(_global_batch(root, config, []))
        batch = dict(batches[config])
        if regime == "semisupervised":
            batch["is_labeled"] = np.asarray(SEMI_LABELED, np.float32)
        if name in JAX_STEPS:
            jax_args[name] = (jcfg, jmodel, variables, batch, JAX_STEPS[name])
        cases.append(dict(name=name, kind="step", config=config,
                          overrides=BASE + grid + overrides, paths=paths,
                          regime=regime, dropout=dropout, state=state,
                          stack=torch.from_numpy(batch["stack"]),
                          is_labeled=torch.from_numpy(batch["is_labeled"])))
    steps = {c["name"]: c for c in cases}
    gen = torch.Generator().manual_seed(0)
    cases += [
        dict(name="halo2", kind="halo", space=2, halos=[(1, 1), (0, 1), (2, 1)],
             x=torch.randn((2, 2, 3, 8, 5), generator=gen, dtype=torch.float64)),
        dict(name="halo4", kind="halo", space=4, halos=[(1, 1), (0, 1)],
             x=torch.randn((1, 2, 3, 8, 5), generator=gen, dtype=torch.float64)),
        dict(name="probs4", kind="scene_probs", config="siamese", paths=paths,
             overrides=steps["sup4"]["overrides"], state=steps["sup4"]["state"]),
        dict(name="probs3", kind="scene_probs", config="siamese", paths=paths,
             overrides=steps["sup2"]["overrides"], state=steps["sup2"]["state"],
             ranks=[0, 1, 2]),
        dict(name="eval", kind="measurer", config="siamese", paths=paths,
             overrides=steps["sup2"]["overrides"], state=steps["sup2"]["state"]),
        dict(name="dual_eval", kind="dualtask_counts", config="dtsiamese",
             paths=paths, overrides=steps["dual2"]["overrides"],
             state=steps["dual2"]["state"]),
    ]
    tmp = tmp_path_factory.mktemp("space")
    train_overrides = BASE + GRID2 + ["DATALOADER.TRAINING_MULTIPLIER", "4",
                                      "LOG_FREQ", "2", "TRAINER.EPOCHS", "1",
                                      "SAVE_CHECKPOINTS", "[1]"]
    cases.append(dict(name="train_debug", kind="train", config="siamese",
                      overrides=BASE + GRID2 + ["DEBUG", "True", "TRAINER.EPOCHS", "1"],
                      regime="supervised",
                      paths={"DATASET": root, "OUTPUT": str(tmp / "debug_world")}))
    cases.append(dict(name="train", kind="train", config="siamese",
                      overrides=train_overrides, regime="supervised",
                      paths={"DATASET": root, "OUTPUT": str(tmp / "train_world")}))

    # the world runs in its own processes while this one runs the JAX side
    pool = ThreadPoolExecutor(2)
    launch = pool.submit(cluster_check.launch_cluster,
                         {"device": "cpu", "backend": "gloo", "cases": cases},
                         tmp / "out", world=WORLD, timeout=LAUNCH_TIMEOUT)
    one_trains = [dict(c, paths={"DATASET": root, "OUTPUT": str(tmp / out)})
                  for c, out in zip(cases[-2:], ("debug_one", "train_one"))]
    one_process = pool.submit(_one_process, cases[:-2], one_trains)
    pool.shutdown(wait=False)
    with pytest.MonkeyPatch.context() as mp:    # siamunet_diff without dropout
        import flax.linen

        mp.setattr(flax.linen, "Dropout", _NoDropout)
        # XLA compiles outside the GIL: the JAX steps and evaluations overlap
        with ThreadPoolExecutor(6) as jpool:
            evals = [jpool.submit(_jax_eval, root, weights, k)
                     for k in ("eval", "probs4", "probs3")]
            futs = {name: jpool.submit(_jax_step, *args)
                    for name, args in jax_args.items()}
            jax_side = {name: f.result() for name, f in futs.items()}
            for f in evals:
                jax_side.update(f.result())

    one = one_process.result()
    rcs, outs = launch.result()

    assert rcs == [0] * WORLD, "\n".join(o + e[-4000:] for o, e in outs)
    out = {c["name"]: [torch.load(tmp / "out" / f"{c['name']}.rank{r}.pt",
                                  weights_only=False) for r in range(WORLD)]
           for c in cases}
    return dict(out=out, one=one, jax=jax_side, tmp=tmp,
                cases={c["name"]: c for c in cases})


def _one(result: dict) -> dict:
    """A one-process step result in :func:`_hold_step`'s reference layout."""
    return {"metrics": result["metrics"],
            "grads": {k: v.numpy() for k, v in result["grads"].items()},
            "stats": {k: v.numpy() for k, v in result["buffers"].items()
                      if "running" in k}}


def _hold_jax(got: dict, want: dict, grads: bool = True) -> None:
    """One world step against the JAX mesh step: loss rel 1e-4, gradients
    rtol 1e-3 / atol 1e-5, running statistics rtol 1e-3 / atol 1e-5."""
    np.testing.assert_allclose(got["metrics"]["loss"], want["metrics"]["loss"],
                               rtol=1e-4)
    for name, g in got["grads"].items() if grads else ():
        np.testing.assert_allclose(g.numpy(), want["grads"][name], rtol=1e-3,
                                   atol=1e-5, err_msg=name)
    for name, s in want["stats"].items():
        np.testing.assert_allclose(got["buffers"][name].numpy(), s, rtol=1e-3,
                                   atol=1e-5, err_msg=name)


# --- the grid -------------------------------------------------------------------

@pytest.mark.parametrize("world,n", [(4, 2), (4, 4), (8, 2), (2, 2)])
def test_grid_indices_are_the_jax_mesh_layout(world, n, monkeypatch):
    """Rank ``r`` sits at data ``r // n``, space ``r % n``: the device at
    that place of the JAX package's ``data_space_mesh(n)`` grid."""
    from multimodal_siamese_cd_tpu_torch.parallel import group

    devices = jax.devices()[:world]
    mesh = data_space_mesh(n, devices)
    monkeypatch.setattr(group, "world_size", lambda: world)
    monkeypatch.setattr(group, "_columns", {n: [None] * (world // n)})
    for r, device in enumerate(devices):
        monkeypatch.setattr(group, "rank", lambda r=r: r)
        g = group.grid(n)
        assert mesh.devices[g.data_index, g.space_index] == device
        assert (g.data_size, g.space_size) == (mesh.shape["data"], mesh.shape["space"])


@pytest.mark.parametrize("world,n,batch,crop", [(4, 2, 4, 32), (4, 4, 4, 32),
                                                (4, 3, 4, 32), (4, 2, 3, 32),
                                                (4, 4, 4, 30), (1, 2, 4, 32),
                                                (8, 4, 6, 32)])
def test_space_shards_follow_the_jax_rule(world, n, batch, crop, fixture_dataset):
    """``space_shards`` accepts exactly the grids the JAX package's
    ``_training_mesh`` accepts (trainers.py:55-66)."""
    from multimodal_siamese_cd_tpu_torch.parallel import group

    cfg = cluster_check.case_cfg({"config": "siamese", "overrides": BASE + [
        "TRAINER.SPATIAL_SHARDS", str(n), "TRAINER.BATCH_SIZE", str(batch),
        "AUGMENTATION.CROP_SIZE", str(crop)]})
    jax_ok = world % n == 0 and batch % (world // n) == 0 and crop % n == 0
    assert group.space_shards(cfg, world) == (n if jax_ok else 1)


# --- the halo exchange ------------------------------------------------------------

@pytest.mark.parametrize("name", ["halo2", "halo4"])
def test_halo_rows_are_the_neighbours_and_zeros_at_the_edges(space, name):
    """Each rank's halo is its neighbours' edge rows (exact), zeros above
    the first and below the last space rank of its column, and columns do
    not mix."""
    ranks, x_all = space["out"][name], space["cases"][name]["x"]
    n = space["cases"][name]["space"]
    for r, res in enumerate(ranks):
        d, i = divmod(r, n)
        x = x_all[d]
        rows = res["rows"]
        padded = torch.nn.functional.pad(x, (0, 0, 8, 8))   # zeros past the edges
        for key, got in res.items():
            if not isinstance(key, tuple):
                continue
            top, bottom = key
            want = padded[:, :, 8 + i * rows - top:8 + (i + 1) * rows + bottom]
            assert torch.equal(got["out"], want), (name, r, key)
        assert torch.equal(res["whole"]["out"], x), (name, r)


@pytest.mark.parametrize("name", ["halo2", "halo4"])
def test_halo_backward_is_the_adjoint(space, name):
    """``<halo(x), y> == <x, halo*(y)>`` summed over the ranks, in float64
    (rel 1e-12), for every (top, bottom) and for ``whole``; and each rank's
    ``halo*(y)`` is its rows of the transpose applied to the world's ``y``:
    its own rows of ``y`` plus the rows its neighbours attached."""
    ranks = space["out"][name]
    n = space["cases"][name]["space"]
    keys = [k for k in ranks[0] if k != "rows"]
    for key in keys:
        inner = sum(r[key]["inner"] for r in ranks)
        adjoint = sum(r[key]["adjoint"] for r in ranks)
        np.testing.assert_allclose(adjoint, inner, rtol=1e-12, err_msg=str(key))
        if key == "whole":
            continue
        top, bottom = key
        rows = ranks[0]["rows"]
        for r, res in enumerate(ranks):
            d, i = divmod(r, n)
            want = res[key]["y"][:, :, top:top + rows].clone()
            if i > 0:       # the rank above attached my first rows below it
                above = ranks[r - 1][key]["y"]
                want[:, :, :bottom] += above[:, :, top + rows:]
            if i < n - 1:   # the rank below attached my last rows above it
                below = ranks[r + 1][key]["y"]
                want[:, :, rows - top:] += below[:, :, :top]
            torch.testing.assert_close(res[key]["grad"], want, rtol=1e-12, atol=0)


# --- the steps --------------------------------------------------------------------

@pytest.mark.parametrize("name", [n for n, s in STEPS.items()
                                  if s[4] is not None and n != "accum2"])
def test_step_matches_the_jax_mesh_and_one_process(space, name):
    """The step on the grid (1 x 4 at depth 4, whose level 4 does not split:
    supervised plain, REMAT, SYNC_BN False, and siamunet_diff without
    dropout, whose bottleneck does not split; 2 x 2: SYNC_BN False,
    dual-task, semi-supervised with its one labeled row on column 0) equals
    the JAX package's step on the ``data_space_mesh`` of the same shape,
    every metric included, and every case but SYNC_BN False on 2 x 2
    (per-column statistics) equals the port's one-process step on the same
    global batch; the four ranks hold the same gradients, parameters and
    buffers. (siamunet_diff is held on 1 x 4: the JAX package's 2 x 2 step
    of it takes gradients that its single-device, 1-D and 1 x 4 steps, and
    the port, do not.)"""
    ranks = space["out"][name]
    _ranks_equal(ranks)
    _hold_jax(ranks[0], space["jax"][STEPS[name][4]])
    if name != "nosync2":
        _hold_step(ranks[0], _one(space["one"][name]))
    for key, value in space["jax"][STEPS[name][4]]["metrics"].items():
        np.testing.assert_allclose(ranks[0]["metrics"][key], value, rtol=1e-4,
                                   atol=1e-7, err_msg=key)


def test_grad_accum_matches_one_process_and_the_jax_mesh_but_its_gradients(space):
    """``GRAD_ACCUM 2`` on 2 x 2 (each micro-batch split over the data axis
    alone): the grid's step equals the port's one-process step (so the JAX
    package's single-device and 1-D mesh steps, which its tests hold it
    to), and the JAX 2 x 2 mesh step in loss, running statistics and every
    gradient but the 3x3 convolutions' kernels: that step's are twice the
    single-device ones (a fault of the JAX package's 2-D mesh under
    GRAD_ACCUM with a data axis of 2 or more, which its 1 x n and 1-D
    meshes do not show; AdamW, nearly invariant to the scale, hides it),
    and they are held at twice the grid's here."""
    ranks, want = space["out"]["accum2"], space["jax"]["accum2"]
    _ranks_equal(ranks)
    _hold_step(ranks[0], _one(space["one"]["accum2"]))
    halved = {k: g / 2 if g.ndim == 4 and g.shape[2:] == (3, 3) else g
              for k, g in want["grads"].items()}
    _hold_jax(ranks[0], {"metrics": want["metrics"], "grads": halved,
                         "stats": want["stats"]})


@pytest.mark.parametrize("name", ["remat2", "remat4"])
def test_remat_repeats_the_exchanges_and_leaves_the_statistics(space, name):
    """``MODEL.REMAT``: the recompute repeats the halo exchanges and the
    BatchNorm all-reduces in the same order on every rank (the world ends),
    and the running statistics equal the plain grid step's bit for bit."""
    plain = space["out"]["sup" + name[-1]][0]["buffers"]
    for name_, b in plain.items():
        assert torch.equal(space["out"][name][0]["buffers"][name_], b), name_


def test_per_column_bn_differs_from_sync_bn(space):
    """``SYNC_BN: False`` on 2 x 2: each data column's space ranks share
    statistics (the JAX package's ``bn_group_count`` follows the data axis),
    which differ from the synchronised step's; on 1 x 4 the one column is
    the whole batch, the synchronised step bit for bit."""
    nosync = space["out"]["nosync2"][0]["buffers"]
    sync = space["out"]["sup2"][0]["buffers"]
    assert max(float((nosync[k] - sync[k]).abs().max())
               for k in sync if k.endswith("running_var")) > 1e-4
    for k, b in space["out"]["sup4"][0]["buffers"].items():
        assert torch.equal(space["out"]["nosync4"][0]["buffers"][k], b), k


@pytest.mark.parametrize("name", [n for n, s in STEPS.items() if s[4] is None])
def test_steps_and_models_on_the_grid_match_one_process(space, name):
    """The supervised step on 2 x 2, plain and with REMAT, flip and rot90 on
    the full crops before the height is split (``aug2``), siamunet_diff's
    spatial dropout with the same mask on every space rank of a column
    (``diff2``), and the factory's other models (unet, dualstreamunet,
    whatevernet2 at depth 4 on 1 x 4): the grid's step equals the
    one-process step on the same batch."""
    ranks = space["out"][name]
    _ranks_equal(ranks)
    _hold_step(ranks[0], _one(space["one"][name]))


# --- evaluation -------------------------------------------------------------------

@pytest.mark.parametrize("name", ["probs4", "probs3"])
def test_sharded_scene_probabilities_match(space, name):
    """``sharded_scene_probabilities`` over the four ranks, and over three
    (a process group of ranks 0-2: the 64-padded height does not divide, so
    the height is padded to a multiple of lcm(64, 3)), equals
    ``scene_probabilities`` and the JAX function on the same weights (rtol
    1e-5, atol 1e-6), the same on every rank."""
    ranks = [r for r in space["out"][name] if r]
    assert len(ranks) == (4 if name == "probs4" else 3)
    case = space["cases"][name]
    cfg = cluster_check.case_cfg(case)
    model, _ = cluster_check._model(case, cfg, "cpu")
    item = cluster_check._eval_dataset(case, cfg)[0]
    single = evaluation.scene_probabilities(model, item, device="cpu")
    for res in ranks:
        got = res["probs"][0].numpy()
        assert got.shape == single.shape
        np.testing.assert_allclose(got, single, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got, np.asarray(space["jax"][name]), rtol=1e-5,
                                   atol=1e-6)
        assert np.array_equal(got, ranks[0]["probs"][0].numpy())


def test_grid_counts_match_jax_mesh_and_one_process(space):
    """``run_measurer`` on the 2 x 2 grid (groups over the columns, heights
    over the space ranks): every rank ends with the same counts, exactly the
    one-process counts, within 1.0 of the JAX 2-D mesh's."""
    ranks, one = space["out"]["eval"], space["one"]["eval"]
    for k in ("TP", "TN", "FP", "FN"):
        for res in ranks[1:]:
            assert torch.equal(ranks[0][k], res[k]), k
        assert torch.equal(ranks[0][k], one[k]), k
        np.testing.assert_allclose(ranks[0][k].numpy(), space["jax"]["eval"][k],
                                   atol=1.0, err_msg=k)
    assert ranks[0]["launches"] == 0       # plain on the CPU


def test_grid_dualtask_counts_match_one_process(space):
    """``dualtask_quantitative_counts`` on the 2 x 2 grid: every rank ends
    with exactly the one-process counts (which
    tests/test_torch_port_dualtask.py holds against the JAX package's)."""
    ranks, one = space["out"]["dual_eval"], space["one"]["dual_eval"]
    for key in ("change", "change_sem", "sem"):
        for res in ranks:
            assert torch.equal(res[key], one[key]), key


# --- the trainer ------------------------------------------------------------------

def test_debug_run_training_on_the_grid_matches_one_process(space):
    """A DEBUG ``run_training`` with ``SPATIAL_SHARDS 2`` on the world of four
    (the JAX package's test_spatial_shards_trainer_end_to_end: loader ->
    one height-sharded step -> the grid's test evaluation -> the epoch's
    evaluations) logs from rank 0 the evaluations of the same run in one
    process, and saves no checkpoint (DEBUG, as the reference)."""
    got, want = (_records({"tmp": space["tmp"]}, name)
                 for name in ("debug_world", "debug_one"))
    assert [r["step"] for r in got] == [1] * 4
    _hold_records(got, want)
    assert not (space["tmp"] / "debug_world" / "networks").exists()


def test_run_training_on_the_grid_matches_one_process(space):
    """``trainers.run_training`` with ``SPATIAL_SHARDS 2`` on the world of
    four (loader of each column's rows -> height-sharded steps -> grid
    evaluations -> checkpoint; augmentation on, 2 steps of 4, LOG_FREQ 2)
    logs from rank 0 the windows and evaluations of the same run in one
    process; rank 0's checkpoint loads in one process and holds the weights
    of the one-process run's within two AdamW steps of roundoff: 2.5 lr
    (AdamW's first steps move a weight by about lr each, in a direction
    roundoff decides where its gradient is near 0)."""
    world_dir, one_dir = space["tmp"] / "train_world", space["tmp"] / "train_one"
    _hold_records(_records({"tmp": space["tmp"]}, "train_world"),
                  _records({"tmp": space["tmp"]}, "train_one"))
    ckpts = sorted((world_dir / "networks").iterdir())
    assert [c.name for c in ckpts] == ["siamese_checkpoint1.pt"]
    cfg = cluster_check.case_cfg(space["cases"]["train"])
    model, _, step = checkpoints.load_checkpoint(None, cfg, net_file=ckpts[0],
                                                 device="cpu")
    ref, _, ref_step = checkpoints.load_checkpoint(
        None, cfg, net_file=one_dir / "networks" / "siamese_checkpoint1.pt",
        device="cpu")
    assert step == ref_step == 2
    theirs = ref.state_dict()
    for name, p in model.state_dict().items():
        torch.testing.assert_close(p, theirs[name], rtol=0,
                                   atol=2.5 * cfg.TRAINER.LR, msg=name)
