"""A multi-step training trajectory of the port held against the JAX
package's, on the CPU, against the port's own chaos floor.

Both packages train siameseunet for 24 steps from the same weights (drawn
with numpy as in ``test_torch_port_train``, moved with
``weights.state_dict_from_jax``) on the same loader batches (the JAX
package's ``TrainLoader``, whose batches the port's equals byte for byte:
``test_torch_port_train::test_train_loader_matches_jax``): topology [8, 16],
32 px crops, batch 4, fp32, ``MODEL.PACKED_FULLRES False``, flips and
rotations off (the packages draw different random streams). Every 8 steps
the runs' losses of those 8 steps and their validation F1 at threshold 0.5
(``inference_loop`` over the fixture's validation scene) are compared.

Training is chaotic: float32 roundoff differs between the packages and
grows over the steps. The yardstick is the port against itself with one
weight perturbed by 1e-6 (the stem's first kernel entry), run in the same
test: its largest difference in each 8-step window (the window's 8 losses;
the validation F1 at the window's end) is that window's chaos floor, so
early windows are held to early divergence. The JAX package's largest
difference from the port in the window must stay within the metric's
multiple of that floor (``CHAOS_MULTIPLE``). LR is 1e-3: at the config's
1e-4, 24 steps move the validation F1 by less than one pixel's worth and
the floor reads 0. The multiples come from the ratios measured on the CPU,
with about four times room: in loss the JAX package's difference is 1, 24
and 53 times the window's floor (roundoff in every operation of every step
against one perturbed weight, compounding), in F1 1.1, 1.5 and 1.7 times.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_siamese_cd_tpu import evaluation as jax_eval
from multimodal_siamese_cd_tpu import train_lib as jax_train_lib
from multimodal_siamese_cd_tpu.config import load_cfg as jax_load_cfg
from multimodal_siamese_cd_tpu.data.dataset import MultimodalCDDataset as JaxDataset
from multimodal_siamese_cd_tpu.data.loader import TrainLoader as JaxTrainLoader
from multimodal_siamese_cd_tpu.data.synthetic import fixture_cfg_overrides
from multimodal_siamese_cd_tpu.models import create_network as jax_create_network
from multimodal_siamese_cd_tpu_torch import evaluation, train_lib
from multimodal_siamese_cd_tpu_torch.config import load_cfg
from multimodal_siamese_cd_tpu_torch.data.dataset import MultimodalCDDataset
from multimodal_siamese_cd_tpu_torch.models.factory import create_network
from multimodal_siamese_cd_tpu_torch.weights import state_dict_from_jax
from test_torch_port_train import _random_variables

torch.set_num_threads(1)

STEPS, EVERY, BATCH, CROP = 24, 8, 4, 32
PERTURBATION = 1e-6
CHAOS_MULTIPLE = {"loss": 200, "validation F1": 5}
METRICS = list(CHAOS_MULTIPLE)


def _cfgs(root):
    out = []
    for loader in (jax_load_cfg, load_cfg):
        cfg = loader("siamese")
        cfg.merge_from_list(fixture_cfg_overrides() + [
            "AUGMENTATION.RANDOM_FLIP", "False", "AUGMENTATION.RANDOM_ROTATE", "False"])
        cfg.PATHS.DATASET = str(root)
        cfg.MODEL.TOPOLOGY = [8, 16]
        cfg.TRAINER.PRECISION = "fp32"
        cfg.TRAINER.BATCH_SIZE = BATCH
        cfg.TRAINER.LR = 1e-3
        cfg.AUGMENTATION.CROP_SIZE = CROP
        cfg.MODEL.PACKED_FULLRES = False
        out.append(cfg)
    return out


def _eval_dataset(cls, cfg):
    return cls(cfg, "validation", no_augmentations=True, dataset_mode="first_last",
               disable_multiplier=True, disable_unlabeled=True)


def _jax_run(jcfg, jmodel, variables, batches) -> list:
    state = jax_train_lib.create_train_state(jcfg, jax.random.PRNGKey(0))[1]
    state = state.replace(params=variables["params"],
                          batch_stats=variables["batch_stats"],
                          opt_state=state.tx.init(variables["params"]))
    step = jax_train_lib.make_supervised_train_step(jmodel, jcfg)
    ds = _eval_dataset(JaxDataset, jcfg)
    losses, f1s = [], []
    for i, batch in enumerate(batches):
        state, aux = step(state, jnp.asarray(batch["stack"]),
                          jnp.asarray(batch["is_labeled"]), jax.random.PRNGKey(0))
        losses.append(float(aux["loss"]))
        if (i + 1) % EVERY == 0:
            f1s.append(float(jax_eval.inference_loop(jmodel, state, ds)["change"][0]))
    return losses, f1s


def _port_run(tcfg, variables, batches, perturbation: float = 0.0) -> list:
    model = create_network(tcfg, device="cpu")
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    with torch.no_grad():
        model.inc.conv.conv[0].weight.view(-1)[0] += perturbation
    optimizer = train_lib.make_optimizer(model, tcfg)
    step = train_lib.make_supervised_train_step(model, optimizer, tcfg)
    ds = _eval_dataset(MultimodalCDDataset, tcfg)
    losses, f1s = [], []
    for i, batch in enumerate(batches):
        got = step(torch.from_numpy(batch["stack"]),
                   torch.from_numpy(batch["is_labeled"]), i)
        losses.append(float(got["loss"]))
        if (i + 1) % EVERY == 0:
            f1s.append(float(evaluation.inference_loop(model, ds, device="cpu")["change"][0]))
    return losses, f1s


@pytest.fixture(scope="module")
def trajectories(fixture_dataset):
    jcfg, tcfg = _cfgs(fixture_dataset)
    jmodel = jax_create_network(jcfg)
    variables = _random_variables(jmodel, jcfg)
    ds = JaxDataset(jcfg, "training", return_stack=True, crop_only=True)
    batches, epoch = [], 0
    while len(batches) < STEPS:
        loader = JaxTrainLoader(ds, batch_size=BATCH, num_workers=0, seed=5)
        loader.set_epoch(epoch)
        batches += list(loader)
        epoch += 1
    batches = batches[:STEPS]
    jax_out = _jax_run(jcfg, jmodel, variables, batches)
    port = _port_run(tcfg, variables, batches)
    perturbed = _port_run(tcfg, variables, batches, PERTURBATION)
    print(f"\nlosses JAX {jax_out[0]}\nport {port[0]}\nperturbed {perturbed[0]}\n"
          f"validation F1 at steps 8, 16, 24: JAX {jax_out[1]}, port {port[1]}, "
          f"perturbed {perturbed[1]}")
    return types.SimpleNamespace(jax=jax_out, port=port, perturbed=perturbed)


def _window(metric: str, checkpoint: int) -> slice:
    """The window's entries of the metric's list: its 8 losses, or the
    validation F1 at its end."""
    if metric == "loss":
        return slice(EVERY * checkpoint, EVERY * (checkpoint + 1))
    return slice(checkpoint, checkpoint + 1)


def _largest_difference(a: list, b: list, window: slice) -> float:
    return max(abs(x - y) for x, y in zip(a[window], b[window]))


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("checkpoint", range(STEPS // EVERY))
def test_trajectory_within_chaos_multiple(trajectories, checkpoint, metric):
    """|JAX - port| in the window of steps 1-8, 9-16 or 17-24 <=
    CHAOS_MULTIPLE[metric] x the port's chaos floor in that window."""
    t = trajectories
    m = METRICS.index(metric)
    window = _window(metric, checkpoint)
    floor = _largest_difference(t.port[m], t.perturbed[m], window)
    diff = _largest_difference(t.jax[m], t.port[m], window)
    print(f"steps {EVERY * checkpoint + 1}-{EVERY * (checkpoint + 1)} {metric}: "
          f"|JAX - port| {diff:.3g}, chaos floor {floor:.3g}, ratio "
          f"{diff / floor if floor else float('inf'):.3g} (limit "
          f"{CHAOS_MULTIPLE[metric]} x floor)")
    assert floor > 0, f"the 1e-6 perturbation moved no {metric}: no floor to hold to"
    assert diff <= CHAOS_MULTIPLE[metric] * floor


def test_trajectory_learns(trajectories):
    """The run moves: the window loss falls and the port's validation F1
    changes over the 24 steps (else the comparison above holds nothing)."""
    losses, f1s = trajectories.port
    assert np.mean(losses[-EVERY:]) < np.mean(losses[:EVERY])
    assert f1s[-1] != f1s[0]
