"""The port's collective counts (``multimodal_siamese_cd_tpu_torch.
model_scaling``) against the step's shapes and the JAX package's
``tools/model_scaling.py``, on the CPU.

Worlds of 2 and 4 gloo processes take one step of each regime at topology
[8, 16], 32 px crops, 2 rows a rank, through ``model_scaling.main`` (the
step time given, as the CPU needs). Every count is exact (the counts
depend on the shapes alone):

* the gradient all-reduce moves 4 × ``param_count`` bytes;
* sync-BN moves ``2C`` float32 sums for every BatchNorm call of the
  forward and of the backward: 2 × Σ 8C over the forward's calls;
* ``global_rows`` moves, per micro-batch, the global outputs and the three
  label planes in float32, n × batch × (heads + 3) × crop² × 4 bytes, and
  the n × batch float32 label mask;
* ``param_mib`` is the JAX tool's ``param_bytes(state)`` of the same model;
* the record carries the JAX tool's ``analyze_regime`` keys but its FLOPs
  (renamed where the port's world is not a TPU mesh);
* the ring and efficiency formulas hold on a hand case, as do the JAX
  tool's at its own link rate.
"""

import ast
import json
import types
from contextlib import redirect_stdout
from io import StringIO

import jax
import pytest
import torch

from conftest import REPO_ROOT, import_tool
from multimodal_siamese_cd_tpu.config import load_cfg as jax_load_cfg
from multimodal_siamese_cd_tpu.models import create_network as jax_create_network
from multimodal_siamese_cd_tpu.models.factory import init_variables
from multimodal_siamese_cd_tpu_torch import bench, model_scaling
from multimodal_siamese_cd_tpu_torch.config import load_cfg
from multimodal_siamese_cd_tpu_torch.models.batchnorm import BatchNorm2d
from multimodal_siamese_cd_tpu_torch.models.factory import create_network

torch.set_num_threads(1)

WORLDS, CROP, BATCH = (2, 4), 32, 2
OPTS = ["MODEL.TOPOLOGY", "[8, 16]"]
REGIMES = list(bench.REGIME_MODELS)
# each regime's heads in float32 (the labels are y_change and the two
# building planes)
HEADS = {"supervised": 1, "dualtask": 3, "semisupervised": 3}
# the JAX record's keys the port renames: a world of ranks is not a mesh of
# chips
RENAMED = {"mesh_devices": "world", "batch_per_chip": "batch_per_rank",
           "measured_step_ms_1chip": "measured_step_ms_1card",
           "ici_wire_ms_ring": "link_wire_ms_ring"}


@pytest.fixture(scope="module")
def records():
    """``{world: {regime: record}}`` from ``model_scaling.main``."""
    out = {}
    for world in WORLDS:
        printed = StringIO()
        with redirect_stdout(printed):
            rc = model_scaling.main(["--world", str(world), "--crop", str(CROP),
                                     "--batch-per-rank", str(BATCH), "--device", "cpu",
                                     "--step-ms", "10,20,30"] + OPTS)
        assert rc == 0
        lines = [json.loads(line) for line in printed.getvalue().splitlines()]
        out[world] = {r["regime"]: r for r in lines}
    return out


def _port_cfg(regime: str):
    cfg = load_cfg("base")
    cfg.merge_from_list(model_scaling.regime_overrides(regime, 1, BATCH, CROP, OPTS))
    return cfg


def _bn_channels(regime: str) -> list:
    """The channels of every BatchNorm call of a train-mode forward of the
    regime's model (forward pre-hooks, one process)."""
    model = create_network(_port_cfg(regime), device="cpu")
    seen = []
    for m in model.modules():
        if isinstance(m, BatchNorm2d):
            m.register_forward_pre_hook(lambda mod, args: seen.append(args[0].shape[1]))
    x = torch.rand(BATCH, 6, CROP, CROP)
    model.train()
    model(x, x.clone())
    return seen


CASES = [(w, r) for w in WORLDS for r in REGIMES]


@pytest.mark.parametrize("world,regime", CASES)
def test_gradient_bytes_are_four_per_parameter(records, world, regime):
    rec = records[world][regime]
    assert rec["by_site"]["gradient"] == {"calls": 1, "bytes": 4 * rec["param_count"]}
    assert rec["param_count"] == sum(
        p.numel() for p in create_network(_port_cfg(regime), device="cpu").parameters())


@pytest.mark.parametrize("world,regime", CASES)
def test_bn_bytes_are_two_c_floats_per_call(records, world, regime):
    channels = _bn_channels(regime)
    assert records[world][regime]["by_site"]["bn_sums"] == {
        "calls": 2 * len(channels), "bytes": 2 * sum(2 * c * 4 for c in channels)}


@pytest.mark.parametrize("world,regime", CASES)
def test_global_rows_bytes_follow_the_heads_and_labels(records, world, regime):
    """One micro-batch: the global (heads + 3 label planes) in float32 and
    the label mask."""
    rows = world * BATCH
    want = rows * (HEADS[regime] + 3) * CROP * CROP * 4 + rows * 4
    assert records[world][regime]["by_site"]["global_rows"] == {"calls": 1,
                                                                "bytes": want}


@pytest.mark.parametrize("world,regime", CASES)
def test_kinds_sum_the_sites(records, world, regime):
    """A data-parallel step all-reduces and neither broadcasts nor
    exchanges halos; the kinds sum the sites, the ratio is to the
    parameters' bytes."""
    rec = records[world][regime]
    sites = rec["by_site"]
    assert set(sites) == {"bn_sums", "gradient", "global_rows"}
    total = sum(s["bytes"] for s in sites.values())
    assert rec["collectives"] == {"all_reduce": {
        "count": sum(s["calls"] for s in sites.values()), "bytes": total}}
    assert rec["collective_calls"] == rec["collectives"]["all_reduce"]["count"]
    assert rec["allreduce_mib"] == rec["total_collective_mib"] == total / 2**20
    assert rec["allreduce_vs_param_bytes"] == total / (4 * rec["param_count"])


@pytest.mark.parametrize("regime", REGIMES)
def test_param_mib_is_the_jax_param_bytes(records, regime):
    ms = import_tool("model_scaling")
    cfg = jax_load_cfg("base")
    cfg.merge_from_list(model_scaling.regime_overrides(regime, 1, BATCH, CROP, OPTS))
    model = jax_create_network(cfg)
    variables = jax.eval_shape(lambda: init_variables(model, cfg, jax.random.PRNGKey(0)))
    want = ms.param_bytes(types.SimpleNamespace(params=variables["params"]))
    for world in WORLDS:
        assert records[world][regime]["param_mib"] == want / 2**20


def test_record_keys_are_the_jax_records_but_the_flops(records):
    """The keys of the dict ``analyze_regime`` builds (read from the JAX
    tool's source), renamed, less ``flops_per_device_per_step``."""
    tree = ast.parse((REPO_ROOT / "tools" / "model_scaling.py").read_text())
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef)
              and n.name == "analyze_regime")
    rec = next(n.value for n in ast.walk(fn) if isinstance(n, ast.Assign)
               and getattr(n.targets[0], "id", "") == "rec")
    jax_keys = {k.value for k in rec.keys} - {"flops_per_device_per_step"}
    assert "mesh_devices" in jax_keys and len(jax_keys) == 14
    got = records[2]["supervised"]
    assert {RENAMED.get(k, k) for k in jax_keys} <= set(got)
    assert {"collective_calls", "by_site", "device"} <= set(got)
    assert "flops_per_device_per_step" not in got
    assert got["device"]["platform"] == "cpu" and got["world"] == 2
    assert got["measured_step_ms_1card"] == 10.0


def test_ring_and_efficiency_on_a_hand_case():
    """1 GB all-reduced over 4 ranks: each moves 2·3/4 GB = 1.5 GB, over
    both directions of a 450 GB/s link, 1.5e9 / 900e9 s = 5/3 ms; beside a
    10 ms step 10 / (35/3) without overlap, 1 overlapped; at the JAX tool's
    45 GB/s its own formula gives the same wire time."""
    wire, no_overlap, overlapped = model_scaling.ring_model(10**9, 4, 10.0, 450.0)
    assert wire == pytest.approx(5 / 3, rel=1e-12)
    assert no_overlap == pytest.approx(10 / (10 + 5 / 3), rel=1e-12)
    assert overlapped == 1.0
    wire, _, overlapped = model_scaling.ring_model(10**9, 4, 10.0, 45.0)
    assert wire == pytest.approx(2 * 3 / 4 * 1e9 / (2 * 45.0 * 1e9) * 1e3, rel=1e-12)
    assert overlapped == pytest.approx(10 / wire, rel=1e-12)
    rows = model_scaling.host_feed_table(10.0, 8, 700.0)
    assert [r["patches_per_s_demand"] for r in rows] == [800.0, 3200.0, 6400.0, 12800.0]
    assert [r["loader_cores_required"] for r in rows] == [2, 5, 10, 19]


def test_cpu_without_step_ms_is_refused(capsys):
    with pytest.raises(SystemExit) as exit_:
        model_scaling.main(["--device", "cpu", "--world", "2"])
    assert exit_.value.code == 2
    assert "--step-ms is required" in capsys.readouterr().err
