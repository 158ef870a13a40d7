"""The plain reference against the port on the CPU at topology [8, 16], the
counts of operations and bytes against shapes worked by hand, and the
fixture against the port's reader."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark import fixture
from benchmark.reference import data as ref_data
from benchmark.reference import judge
from benchmark.reference import models
from benchmark.reference import train as ref_train
from benchmark.yardstick import costs

from .conftest import TINY_FIXTURE

SPECS = {
    "siameseunet": {"type": "siameseunet", "topology": [8, 16], "in_channels": 6,
                    "n_s1_bands": 2, "n_s2_bands": 4},
    "whatevernet": {"type": "whatevernet", "topology": [8, 16], "in_channels": 6,
                    "n_s1_bands": 2, "n_s2_bands": 4},
}


def _port_model(spec):
    from multimodal_siamese_cd_tpu_torch.config import load_cfg
    from multimodal_siamese_cd_tpu_torch.models.factory import create_network

    cfg = load_cfg("base")
    cfg.merge_from_list(["MODEL.TYPE", spec["type"], "MODEL.TOPOLOGY", [8, 16],
                         "TRAINER.PRECISION", "fp32"])
    return create_network(cfg, device="cpu", generator=torch.Generator().manual_seed(3))


@pytest.mark.parametrize("kind", sorted(SPECS))
@pytest.mark.parametrize("train_mode", [False, True])
def test_reference_matches_the_port(kind, train_mode):
    port = _port_model(SPECS[kind])
    ref = models.build(SPECS[kind])
    ref.load_state_dict(port.state_dict(), strict=True)
    g = torch.Generator().manual_seed(0)
    x1, x2 = (torch.rand((2, 6, 40, 48), generator=g) for _ in range(2))
    port.train(train_mode)
    ref.train(train_mode)
    with torch.no_grad():
        a, b = port(x1, x2), ref(x1, x2)
    a = a if isinstance(a, tuple) else (a,)
    b = b if isinstance(b, tuple) and train_mode else (models.change_logits(ref, x1, x2),)
    for u, v in zip(a, b):
        torch.testing.assert_close(u, v, rtol=1e-4, atol=1e-5)


def test_reference_step_matches_the_port_step():
    """One supervised AdamW step of each side from the same weights and
    batch, the augmentation drawn from the same seeded generator."""
    from multimodal_siamese_cd_tpu_torch import train_lib
    from multimodal_siamese_cd_tpu_torch.config import load_cfg

    spec = SPECS["siameseunet"]
    port = _port_model(spec)
    ref = models.build(spec)
    ref.load_state_dict(port.state_dict())
    cfg = load_cfg("siamese")
    cfg.merge_from_list(["MODEL.TOPOLOGY", [8, 16], "TRAINER.PRECISION", "fp32",
                         "SEED", 99])
    opt = train_lib.make_optimizer(port, cfg)
    step = train_lib.make_train_step(port, opt, cfg, "supervised")
    g = torch.Generator().manual_seed(1)
    stack = torch.rand((4, 15, 32, 32), generator=g)
    stack[:, 12:] = (stack[:, 12:] > 0.7).float()
    m = step(stack, torch.ones(4), 0)
    conf = {**spec, "regime": "supervised", "lr": 1e-4, "flip": True, "rotate": True,
            "alpha": 0.0}
    out = ref_train.run_steps(ref, [stack], [torch.ones(4)], conf, 99)
    assert out["loss"][0] == pytest.approx(float(m["loss"]), rel=1e-5)
    # a convolution's bias before BatchNorm has no gradient but round-off,
    # which AdamW turns into a full step either way: left out, as judged
    moved = judge.moved_leaves(out["grad_norms"])["any"]
    assert len(moved) < len(out["grad"])
    for n, p in port.named_parameters():
        if n in moved:
            torch.testing.assert_close(p.detach(), out["params"][n], rtol=1e-4, atol=1e-6)


def test_flops_and_bn_bytes_by_hand():
    """siameseunet [8, 16], 6 bands, one 32 x 32 pair."""
    spec = SPECS["siameseunet"]
    conv = lambda cin, cout, k, h, w: 2 * cin * cout * k * k * h * w  # noqa: E731
    enc = (conv(6, 8, 3, 32, 32) + conv(8, 8, 3, 32, 32)            # inc
           + conv(8, 16, 3, 16, 16) + conv(16, 16, 3, 16, 16)        # down1
           + conv(16, 16, 3, 8, 8) + conv(16, 16, 3, 8, 8))          # down2
    dec = (conv(16, 16, 2, 8, 8) + conv(32, 8, 3, 16, 16) + conv(8, 8, 3, 16, 16)   # up2
           + conv(8, 8, 2, 16, 16) + conv(16, 8, 3, 32, 32) + conv(8, 8, 3, 32, 32)  # up1
           + conv(8, 1, 1, 32, 32))                                                 # outc
    assert costs.forward_flops(spec, 1, 32) == 2 * enc + dec
    bn_elems = 2 * (2 * 8 * 32 * 32 + 2 * 16 * 16 * 16 + 2 * 16 * 8 * 8) \
        + 2 * 8 * 16 * 16 + 2 * 8 * 32 * 32
    bn_calls = 2 * 6 + 4
    sums = 2 * 2 * 4 * (2 * (8 + 8 + 16 + 16 + 16 + 16) + 8 + 8 + 8 + 8)
    assert bn_calls == len(costs.layer_shapes(spec, 1, 32)["bn_calls"])
    assert costs.bn_stats_bytes(spec, 1, 32) == 3 * 2 * bn_elems + sums


def test_flops_of_the_full_width_patch():
    """The published siameseunet at a 256^2 patch: ~9.4e10 forward FLOPs."""
    spec = {**SPECS["siameseunet"], "topology": [64, 128, 256, 512]}
    assert costs.forward_flops(spec, 1, 256) == pytest.approx(9.4e10, rel=0.05)


def test_fixture_reads_as_the_port_reads_it(data_dir):
    from multimodal_siamese_cd_tpu_torch import geofiles

    root = fixture.ensure(TINY_FIXTURE, data_dir)
    for tif in sorted(root.rglob("*.tif"))[:6]:
        a, transform, crs = geofiles.read_tif(tif)
        np.testing.assert_array_equal(a, ref_data.read_tif(tif))
        assert crs.epsg == 4326 and transform.a == pytest.approx(4.77e-5)


def test_fixture_is_the_port_generators(data_dir, tmp_path):
    from multimodal_siamese_cd_tpu_torch import geofiles
    from multimodal_siamese_cd_tpu_torch.data import synthetic

    root = fixture.ensure(TINY_FIXTURE, data_dir)
    p = TINY_FIXTURE
    synthetic.generate_fixture_dataset(tmp_path, seed=p["seed"], scene_size=tuple(p["scene_size"]),
                                       n_timestamps=p["n_timestamps"], aois=fixture.aois(p))
    for tif in sorted(tmp_path.rglob("*.tif")):
        a, _, _ = geofiles.read_tif(tif)
        np.testing.assert_array_equal(a, ref_data.read_tif(root / tif.relative_to(tmp_path)))


def test_locate_finds_every_crop():
    rng = np.random.default_rng(0)
    scene = rng.uniform(0, 1, (3, 50, 60)).astype(np.float16)
    for y, x in ((0, 0), (18, 28), (7, 3)):
        assert ref_data.locate(scene, scene[:, y:y + 32, x:x + 32].copy()) == (y, x)
    crop = scene[:, 5:37, 5:37].copy()
    crop[1, 3, 3] += 1
    assert ref_data.locate(scene, crop) is None
