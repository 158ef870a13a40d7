"""The serving path's host staging on the card, with no JAX in the process.

This file imports only the port, torch and numpy, so it runs on the
machine with the card:

    python -m pytest --noconftest -q tests/test_torch_port_serving_cuda.py

There the ``cuda``-marked test holds ``ServingModel.predict`` on crops of
~1000² scenes, channel-planar (as the benchmark's serving traffic sends
them: ``(H, W, C)`` views of ``(C, H, W)`` arrays) and row-strided
``(H, W, C)``, to the loaded artifact called directly on the zero-padded
NCHW float32 input built with torch on the card, bit for bit, and reads
the staging counts;
here, without a card, it skips inside the test. The CPU cases of the
staging are in ``test_torch_port_serving.py``.
"""

import numpy as np
import pytest
import torch

from multimodal_siamese_cd_tpu_torch import serving
from multimodal_siamese_cd_tpu_torch.config import load_cfg
from multimodal_siamese_cd_tpu_torch.models.factory import create_network

SIDES = [(960, 960), (960, 1000), (968, 992), (976, 984), (984, 968), (992, 1000),
         (1000, 960), (1000, 1000)]


@pytest.mark.cuda
def test_cuda_staging_is_pinned_and_feeds_the_padded_input(tmp_path, monkeypatch):
    """128 calls into the 1024² bucket, alternately from a channel-planar and
    an ``(H, W, C)`` scene: the staging buffer is pinned and made once (reuse
    above 0.99), every call counted pinned; the first sixteen maps equal the
    artifact's on the input padded with torch on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: pinned staging runs only there")
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    cfg = load_cfg("base")
    cfg.MODEL.TYPE = "siameseunet"
    cfg.MODEL.TOPOLOGY = [8, 16]
    model = create_network(cfg, device="cuda", generator=torch.Generator().manual_seed(1))
    path = serving.export_serving_bundle(model.eval(), cfg, tmp_path / "b.zip",
                                         buckets=((1024, 1024),), platforms="cuda")
    del model
    served = serving.load_serving_bundle(path)
    rng = np.random.default_rng(7)
    planar = [np.moveaxis(rng.normal(size=(6, 1016, 1008)).astype(np.float32), 0, -1)
              for _ in range(2)]
    wholes = [planar, [np.ascontiguousarray(a) for a in planar]]
    fn = served._fn((1, 1024, 1024))
    for i in range(128):
        h, w = SIDES[i % len(SIDES)]
        y, x = int(rng.integers(1016 - h + 1)), int(rng.integers(1008 - w + 1))
        x1, x2 = (a[y:y + h, x:x + w] for a in wholes[i % 2])
        got = served.predict(x1, x2)
        assert got.shape == (h, w) and got.dtype == np.float32
        if i < 2 * len(SIDES):
            pads = []
            for a in (x1, x2):
                t = torch.zeros((1, 6, 1024, 1024), device="cuda")
                t[0, :, :h, :w] = torch.from_numpy(np.ascontiguousarray(a)).cuda().permute(2, 0, 1)
                pads.append(t)
            with torch.inference_mode():
                want = fn(served.leaves, *pads)[0, 0, :h, :w].cpu().numpy()
            np.testing.assert_array_equal(got, want)
    assert served._staging[(1, 1024, 1024)][0].is_pinned()
    stats = served.staging_stats()
    assert stats == {"calls": 128, "pinned": 128, "unpinned": 0, "allocations": 1,
                     "reuse": 1 - 1 / 128}
    assert stats["reuse"] > 0.99
