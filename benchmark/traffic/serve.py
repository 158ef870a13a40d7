"""Serving traffic: one client in a closed loop (a mapping user who
submits a scene pair and waits for the change map) calling
``ServingModel.predict`` on scene pairs whose sides come from a fixed list
in the traffic file, in an order and at positions in the fixture's scenes
drawn from the seed. Each call is timed from the call to the host array of
probabilities.

Set-up exports the seed's weights as a serving bundle with the traffic's
buckets and batch sizes for the card, loads it and warms each bucket the
traffic reaches. A sample of the served maps, drawn from the seed and with
the largest request in it, is kept and judged against the reference once
the window has closed.
"""

from __future__ import annotations

import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from ..reference import data as ref_data
from ..reference import judge, models
from ..yardstick.trace import trace
from .train import sync


class Requests:
    """The traffic's requests: ``(aoi, y, x, h, w)`` crops of the first/last
    scene pairs of the first ``scene_pairs`` labeled AOIs, every side from
    the traffic's list, in a seeded order; the imagery read once."""

    def __init__(self, cell):
        t = cell.traffic
        s = cell.settings
        fx = ref_data.Fixture(cell.fixture_root(), s["DATALOADER.S1_BANDS"],
                              s["DATALOADER.S2_BANDS"],
                              s["DATALOADER.INCLUDE_BUILDING_LABELS"])
        rng = np.random.default_rng(np.random.SeedSequence([cell.seed, 1]))
        n1 = len(s["DATALOADER.S1_BANDS"])
        self.pairs = []
        for aoi in cell.fixture_aois()["labeled"][:t["scene_pairs"]]:
            d = fx.dates(aoi)
            full = fx.stack(aoi, d[0], d[-1])
            n2 = (full.shape[0] - 3) // 2 - n1
            x1 = np.concatenate([full[:n1], full[2 * n1:2 * n1 + n2]]).astype(np.float32)
            x2 = np.concatenate([full[n1:2 * n1], full[2 * n1 + n2:2 * n1 + 2 * n2]]
                                ).astype(np.float32)
            self.pairs.append((aoi, np.moveaxis(x1, 0, -1), np.moveaxis(x2, 0, -1)))
        sides = [tuple(v) for v in t["sides"]]
        self.order = []
        for _ in range(t["rounds"]):
            for i in rng.permutation(len(sides)):
                p = int(rng.integers(len(self.pairs)))
                h, w = sides[i]
                H, W = self.pairs[p][1].shape[:2]
                self.order.append((p, int(rng.integers(H - h + 1)), int(rng.integers(W - w + 1)),
                                   h, w))
        first = min(len(self.order), t["sample_from"])
        largest = max(range(first), key=lambda i: self.order[i][3] * self.order[i][4])
        sample = rng.choice(first, min(first, t["sample"]), replace=False)
        self.sample = sorted(set(int(i) for i in sample) | {largest})

    def __len__(self):
        return len(self.order)

    def get(self, i: int) -> tuple:
        p, y, x, h, w = self.order[i % len(self.order)]
        _, x1, x2 = self.pairs[p]
        return x1[y:y + h, x:x + w], x2[y:y + h, x:x + w]


def build(cell, directory: Path):
    from multimodal_siamese_cd_tpu_torch import serving
    from multimodal_siamese_cd_tpu_torch.models.factory import create_network

    t = cell.traffic
    cfg = cell.port_cfg()
    model = create_network(cfg, device=cell.device,
                           generator=torch.Generator().manual_seed(0))
    weights = cell.eval_weights()
    model.load_state_dict(weights)
    path = serving.export_serving_bundle(
        model.eval(), cfg, directory / "bundle.zip",
        buckets=[tuple(b) for b in t["buckets"]],
        platforms=[cell.device.type], batch_sizes=tuple(t["batch_sizes"]))
    del model
    return serving.load_serving_bundle(path, device=cell.device), weights


def bucket_for(buckets: list, h: int, w: int) -> tuple:
    """The bucket a request of ``h`` x ``w`` routes to: of the traffic's
    buckets that hold it, the least in area."""
    return min((bh * bw, bh, bw) for bh, bw in buckets if bh >= h and bw >= w)[1:]


def reference_maps(cell, weights: dict, requests: Requests, indices: list,
                   quantized: bool = False) -> dict:
    """The reference's probabilities of the requests ``indices``, each
    zero-padded at the bottom and right to its bucket."""
    net = models.build(cell.model_spec()).to(cell.device).eval()
    net.load_state_dict(weights)
    out = {}
    models.Quantized.on = quantized
    try:
        with judge.float32_exact(), torch.no_grad():
            for i in indices:
                x1, x2 = requests.get(i)
                h, w = x1.shape[:2]
                hp, wp = bucket_for(cell.traffic["buckets"], h, w)
                pad = [torch.zeros((1, x1.shape[2], hp, wp), device=cell.device)
                       for _ in range(2)]
                pad[0][0, :, :h, :w] = torch.from_numpy(np.moveaxis(x1, -1, 0).copy())
                pad[1][0, :, :h, :w] = torch.from_numpy(np.moveaxis(x2, -1, 0).copy())
                p = torch.sigmoid(models.change_logits(net, *pad))[0, 0, :h, :w]
                out[i] = p.cpu().numpy()
    finally:
        models.Quantized.on = False
    return out


def gap(program: dict, reference: dict) -> float:
    """The widest gap of a served probability from the reference's."""
    return max(float(np.abs(program[i] - reference[i]).max()) for i in reference)


def run(cell) -> dict:
    device = cell.device
    spans = cell.spans
    requests = Requests(cell)
    with tempfile.TemporaryDirectory() as tmp:
        server, weights = build(cell, Path(tmp))
        for i in range(cell.traffic["warm_calls"]):
            server.predict(*requests.get(i))
        sync(device)
        # the sampled maps are copied into buffers made here, so that the
        # window allocates nothing of the harness's between the calls
        buffers = {i: np.empty(requests.order[i][3:], np.float32) for i in requests.sample}
        kept = {}
        times = []
        state = {"n": 0}
        out = {"setup_s": time.perf_counter() - cell.t0}

        def serve(until=None, count=None):
            while True:
                i = state["n"]
                x1, x2 = requests.get(i)
                with spans("predict"):
                    t0 = time.perf_counter()
                    probs = server.predict(x1, x2)
                    times.append(time.perf_counter() - t0)
                if i in buffers:
                    kept[i] = buffers[i]
                    np.copyto(kept[i], probs)
                state["n"] += 1
                if (count is not None and state["n"] >= count) or \
                        (until is not None and time.perf_counter() >= until):
                    return

        if cell.trace:
            traced = trace(lambda: serve(count=cell.traffic["trace_requests"]), spans, device)
        else:
            serve(until=time.perf_counter() + cell.seconds)
            out["e2e"] = {"serve_ms_p95": float(np.percentile(np.asarray(times) * 1e3, 95))}
        out["attempted"], out["failed"] = state["n"], 0
        if device.type == "cuda":
            out["memory_peak_bytes"] = torch.cuda.max_memory_allocated(device)
        del server
    if device.type == "cuda":
        torch.cuda.empty_cache()
    ref = reference_maps(cell, {n: v.to(device) for n, v in weights.items()}, requests,
                         sorted(kept))
    numbers = {"prob_gap": gap(kept, ref)}
    out["checks"] = judge.check(numbers, cell.limits)
    out["numbers"] = numbers
    if cell.trace:
        out["ctx"] = {"traced": traced, "spans": spans, "requests": state["n"],
                      "device_name": torch.cuda.get_device_name(device)
                      if device.type == "cuda" else None}
    return out
