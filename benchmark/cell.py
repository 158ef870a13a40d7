"""One cell of ``BENCHMARK.json``, resolved from data: its entry there, its
configuration file, its traffic file and its limits file, each found by
name. A traffic file's ``kind`` names its generator module in
:mod:`benchmark.traffic`; each per-layer metric's reader is
``benchmark/metrics/<metric name>.py``. A later cell, kind or metric is
added by adding files and entries."""

from __future__ import annotations

import copy
import importlib
import importlib.util
import json
import math
from pathlib import Path

import numpy as np
import torch

from . import fixture
from .reference import models
from .yardstick.trace import Spans

HERE = Path(__file__).resolve().parent


def _merge(base: dict, patch: dict) -> dict:
    out = copy.deepcopy(base)
    for k, v in patch.items():
        out[k] = _merge(out[k], v) if isinstance(v, dict) and isinstance(out.get(k), dict) else v
    return out


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


class Cell:
    """Everything a traffic module needs: the cell's files, the run's
    arguments, the device, the spans and the clock the set-up started on.
    ``patch`` deep-merges into the configuration and traffic files, and
    ``fixture_params`` / ``data_dir`` replace the fixture (the CPU tests'
    small shapes)."""

    def __init__(self, name: str, seed: int, seconds: float, trace: bool,
                 device: torch.device, t0: float, bench: dict | None = None,
                 patch: dict | None = None, fixture_params: dict | None = None,
                 data_dir: Path | None = None):
        bench = json.loads(Path("BENCHMARK.json").read_text()) if bench is None else bench
        entry = next((w for w in bench["workloads"] if w["name"] == name), None)
        if entry is None:
            raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
        config = next(c for c in bench["configs"] if c["name"] == entry["config"])
        patch = patch or {}
        self.name, self.seed, self.seconds, self.trace = name, int(seed), seconds, trace
        self.device, self.t0 = device, t0
        self.config = _merge(json.loads(Path(config["file"]).read_text()),
                             patch.get("config", {}))
        self.traffic = _merge(json.loads((HERE / "workloads" / f"{entry['traffic']}.json")
                                         .read_text()), patch.get("traffic", {}))
        self.limits = json.loads((HERE / "limits" / f"{name}.json").read_text())
        self.end_to_end = [m for m in bench["end_to_end"] if applies(m, name)]
        self.per_layer = [m for m in bench["per_layer"] if applies(m, name)]
        self.fixture_params = fixture_params
        self.data_dir = data_dir or fixture.DATA_DIR
        self.spans = Spans()
        self.settings = self.config["settings"]

    # -- the configuration ------------------------------------------------
    def model_spec(self) -> dict:
        s = self.settings
        n1, n2 = len(s["DATALOADER.S1_BANDS"]), len(s["DATALOADER.S2_BANDS"])
        return {"type": s["MODEL.TYPE"], "topology": list(s["MODEL.TOPOLOGY"]),
                "in_channels": n1 + n2, "n_s1_bands": n1, "n_s2_bands": n2}

    def fixture_root(self) -> Path:
        return fixture.ensure(self.fixture_params, self.data_dir)

    def fixture_aois(self) -> dict:
        p = self.fixture_params or fixture.params()
        return {"labeled": list(p["labeled"]), "unlabeled": list(p["unlabeled"])}

    def port_cfg(self, extra: dict | None = None):
        """The port's config: the configuration's yaml, every setting of the
        configuration and traffic files, the fixture's path and splits, the
        seed; ``extra`` last."""
        from multimodal_siamese_cd_tpu_torch.config import load_cfg

        cfg = load_cfg(self.config["yaml"])
        a = self.fixture_aois()
        opts = {**self.settings, **self.traffic.get("settings", {}),
                "DATASET.TRAINING_IDS": a["labeled"], "DATASET.VALIDATION_IDS": [],
                "DATASET.TEST_IDS": [], "DATASET.UNLABELED_IDS": a["unlabeled"],
                "SEED": self.seed, **(extra or {})}
        cfg.merge_from_list([x for k, v in opts.items() for x in (k, v)])
        cfg.PATHS.DATASET = str(self.fixture_root())
        for key, want in opts.items():
            node = cfg
            for part in key.split("."):
                node = node[part]
            if (list(node) if isinstance(node, (list, tuple)) else node) != want:
                raise ValueError(f"the port's config holds {key} = {node!r}, not {want!r}")
        return cfg

    # -- the weights ------------------------------------------------------
    def weights(self, device=None) -> dict:
        """The model's state from the seed, made on ``device`` (default the
        run's) in one draw: convolution weights N(0, 1/fan_in), a one-channel
        head's N(0, 16/fan_in) less their mean (its logits then spread over
        several units around 0, so that both classes, and pixels near the
        threshold, are there to judge on every seed), biases N(0, 0.01²);
        BatchNorm weights
        1 + N(0, 0.1²), biases and running means N(0, 0.1²), running
        variances exp(N(0, 0.2²)). Keys follow the published
        ``state_dict``."""
        device = self.device if device is None else torch.device(device)
        with torch.device("meta"):
            net = models.build(self.model_spec())
        plan = []   # (key, shape, scale, shift, exp)
        heads = set()
        for mname, m in net.named_modules():
            if isinstance(m, (torch.nn.Conv2d, torch.nn.ConvTranspose2d)):
                fan = m.weight.shape[1] * m.weight[0, 0].numel()
                gain = 4.0 if m.out_channels == 1 else 1.0
                if m.out_channels == 1:
                    heads.add(f"{mname}.weight")
                plan.append((f"{mname}.weight", m.weight.shape, gain / math.sqrt(fan), 0.0,
                             False))
                plan.append((f"{mname}.bias", m.bias.shape, 0.01, 0.0, False))
            elif isinstance(m, torch.nn.BatchNorm2d):
                c = m.weight.shape
                plan += [(f"{mname}.weight", c, 0.1, 1.0, False),
                         (f"{mname}.bias", c, 0.1, 0.0, False),
                         (f"{mname}.running_mean", c, 0.1, 0.0, False),
                         (f"{mname}.running_var", c, 0.2, 0.0, True)]
        total = sum(math.prod(shape) for _, shape, *_ in plan)
        gen = torch.Generator(device=device).manual_seed(self.seed)
        draw = torch.randn(total, generator=gen, device=device)
        state, at = {}, 0
        for key, shape, scale, shift, exp in plan:
            n = math.prod(shape)
            v = draw[at:at + n].view(shape) * scale + shift
            if key in heads:
                v = v - v.mean()
            state[key] = v.exp() if exp else v
            at += n
        for mname, m in net.named_modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                state[f"{mname}.num_batches_tracked"] = torch.zeros((), dtype=torch.long,
                                                                    device=device)
        return state

    def eval_weights(self) -> dict:
        """:meth:`weights` with BatchNorm's running statistics taken, as a
        trained model's are, from the data: one train-mode forward of the
        reference model over the fixture's first two labeled first/last
        pairs (padded to multiples of 64, which they share), each layer's
        statistics those of that batch. Random running statistics would
        leave an eval-mode forward's logits offset far from 0 and its
        classes degenerate."""
        from .reference.data import Fixture

        state = self.weights()
        s = self.settings
        fx = Fixture(self.fixture_root(), s["DATALOADER.S1_BANDS"], s["DATALOADER.S2_BANDS"])
        net = models.build(self.model_spec()).to(self.device)
        net.load_state_dict(state)
        for m in net.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.momentum = None           # the running statistics of one batch
                m.reset_running_stats()
        pairs = []
        for aoi in self.fixture_aois()["labeled"][:2]:
            d = fx.dates(aoi)
            pairs.append(fx.scene_input(aoi, d[0], d[-1], 64))
        x1, x2 = (torch.from_numpy(np.stack([p[k] for p in pairs])).to(self.device)
                  for k in ("x1", "x2"))
        with torch.no_grad():
            net.train()(x1, x2)
        live = net.state_dict()
        for key in state:
            if key.endswith(("running_mean", "running_var")):
                state[key] = live[key].clone()
        del net, live, x1, x2
        if self.device.type == "cuda":
            # the weights are the benchmark's: the program's peak starts here
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(self.device)
        return state

    # -- the readers --------------------------------------------------------
    def read_per_layer(self, ctx: dict) -> dict:
        """Each per-layer metric of this cell that its reader finds."""
        out = {}
        for m in self.per_layer:
            path = HERE / "metrics" / f"{m['name']}.py"
            spec = importlib.util.spec_from_file_location(f"benchmark_metric_{len(out)}", path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            value = mod.read(ctx)
            if value is not None:
                out[m["name"]] = {"value": value, "unit": m["unit"]}
        return out

    def traffic_module(self):
        return importlib.import_module(f"benchmark.traffic.{self.traffic['kind']}")
