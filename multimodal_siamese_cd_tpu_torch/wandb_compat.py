"""Experiment logging facade (the port's copy of the JAX package's).

The reference logs exclusively to wandb (train_supervised.py:133-140,
evaluation.py:36-41). This facade keeps that call surface (``init`` /
``log`` / ``finish``) and routes to:

  * the real ``wandb`` package when it is importable and mode != disabled,
  * otherwise a JSONL sink at ``{OUTPUT}/logs/{name}.jsonl`` plus stdout —
    so headless runs are observable without external services. The
    environment variable ``MSCD_LOG_SINK=jsonl`` (:data:`SINK_ENV`) picks
    the JSONL sink even where wandb is installed: the lifecycle tools set
    it for the CLIs they run, whose logs they read.

Metric names are kept identical to the reference so dashboards/parsers
transfer ('loss', '{run_type} F1/precision/recall', 'labeled_percentage',
'time', 'step', 'epoch', the semi-supervised component losses).
"""

from __future__ import annotations

import json
import os
import time
from pathlib import Path

try:
    import wandb as _wandb
except ImportError:
    _wandb = None

_run = None
SINK_ENV = {"MSCD_LOG_SINK": "jsonl"}


def _jsonable(v):
    """JSON-safe value with type fidelity: Python ints/bools/floats pass
    through unchanged (wandb keeps integer steps and bool flags — parsers
    expect them), numpy/torch scalars unwrap via .item(), arrays become
    lists instead of raising inside log()."""
    if isinstance(v, (bool, int, float, str)) or v is None:
        return v
    if hasattr(v, "item") and getattr(v, "size", None) == 1:
        return v.item()
    if hasattr(v, "tolist"):
        return v.tolist()
    if hasattr(v, "__float__"):
        return float(v)
    return v


class _JsonlRun:
    def __init__(self, name: str, out_dir: Path | None, config: dict | None,
                 disabled: bool = False):
        self.name = name
        self.t0 = time.time()
        self.file = None
        self.disabled = disabled
        if out_dir is not None and not disabled:
            log_dir = Path(out_dir) / "logs"
            log_dir.mkdir(parents=True, exist_ok=True)
            self.file = open(log_dir / f"{name}.jsonl", "a", buffering=1)
            if config:
                self._write({"_event": "init", "config": config})

    def _write(self, record: dict) -> None:
        if self.file is not None:
            self.file.write(json.dumps(record, default=str) + "\n")

    def log(self, metrics: dict) -> None:
        if self.disabled:
            # parity with wandb mode='disabled': swallow everything
            return
        record = {"_t": round(time.time() - self.t0, 3)}
        record.update({k: _jsonable(v) for k, v in metrics.items()})
        self._write(record)
        printable = ", ".join(
            f"{k}={v:.4f}" if isinstance(v, float) else f"{k}={v}"
            for k, v in record.items() if not k.startswith("_"))
        print(f"[{self.name}] {printable}", flush=True)

    def finish(self) -> None:
        if self.file is not None:
            self.file.close()
            self.file = None


def init(name: str, config=None, entity: str = None, project: str = None,
         tags=None, mode: str = "online", out_dir=None):
    """wandb.init-compatible entry (reference train_supervised.py:133-140).
    Falls back to JSONL when wandb is unavailable; honours mode='disabled'.
    """
    global _run
    if _run is not None:
        # re-init without finish(): close the previous run instead of
        # orphaning its open file handle (late buffered writes from a
        # leaked handle can interleave into the old JSONL)
        finish()
    cfg_dict = config.to_dict() if hasattr(config, "to_dict") else config
    if SINK_ENV.items() <= os.environ.items() and mode != "disabled":
        mode = "jsonl"
    if _wandb is not None and mode != "jsonl":
        _run = _wandb.init(name=name, config=cfg_dict, entity=entity,
                           project=project, tags=tags, mode=mode)
    else:
        _run = _JsonlRun(name, out_dir, cfg_dict, disabled=(mode == "disabled"))
    return _run


def log(metrics: dict) -> None:
    if _run is None:
        return
    if _wandb is not None and not isinstance(_run, _JsonlRun):
        _wandb.log(metrics)
    else:
        _run.log(metrics)


def finish() -> None:
    global _run
    if _run is None:
        return
    if _wandb is not None and not isinstance(_run, _JsonlRun):
        _wandb.finish()
    else:
        _run.finish()
    _run = None
