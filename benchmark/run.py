"""Run one cell of ``BENCHMARK.json`` once:

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Set-up (imports, kernel builds on a first run,
the fixture on a first run, weights, warm-up) counts from process start to
the first timed unit of work; the window then runs for ``--seconds``; after
it the reference judges what the window's path produced. ``--trace 0``
prints the cell's end-to-end metrics, ``--trace 1`` profiles a stretch of
the same path and prints its per-layer metrics and a breakdown. The last
line of standard output is one JSON object; the numbers that decided
``correct`` also end standard error.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "multimodal_siamese_cd_tpu")
CACHE_DIRS = {"TRITON_CACHE_DIR": "build/triton", "TORCHINDUCTOR_CACHE_DIR": "build/inductor"}


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole (the port's name begins with the JAX package's)."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def run_cell(cell) -> dict:
    """Drive the cell and assemble its result line."""
    import torch

    from .yardstick import trace

    outcome = cell.traffic_module().run(cell)
    checks = outcome["checks"]
    correct = all(ok for *_, ok in checks) and outcome["failed"] == 0
    device = cell.device
    line = {"correct": correct, "attempted": outcome["attempted"],
            "failed": outcome["failed"], "metrics": {}}
    info = {"platform": "gpu" if device.type == "cuda" else device.type,
            "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
            "count": 1, "memory_peak_bytes": outcome.get("memory_peak_bytes", 0)}
    if cell.trace:
        ctx = outcome["ctx"]
        ctx["summary"] = trace.summarize(ctx["traced"])
        line["metrics"] = cell.read_per_layer(ctx)
        info["busy_s"] = ctx["summary"]["busy_s"]
        info["window_s"] = ctx["summary"]["window_s"]
        line["device"] = info
        line["breakdown"] = trace.breakdown(ctx["summary"])
    else:
        units = {m["name"]: m["unit"] for m in cell.end_to_end}
        values = {**outcome["e2e"], "setup_s": outcome["setup_s"]}
        line["metrics"] = {k: {"value": values[k], "unit": u} for k, u in units.items()}
        line["device"] = info
    line["checks"] = {name: {"value": value, "limit": limit}
                      for name, value, limit, _ in checks}
    return line


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    root = Path.cwd()
    for var, sub in CACHE_DIRS.items():
        os.environ[var] = str(root / sub)

    import torch

    bench = json.loads((root / "BENCHMARK.json").read_text())
    entry = next((w for w in bench["workloads"] if w["name"] == a.workload), None)
    if entry is None:
        print(f"no workload {a.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < entry["chips"]:
        print(f"{a.workload} needs {entry['chips']} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found",
              file=sys.stderr)
        return 2

    from .cell import Cell

    cell = Cell(a.workload, a.seed, a.seconds, bool(a.trace), torch.device("cuda"), T0,
                bench=bench)
    line = run_cell(cell)
    found = forbidden_modules()
    if found:
        print(f"the run loaded {found}: the benchmark may not load JAX or the JAX "
              f"package", file=sys.stderr)
        return 3
    for name, c in line["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(f"correct: {line['correct']}", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
