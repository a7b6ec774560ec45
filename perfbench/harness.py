"""What every cell shares: finding a cell's files by the names in
``BENCHMARK.json``, the run's state, the metric readers and the result
line.

A cell names a configuration (``configs/<name>.json``) and a traffic mix
(``traffic/<name>.json``); the traffic's ``kind`` names the runner
(``kinds/<kind>.py``, with ``execute(run)``), the cell's name its limits
(``limits/<cell>.json``) and each metric's name its reader
(``metrics/<metric>.py``, with ``read(run)``, which returns None where it
finds nothing to read).
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import subprocess
import sys
from pathlib import Path
from typing import Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

# top-level module names that no run of the benchmark may hold: JAX and
# the JAX package (and its benchmark folder), compared as whole names
FORBIDDEN = ("jax", "jaxlib", "flax", "repro", "benchmarks")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def spec() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def workload(sp: dict, name: str) -> dict:
    for w in sp["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json; have "
                   f"{[w['name'] for w in sp['workloads']]}")


def config_file(sp: dict, name: str) -> dict:
    for c in sp["configs"]:
        if c["name"] == name:
            return load_json(ROOT / c["file"])
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def traffic_file(name: str) -> dict:
    return load_json(HERE / "traffic" / f"{name}.json")


def limits_file(cell: str) -> Dict[str, float]:
    path = HERE / "limits" / f"{cell}.json"
    return load_json(path)["limits"] if path.exists() else {}


def runner(kind: str):
    return importlib.import_module(f"perfbench.kinds.{kind}")


def reader(metric: str):
    path = HERE / "metrics" / f"{metric}.py"
    mod_spec = importlib.util.spec_from_file_location(
        f"perfbench.metrics.{metric}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read


def metrics_of(sp: dict, cell: str, traced: bool) -> List[dict]:
    """The cell's end-to-end metrics (untraced) or per-layer ones."""
    group = sp["per_layer"] if traced else sp["end_to_end"]
    return [m for m in group if cell in m.get("workloads", [cell])]


class Run:
    """One run of one cell: its inputs, then what the runner fills in."""

    def __init__(self, *, cell: str, model: dict, traffic: dict,
                 limits: Dict[str, float], seed: int, seconds: float,
                 trace_on: bool, device, t_start: float):
        self.cell, self.model, self.traffic = cell, model, traffic
        self.limits, self.seed, self.seconds = limits, seed, seconds
        self.trace_on, self.device, self.t_start = trace_on, device, t_start
        self.trace = None
        self.steps: List[dict] = []  # the window's
        self.traced_steps: List[dict] = []  # the traced ones after it


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def power_limit() -> Optional[str]:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else None


def result(sp: dict, run: Run, chips: int) -> dict:
    import torch
    metrics = {}
    for m in metrics_of(sp, run.cell, run.trace_on):
        v = reader(m["name"])(run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": chips, "memory_peak_bytes": int(run.peak_bytes)}
    steps = run.steps + run.traced_steps
    out = {"correct": bool(run.correct), "attempted": len(steps),
           "failed": sum(not s["finite"] for s in steps),
           "metrics": metrics, "device": device}
    if run.trace is not None:
        device["busy_s"] = run.trace.busy_ns() / 1e9
        device["window_s"] = run.trace.window_s
        out["breakdown"] = {"device_ops": run.trace.top_ops(),
                            "idle_gaps": run.trace.idle_gaps()}
    out["card"] = power_limit()
    out["reference_s"] = run.reference_s
    out["compared"] = run.compared
    return out
