"""What every cell shares: finding its files by name, the run's context,
and the result line.

A cell of ``BENCHMARK.json`` names a configuration and a traffic mix; the
harness reads ``configs/<config>.json``, ``traffic/<mix>.json`` and
``limits/<cell>.json`` under the benchmark's folder, runs the driver the mix
names (``drivers/<driver>.py``), and reads each per-layer metric of the cell
with ``metrics/<metric>.py``. A later cell, mix, configuration or metric is
a new file and a new entry, and no edit.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import math
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

#: Modules that may not be loaded in a run: JAX and the JAX package,
#: compared by whole top-level name.
FORBIDDEN = ("jax", "jaxlib", "flax", "texocr_tpu")


@dataclasses.dataclass
class Cell:
    name: str
    config: dict        # configs/<config>.json
    mix: dict           # traffic/<mix>.json
    limits: dict        # limits/<cell>.json: {number: {"limit": x, ...}}
    end_to_end: List[dict]
    per_layer: List[dict]
    chips: int


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(workload: str, bench_path: Path = ROOT / "BENCHMARK.json",
              data_dir: Path = HERE) -> Cell:
    """The cell ``workload`` of the benchmark file, with its files from
    ``data_dir``."""
    bench = _json(bench_path)
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in {bench_path.name}; "
                         f"known: {', '.join(cells)}")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    if w["config"] not in configs:
        raise SystemExit(f"workload {workload!r} names no configuration of {bench_path.name}")
    e2e = [m for m in bench["end_to_end"] if workload in m.get("workloads", [workload])]
    moved = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if workload in m.get("workloads", [workload] if m["moves"] in moved else [])]
    return Cell(name=workload, config=_json(data_dir / "configs" / f"{w['config']}.json"),
                mix=_json(data_dir / "traffic" / f"{w['traffic']}.json"),
                limits=_json(data_dir / "limits" / f"{workload}.json"),
                end_to_end=e2e, per_layer=per_layer, chips=int(w["chips"]))


class Run:
    """One run's context and record. A driver fills ``e2e`` (end-to-end
    values by name), ``counters`` (what the per-layer readers read),
    ``checks`` ({name: (value, limit)}, by ``judge``), ``attempted`` and ``failed``, calls
    ``setup_done()`` when its window opens, and reads ``memory_peak`` before
    it frees the program's state."""

    def __init__(self, cell: Cell, seed: int, seconds: float, trace: bool, device: str,
                 t_start: float):
        self.cell, self.seed, self.seconds, self.trace = cell, int(seed), seconds, trace
        self.device = device
        self.t_start = t_start
        self.setup_s: Optional[float] = None
        self.e2e: Dict[str, float] = {}
        self.counters: Dict[str, object] = {}
        self.checks: Dict[str, tuple] = {}
        self.attempted = 0
        self.failed = 0
        self.slice = None          # trace.Slice of a --trace 1 run
        self.memory_peak: Optional[int] = None
        # Planted faults and controls (tests and calibration only).
        self.faults: Dict[str, object] = {}

    @property
    def model_config(self) -> dict:
        return self.cell.config["model"]

    def setup_done(self) -> None:
        self.setup_s = time.perf_counter() - self.t_start

    def read_memory_peak(self) -> None:
        import torch

        if self.device == "cuda":
            torch.cuda.synchronize()
            self.memory_peak = int(torch.cuda.max_memory_allocated())

    def limit(self, name: str) -> float:
        return float(self.cell.limits[name]["limit"])

    def check(self, name: str, value: float) -> None:
        self.checks[name] = (float(value), self.limit(name))

    @property
    def controls(self) -> List[str]:
        """The controls read beside the program: those asked for, and the
        one put in the program's place (``in_place``)."""
        asked = list(self.faults.get("controls") or ())
        side = self.faults.get("in_place")
        return asked + [side] if side and side not in asked else asked

    def judge(self, numbers: Dict[str, Dict[str, float]]) -> None:
        """Checks every number that the cell's limits name, on the program's
        side of ``numbers`` ({side: {name: value}}), or on the side of the
        control put in the program's place (``in_place``)."""
        side = self.faults.get("in_place", "program")
        self.checks = {}
        for name in self.cell.limits:
            self.check(name, numbers[side][name])

    @property
    def correct(self) -> bool:
        return self.failed == 0 and bool(self.checks) and all(
            v <= lim for v, lim in self.checks.values())


def percentile(values: List[float], q: float) -> float:
    """The q-th percentile, interpolated between the two nearest ranks as
    ``statistics.quantiles(method='inclusive')`` does; an infinite value
    (a request that never came) is infinitely late, never averaged."""
    v = sorted(values)
    pos = (len(v) - 1) * q / 100.0
    lo = int(math.floor(pos))
    hi, frac = min(lo + 1, len(v) - 1), pos - lo
    if frac == 0 or math.isinf(v[lo]):
        return v[lo]
    if math.isinf(v[hi]):
        return math.inf
    return v[lo] + (v[hi] - v[lo]) * frac


def read_per_layer(run: Run) -> Dict[str, dict]:
    """Each of the cell's per-layer metrics that its reader finds."""
    out = {}
    for m in run.cell.per_layer:
        path = HERE / "metrics" / f"{m['name']}.py"
        spec = importlib.util.spec_from_file_location(f"portbench_metric_{len(out)}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        value = mod.read(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def forbidden_modules() -> List[str]:
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def driver(name: str):
    return importlib.import_module(f"portbench.drivers.{name}")


def result(run: Run) -> dict:
    """The result line's object; ``checks`` last."""
    import torch

    if run.trace:
        metrics = read_per_layer(run)
    else:
        missing = [m["name"] for m in run.cell.end_to_end
                   if m["name"] != "setup_s" and m["name"] not in run.e2e]
        if missing:
            raise RuntimeError(f"the driver measured no {', '.join(missing)}")
        metrics = {m["name"]: {"value": float(run.setup_s if m["name"] == "setup_s"
                                              else run.e2e[m["name"]]), "unit": m["unit"]}
                   for m in run.cell.end_to_end}
    if run.device == "cuda":
        device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                  "count": run.cell.chips, "memory_peak_bytes": run.memory_peak}
    else:
        device = {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": None}
    out = {"correct": run.correct, "attempted": run.attempted, "failed": run.failed,
           "metrics": metrics, "device": device}
    if run.trace and run.slice is not None:
        device["busy_s"] = run.slice.busy_s
        device["window_s"] = run.slice.window_s
        out["breakdown"] = run.slice.breakdown()
    out["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in run.checks.items()}
    return out
