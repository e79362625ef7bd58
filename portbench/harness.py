"""Runs one cell once: finds its files by name, drives its traffic,
reads its metrics, and assembles the result line.

Everything that belongs to one cell, configuration, traffic mix or
metric is a file of its own, found by its name in `BENCHMARK.json`:

* `configs/<config>.json`: the sizes as run, the source, what was cut;
* `programs/<config>.py`: how the cells build and feed the port;
* `reference/<config>.py`: the plain float32 reference;
* `counts/<config>.py`: the work, counted from shapes;
* `traffic/<traffic>.json`: the mix's parameters and its driver's name;
* `drivers/<driver>.py`: the general generator of that kind of traffic;
* `cells/<cell>.json`: the limits of the numbers that decide `correct`;
* `end_to_end/<metric>.py`, `layer_metrics/<metric>.py`: a reader each,
  `read(run)`, which returns the metric's value or None (nothing to
  read: the metric is left out of the line).
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import pathlib
import sys
import time
import types
from typing import Any, Dict, List, Mapping, Optional

from portbench import compare

ROOT = pathlib.Path(__file__).resolve().parent.parent
HERE = ROOT / "portbench"


def load_json(path: pathlib.Path) -> Any:
  with open(path) as f:
    return json.load(f)


def manifest() -> Dict[str, Any]:
  return load_json(ROOT / "BENCHMARK.json")


def load_module(kind: str, name: str) -> types.ModuleType:
  """`portbench/<kind>/<name>.py`, imported by its path (a name may hold
  dots)."""
  path = HERE / kind / f"{name}.py"
  if not path.is_file():
    raise FileNotFoundError(f"no {kind} named {name!r} ({path})")
  key = f"portbench.{kind}.{name.replace('.', '__')}"
  if key in sys.modules:
    return sys.modules[key]
  spec = importlib.util.spec_from_file_location(key, path)
  module = importlib.util.module_from_spec(spec)
  sys.modules[key] = module
  spec.loader.exec_module(module)
  return module


def cell_metrics(bench: Mapping, cell: str) -> Dict[str, List[Dict]]:
  """The end-to-end and per-layer metric entries that `cell` reports."""
  def applies(entry):
    return "workloads" not in entry or cell in entry["workloads"]

  end_to_end = [m for m in bench["end_to_end"] if applies(m)]
  reported = {m["name"] for m in end_to_end}
  per_layer = [m for m in bench["per_layer"]
               if applies(m) and m["moves"] in reported]
  return {"end_to_end": end_to_end, "per_layer": per_layer}


@dataclasses.dataclass
class Run:
  """One run of one cell: its inputs, and what its driver records."""

  cell: str
  seed: int
  seconds: float
  trace: bool
  device: Any
  t_start: float
  config: Dict[str, Any]
  traffic: Dict[str, Any]
  limits: Dict[str, float]
  program: Optional[types.ModuleType]
  reference: types.ModuleType
  counts: types.ModuleType
  setup_s: Optional[float] = None
  attempted: int = 0
  failed: int = 0
  stats: Dict[str, Any] = dataclasses.field(default_factory=dict)
  trace_summary: Any = None
  gap_trace: Any = None
  memory_peak_bytes: int = 0
  numbers: Dict[str, float] = dataclasses.field(default_factory=dict)

  def mark(self, phase: str) -> None:
    """Records the seconds since the process started at the end of a
    set-up phase (printed on standard error, for where set-up goes)."""
    self.stats.setdefault("setup_phases", {})[phase] = round(
        time.perf_counter() - self.t_start, 3)


def prepare(cell: str, seed: int, seconds: float, trace: bool, device,
            t_start: float, bench: Optional[Mapping] = None) -> Run:
  """The `Run` of `cell`, its files loaded by name."""
  bench = manifest() if bench is None else bench
  entry = next((w for w in bench["workloads"] if w["name"] == cell), None)
  if entry is None:
    raise KeyError(f"no workload named {cell!r} in BENCHMARK.json")
  config = load_json(HERE / "configs" / f"{entry['config']}.json")
  traffic = load_json(HERE / "traffic" / f"{entry['traffic']}.json")
  limits = load_json(HERE / "cells" / f"{cell}.json")["limits"]
  return Run(cell=cell, seed=seed, seconds=seconds, trace=trace,
             device=device, t_start=t_start, config=config,
             traffic=traffic, limits=limits,
             program=load_module("programs", entry["config"]),
             reference=load_module("reference", entry["config"]),
             counts=load_module("counts", entry["config"]))


def execute(run: Run, bench: Optional[Mapping] = None) -> Dict[str, Any]:
  """Drives `run` through its traffic's driver and returns the result
  line's object (without `device`'s name, which the caller adds)."""
  bench = manifest() if bench is None else bench
  load_module("drivers", run.traffic["driver"]).run(run)
  metrics = {}
  chosen = cell_metrics(bench, run.cell)
  entries = chosen["per_layer"] if run.trace else chosen["end_to_end"]
  for entry in entries:
    kind = "layer_metrics" if run.trace else "end_to_end"
    value = load_module(kind, entry["name"]).read(run)
    if value is not None:
      metrics[entry["name"]] = {"value": float(value), "unit": entry["unit"]}
  checks = compare.judge(run.numbers, run.limits)
  result = {"correct": compare.passes(checks), "attempted": run.attempted,
            "failed": run.failed, "metrics": metrics,
            "device": {"memory_peak_bytes": int(run.memory_peak_bytes)}}
  if run.trace and run.trace_summary is not None:
    t = run.trace_summary
    result["device"].update(busy_s=t.busy_s, window_s=t.window_s)
    gaps = run.gap_trace if run.gap_trace is not None else t
    result["breakdown"] = {"device_ops": t.top_ops(10),
                           "idle_gaps": gaps.idle_gaps(10)}
  result["checks"] = checks
  return result
