"""A new cell, configuration, traffic mix and per-layer metric go in as
new files and new BENCHMARK.json entries, with no edit to a file that is
there: a dummy of each is added to a copy of the benchmark, and the new
cell runs."""

from __future__ import annotations

import json
import pathlib
import shutil
import subprocess
import sys

from portbench import harness

RUN = """
import sys, time, json
sys.path[:0] = [{copy!r}, {root!r}, {tests!r}]
import torch
torch.set_num_threads(2)
from portbench import harness
assert harness.ROOT == __import__("pathlib").Path({copy!r})
import conftest
run = harness.prepare("train_seq.b2", 3, 0.2, False, "cpu", time.perf_counter())
conftest.shrink(run)
run.traffic["batch_size"] = 2
print(json.dumps(harness.execute(run)))
"""


def test_a_dummy_cell_is_added_as_new_files(tmp_path):
  copy = tmp_path / "checkout"
  shutil.copytree(harness.HERE, copy / "portbench",
                  ignore=shutil.ignore_patterns("__pycache__"))
  bench = harness.manifest()
  before = {p.relative_to(copy): p.read_bytes()
            for p in (copy / "portbench").rglob("*") if p.is_file()}

  here = copy / "portbench"
  (here / "configs" / "seq_policy_t4096_copy.json").write_text(
      (here / "configs" / "seq_policy_t4096.json").read_text().replace(
          '"name": "seq_policy_t4096"', '"name": "seq_policy_t4096_copy"'))
  for kind in ("programs", "reference", "counts"):
    (here / kind / "seq_policy_t4096_copy.py").write_text(
        (here / kind / "seq_policy_t4096.py").read_text())
  traffic = json.loads((here / "traffic" / "train_b32.json").read_text())
  traffic["batch_size"] = 2
  (here / "traffic" / "train_b2.json").write_text(json.dumps(traffic))
  (here / "cells" / "train_seq.b2.json").write_text(
      (here / "cells" / "train_seq.b32.json").read_text())
  (here / "layer_metrics" / "steps_seen.py").write_text(
      "def read(run):\n  return run.stats.get('steps')\n")
  bench["configs"].append({**bench["configs"][0],
                           "name": "seq_policy_t4096_copy",
                           "file": "portbench/configs/"
                                   "seq_policy_t4096_copy.json"})
  bench["workloads"].append({"name": "train_seq.b2",
                             "config": "seq_policy_t4096_copy",
                             "traffic": "train_b2", "chips": 1,
                             "why": "a dummy"})
  bench["end_to_end"][0]["workloads"].append("train_seq.b2")
  bench["per_layer"].append({"name": "steps_seen", "unit": "steps",
                             "better": "higher", "source": "host_clock",
                             "layer": "train step",
                             "moves": "examples_per_s",
                             "workloads": ["train_seq.b2"]})
  (copy / "BENCHMARK.json").write_text(json.dumps(bench))

  after = {p.relative_to(copy): p.read_bytes()
           for p in (copy / "portbench").rglob("*") if p.is_file()}
  assert all(after[p] == data for p, data in before.items())

  tests = pathlib.Path(__file__).resolve().parent
  out = subprocess.run(
      [sys.executable, "-c", RUN.format(copy=str(copy),
                                        root=str(harness.ROOT),
                                        tests=str(tests))],
      capture_output=True, text=True, timeout=600, cwd=copy)
  assert out.returncode == 0, out.stderr[-3000:]
  result = json.loads(out.stdout.strip().splitlines()[-1])
  assert result["attempted"] > 0
  assert {"examples_per_s", "setup_s"} <= set(result["metrics"])
