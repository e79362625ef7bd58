"""No module that a run loads has the top-level name `jax`, `jaxlib`,
`flax` or `tensor2robot_tpu`, compared whole; the reference imports
nothing of the program; no run reads the JAX package's benchmark
files."""

from __future__ import annotations

import ast
import json
import pathlib
import subprocess
import sys

from portbench import harness, hygiene

RUN_ALL_CELLS = """
import sys, time
sys.path.insert(0, {root!r}); sys.path.insert(0, {tests!r})
import torch
torch.set_num_threads(2)
from portbench import harness, hygiene
import conftest
for cell in ("train_seq.b32", "train_critic.b256", "serve_seq.vec64"):
  run = harness.prepare(cell, 7, 0.2, False, "cpu", time.perf_counter())
  conftest.shrink(run)
  harness.execute(run)
import json
print(json.dumps(hygiene.forbidden_modules()))
"""


def test_names_are_compared_by_their_whole_top_level_part():
  assert hygiene.forbidden_modules(
      ["tensor2robot_tpu_torch", "tensor2robot_tpu_torch.ops.attention",
       "jaxtyping", "flaxy", "portbench.harness"]) == []
  assert hygiene.forbidden_modules(
      ["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen",
       "tensor2robot_tpu", "tensor2robot_tpu.specs"]) == [
           "flax.linen", "jax", "jax.numpy", "jaxlib.xla_client",
           "tensor2robot_tpu", "tensor2robot_tpu.specs"]


def test_a_run_of_every_cell_loads_no_forbidden_module(tmp_path):
  tests = pathlib.Path(__file__).resolve().parent
  out = subprocess.run(
      [sys.executable, "-c", RUN_ALL_CELLS.format(root=str(harness.ROOT),
                                                  tests=str(tests))],
      capture_output=True, text=True, timeout=600, cwd=tmp_path)
  assert out.returncode == 0, out.stderr[-2000:]
  assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def _imports(path: pathlib.Path):
  tree = ast.parse(path.read_text())
  for node in ast.walk(tree):
    if isinstance(node, ast.Import):
      yield from (a.name for a in node.names)
    elif isinstance(node, ast.ImportFrom) and node.module:
      yield node.module


def test_the_references_and_counts_import_nothing_of_the_program():
  for kind in ("reference", "counts"):
    for path in (harness.HERE / kind).glob("*.py"):
      for name in _imports(path):
        top = name.split(".")[0]
        assert top in ("torch", "math", "typing", "__future__", "portbench"), \
            (path, name)
        assert name in ("portbench", "portbench.precision",
                        "portbench.peaks") or top != "portbench", (path, name)


def test_no_file_of_the_harness_names_the_jax_benchmark_files():
  for path in harness.HERE.rglob("*.py"):
    if "tests" in path.parts:
      continue
    text = path.read_text()
    for name in ("bench.py", "BENCH_r", "BASELINE.json", "MULTICHIP_"):
      assert name not in text, (path, name)
    for name in _imports(path):
      assert name.split(".")[0] not in hygiene.FORBIDDEN, (path, name)
