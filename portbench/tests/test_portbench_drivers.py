"""Each driver runs a few steps on the CPU, at a tiny size, through the
port's plain kernel versions, and prints one valid last line."""

from __future__ import annotations

import json
import time

import pytest

from portbench import harness
from portbench import run as entry

import conftest

KEYS = {"correct", "attempted", "failed", "metrics", "device"}


def _line(cell, trace, capsys, seed=2**33 + 5):
  run = harness.prepare(cell, seed, 0.5, trace, "cpu", time.perf_counter())
  conftest.shrink(run)
  result = harness.execute(run)
  assert entry.finish(result, "cpu (test)", 1) == 0
  out, err = capsys.readouterr()
  line = json.loads(out.strip().splitlines()[-1])
  assert err.strip().splitlines()[-1].startswith("check ")
  return run, line


@pytest.mark.parametrize("cell", ["train_seq.b32", "train_critic.b256",
                                  "serve_seq.vec64"])
def test_untraced_run_prints_the_end_to_end_metrics(cell, capsys):
  run, line = _line(cell, False, capsys)
  assert KEYS <= set(line)
  assert list(line)[-1] == "checks"
  assert line["attempted"] > 0 and line["failed"] == 0
  chosen = harness.cell_metrics(harness.manifest(), cell)["end_to_end"]
  assert set(line["metrics"]) == {m["name"] for m in chosen}
  for name, metric in line["metrics"].items():
    assert metric["value"] > 0, name
  assert set(line["checks"]) == set(run.limits)


def test_a_sound_tiny_sequence_run_is_correct(capsys):
  _, line = _line("train_seq.b32", False, capsys)
  assert line["correct"] is True, line["checks"]


def test_a_sound_tiny_serving_run_is_correct(capsys):
  _, line = _line("serve_seq.vec64", False, capsys)
  assert line["correct"] is True, line["checks"]
