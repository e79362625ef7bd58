"""BENCHMARK.json against the rules of its format, and every file of
every cell found by its name."""

from __future__ import annotations

import json
import re

import pytest

from portbench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def bench():
  return harness.manifest()


def test_top_level_keys_and_command(bench):
  assert set(bench) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
  assert bench["paths"] == ["portbench"]
  assert bench["command"][1].startswith("portbench/")
  assert 1 <= bench["run_seconds"] <= 51
  cells = 24  # the most a later change may reach
  check_s = ((2 + 14 * cells) * (bench["run_seconds"] + 60)
             + cells * 2 * 90 + 1200)
  assert check_s <= 43200
  assert len(json.dumps(bench)) < 64 * 1024


def test_names_and_units_use_the_allowed_characters(bench):
  names = [e["name"] for key in ("configs", "workloads", "end_to_end",
                                 "per_layer") for e in bench[key]]
  names += [w["config"] for w in bench["workloads"]]
  names += [w["traffic"] for w in bench["workloads"]]
  names += [k for c in bench["configs"] for k in c["reduced"]]
  for name in names:
    assert NAME.match(name), name
  for metric in bench["end_to_end"] + bench["per_layer"]:
    assert UNIT.match(metric["unit"]), metric
    assert metric["better"] in ("lower", "higher")
    assert metric["source"] in SOURCES
  for key in ("configs", "workloads", "end_to_end", "per_layer"):
    listed = [e["name"] for e in bench[key]]
    assert len(listed) == len(set(listed)), key


def test_end_to_end_metrics_and_bounds(bench):
  names = {m["name"] for m in bench["end_to_end"]}
  assert names == {"examples_per_s", "control_per_s", "setup_s"}
  for metric in bench["end_to_end"]:
    assert metric["source"] in ("host_clock", "device_trace")
    assert 0.01 <= metric["bound"] <= 0.25


def test_every_moves_is_reported_where_the_layer_metric_is(bench):
  cells = {w["name"] for w in bench["workloads"]}
  for metric in bench["per_layer"]:
    assert "\n" not in metric["layer"]
    for cell in metric.get("workloads", cells):
      assert cell in cells
      reported = {m["name"] for m in
                  harness.cell_metrics(bench, cell)["end_to_end"]}
      assert metric["moves"] in reported, (metric["name"], cell)


def test_every_cell_reports_setup_another_and_a_layer_metric(bench):
  for cell in bench["workloads"]:
    chosen = harness.cell_metrics(bench, cell["name"])
    e2e = {m["name"] for m in chosen["end_to_end"]}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert chosen["per_layer"]
    assert cell["chips"] == 1


def test_every_file_of_every_cell_is_found_by_name(bench):
  for cell in bench["workloads"]:
    run = harness.prepare(cell["name"], 1, 1.0, False, "cpu", 0.0, bench)
    assert run.limits
    harness.load_module("drivers", run.traffic["driver"])
    chosen = harness.cell_metrics(bench, cell["name"])
    for metric in chosen["end_to_end"]:
      assert harness.load_module("end_to_end", metric["name"]).read
    for metric in chosen["per_layer"]:
      assert harness.load_module("layer_metrics", metric["name"]).read


def test_each_configuration_file_states_its_source_and_cuts(bench):
  for entry in bench["configs"]:
    assert entry["file"].startswith("portbench/configs/")
    cfg = harness.load_json(harness.ROOT / entry["file"])
    assert cfg["name"] == entry["name"]
    assert cfg["source"] == entry["source"]
    assert cfg["reduced"] == entry["reduced"]
    for key in ("model", "init", "assumed"):
      assert key in cfg
