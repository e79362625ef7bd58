"""Program spans laid against a device trace (`portbench/spans.py`) and
the readers of the `program_span` and `program_counter` metrics, on
synthetic traces; and the span windows themselves on the CPU at a tiny
size (no device events there)."""

from __future__ import annotations

import json
import time

import pytest

from portbench import harness, spans

import conftest

MS = 1_000_000  # ns
MAIN, AUTOGRAD = 100, 200  # OS thread ids
MAIN_IDENT = (0x7F3C << 32) | 0x4DBF_E000  # pthread ids, as get_ident()
AUTOGRAD_IDENT = (0x7F3C << 32) | 0xFF80_0000


def _train_trace(steps=1):
  """`steps` steps of 100 ms: gradients [0, 60) with a batch-norm forward
  at [5, 15) on the main thread and its backward at [20, 40) on the
  autograd thread; update [60, 100)."""
  span_list, device, launches = [], [], {}
  corr = 0

  def launch(at, ident, length=MS):
    nonlocal corr
    corr += 1
    launches[corr] = (at, spans._int32(ident))
    device.append(spans.DeviceEvent(f"k{corr}", at + 2 * MS,
                                    at + 2 * MS + length, corr))

  for i in range(steps):
    o = i * 100 * MS
    span_list += [
        spans.Span("train/step", o, o + 100 * MS, MAIN),
        spans.Span("train/gradients", o, o + 60 * MS, MAIN),
        spans.Span("train/update", o + 60 * MS, o + 100 * MS, MAIN),
        spans.Span("model/batch_norm", o + 5 * MS, o + 15 * MS, MAIN),
        spans.Span("model/batch_norm.backward", o + 20 * MS, o + 40 * MS,
                   AUTOGRAD)]
    launch(o + 2 * MS, MAIN_IDENT)            # forward, outside batch norm
    launch(o + 10 * MS, MAIN_IDENT)           # batch norm's forward
    launch(o + 30 * MS, AUTOGRAD_IDENT, 3 * MS)   # batch norm's backward
    launch(o + 30 * MS + 10, MAIN_IDENT)      # main thread, same moment
    launch(o + 50 * MS, AUTOGRAD_IDENT)       # backward, no span of its own
    launch(o + 70 * MS, MAIN_IDENT, 2 * MS)   # the update
  device.append(spans.DeviceEvent("orphan", 0, MS, 999))  # no launch
  aliases = {spans._int32(MAIN_IDENT): MAIN,
             spans._int32(AUTOGRAD_IDENT): AUTOGRAD}
  return spans.SpanTrace(span_list, device, launches, {}, aliases)


def test_launches_are_joined_by_correlation_and_attributed_by_thread():
  t = _train_trace()
  names = lambda group: [e.name for e in t.launched(group)]
  assert names(["train/step"]) == ["k1", "k2", "k3", "k4", "k5", "k6"]
  assert names(["train/gradients"]) == ["k1", "k2", "k3", "k4", "k5"]
  assert names(["train/update"]) == ["k6"]
  assert names(["model/batch_norm"]) == ["k2"]
  # k4 is launched on the main thread while the backward span is open on
  # the autograd thread: it is not the backward's.
  assert names(["model/batch_norm.backward"]) == ["k3"]
  assert t.device_ms(["model/batch_norm", "model/batch_norm.backward"]) \
      == pytest.approx(4.0)
  assert t.durations_ms("train/update") == [pytest.approx(40.0)]


def test_a_launch_in_the_cpu_traces_thread_ids_matches_too():
  """With the host traced as well, the profiler stamps a launch with the
  OS thread id instead of the pthread id."""
  span_list = [spans.Span("outer", 0, 10 * MS, MAIN),
               spans.Span("inner", 2 * MS, 4 * MS, AUTOGRAD)]
  device = [spans.DeviceEvent("a", 0, MS, 1),
            spans.DeviceEvent("b", 0, MS, 2)]
  t = spans.SpanTrace(span_list, device,
                      {1: (3 * MS, AUTOGRAD), 2: (3 * MS, MAIN)})
  assert [e.name for e in t.launched(["inner"])] == ["a"]
  assert [e.name for e in t.launched(["outer"])] == ["a", "b"]


def test_phase_children_sharing_their_parents_edges_nest():
  span_list = [spans.Span("step", 0, 10, MAIN),
               spans.Span("step/a", 0, 4, MAIN),
               spans.Span("step/b", 4, 10, MAIN)]
  device = [spans.DeviceEvent(n, 0, 1, c) for c, n in
            enumerate(["at0", "at4", "at10"], 1)]
  t = spans.SpanTrace(span_list, device,
                      {1: (0, MAIN), 2: (4, MAIN), 3: (10, MAIN)})
  # A launch on an edge between two children is the later child's.
  assert [e.name for e in t.launched(["step/a"])] == ["at0"]
  assert [e.name for e in t.launched(["step/b"])] == ["at4", "at10"]
  assert len(t.launched(["step"])) == 3


def _run(cell, trace):
  """A run whose span windows were `trace` (training: both windows)."""
  run = harness.prepare(cell, 1, 1.0, True, "cpu", 0.0)
  if trace is not None:
    trace = [trace, trace] if cell.startswith("train") else [trace]
  run.stats["program_spans"] = trace
  return run


def _read(run, name):
  return harness.load_module("layer_metrics", name).read(run)


def test_training_readers():
  run = _run("train_critic.b256", _train_trace(steps=2))
  assert _read(run, "gradients_host_ms.train") == pytest.approx(60.0)
  assert _read(run, "update_host_ms.train") == pytest.approx(40.0)
  assert _read(run, "update_device_ms.train") == pytest.approx(2.0)
  assert _read(run, "launches_per_step.train") == pytest.approx(6.0)
  assert _read(run, "batchnorm_device_ms.train") == pytest.approx(4.0)


def _serve_trace(dispatches=3):
  children = [("admit", 1), ("stack", 2), ("h2d", 3), ("dispatch", 4),
              ("fetch", 5), ("book", 6)]
  span_list = []
  for i in range(dispatches):
    at = i * 100 * MS
    span_list.append(spans.Span("serve/session/step", at,
                                at + (21 + i) * MS, MAIN))
    for name, length in children:
      length += i if name == "fetch" else 0
      span_list.append(spans.Span(f"serve/session/{name}", at,
                                  at + length * MS, MAIN))
      at += length * MS
  return spans.SpanTrace(span_list, [], {},
                         {"serve/session/fetched_bytes": 3584 * dispatches})


def test_serving_readers():
  run = _run("serve_seq.vec64", _serve_trace())
  assert _read(run, "admit_book_ms.serve") == pytest.approx(7.0)
  assert _read(run, "stack_ms.serve") == pytest.approx(2.0)
  assert _read(run, "h2d_ms.serve") == pytest.approx(3.0)
  assert _read(run, "launch_ms.serve") == pytest.approx(4.0)
  assert _read(run, "fetch_ms.serve") == pytest.approx(6.0)
  assert _read(run, "fetch_bytes.serve") == pytest.approx(3584.0)


@pytest.mark.parametrize("name", [
    "admit_book_ms.serve", "stack_ms.serve", "h2d_ms.serve",
    "launch_ms.serve", "fetch_ms.serve", "fetch_bytes.serve",
    "gradients_host_ms.train", "update_host_ms.train",
    "update_device_ms.train", "launches_per_step.train",
    "batchnorm_device_ms.train"])
def test_readers_find_nothing_in_a_port_without_spans(name):
  cell = "serve_seq.vec64" if name.endswith(".serve") else \
      "train_critic.b256"
  assert _read(_run(cell, None), name) is None


def test_a_window_survives_its_trip_through_json():
  t = _train_trace()
  back = spans.SpanTrace.from_json(json.loads(json.dumps(t.to_json())))
  assert back.spans == t.spans and back.device == t.device
  assert [e.name for e in back.launched(["model/batch_norm.backward"])] \
      == ["k3"]


def test_device_readers_find_nothing_without_joined_launches():
  t = _train_trace()
  bare = spans.SpanTrace(t.spans, t.device, {})
  run = _run("train_critic.b256", bare)
  assert _read(run, "update_device_ms.train") is None
  assert _read(run, "launches_per_step.train") is None
  assert _read(run, "gradients_host_ms.train") == pytest.approx(60.0)


def _tiny(cell):
  run = harness.prepare(cell, 2**33 + 7, 0.2, True, "cpu",
                        time.perf_counter())
  conftest.shrink(run)
  return run


def test_serving_window_on_the_cpu_tiles_each_step():
  run = _tiny("serve_seq.vec64")
  run.traffic["trace_seconds"] = 0.1
  t = spans.serving(run)
  steps = t.count("serve/session/step")
  assert steps > 0
  for child in ("admit", "stack", "h2d", "dispatch", "fetch", "book"):
    assert t.count(f"serve/session/{child}") == steps
  total = sum(t.durations_ms("serve/session/step"))
  parts = sum(sum(t.durations_ms(f"serve/session/{c}")) for c in
              ("admit", "stack", "h2d", "dispatch", "fetch", "book"))
  assert parts == pytest.approx(total, rel=1e-3)
  assert _read(run, "fetch_bytes.serve") > 0
  assert spans.serving(run) is t  # measured once a run


def test_training_window_on_the_cpu_records_each_step():
  run = _tiny("train_critic.b256")
  t = spans.training(run)
  steps = run.traffic["enqueue_steps"]
  assert t.count("train/step") == steps
  assert t.count("train/gradients") == t.count("train/update") == steps
  assert t.count("model/batch_norm") == t.count(
      "model/batch_norm.backward") > 0
  assert _read(run, "gradients_host_ms.train") > 0
  assert spans.training(run, device_trace=True).count("train/step") == steps
  assert _read(run, "update_device_ms.train") is None  # no device events
