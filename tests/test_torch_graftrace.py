"""graftrace on the port, against the JAX package: trace contexts, stage
decomposition, shard export, cross-process aggregation, the serving
seams and `graftscope timeline`.

The port of the JAX package's `tests/test_graftrace.py` cases that have
a subject in the port (all but its lint rule, which waits for the
analysis tooling). The framework-free cases run
on both packages (`pkg`): the same assertions hold for each, and where
both read the same shards or record the same stages, their outputs are
equal.

* contexts mint/propagate on the thread-local and are injected into
  every `obs.trace` event through the context provider;
* `stage_breakdown` reconciles the summed stages against
  `serve/request_ms`, with `pad`/`device` excluded from the sum;
* the tracer ring is byte-bounded and `serve/request_ms` carries a
  worst-sample exemplar per window;
* `flush()` writes clock-stamped, ring-bounded shards and never raises;
* `obs.aggregate` aligns clocks, repairs skew, synthesizes flows and
  walks causal chains, and the two packages merge one shard set
  (written by both) into the same timeline;
* the port's `MicroBatcher` (over a numpy backend and over a
  `BucketedEngine`) and `SessionBatcher` record the JAX stage set, the
  request -> dispatch and tick -> batch links, the usage hook and the
  deadline breach, and on the CPU the stage sum reconciles with
  `serve/request_ms` within 5%;
* the loop's causal chain: a replay shard's rotation event links the
  episode spans that fed it, and a publish is parented on the learner
  round that requested it;
* two real processes with a skew far larger than any gap between their
  starts merge causally, and the whole surface runs with torch and jax
  blocked from import.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
import time
import types

import numpy as np
import pytest
import torch

from tensor2robot_tpu import checkpoints as jax_checkpoints
from tensor2robot_tpu import serving as jax_serving
from tensor2robot_tpu.bin import graftscope as jax_graftscope
from tensor2robot_tpu.obs import aggregate as jax_aggregate
from tensor2robot_tpu.obs import graftrace as jax_graftrace
from tensor2robot_tpu.obs import metrics as jax_metrics
from tensor2robot_tpu.loop import publish as jax_publish
from tensor2robot_tpu.loop import replay as jax_replay
from tensor2robot_tpu.obs import trace as jax_trace
from tensor2robot_tpu_torch import checkpoints
from tensor2robot_tpu_torch import serving
from tensor2robot_tpu_torch import specs
from tensor2robot_tpu_torch.bin import graftscope
from tensor2robot_tpu_torch.loop import publish
from tensor2robot_tpu_torch.loop import replay
from tensor2robot_tpu_torch.obs import aggregate
from tensor2robot_tpu_torch.obs import graftrace
from tensor2robot_tpu_torch.obs import metrics
from tensor2robot_tpu_torch.obs import trace
from tensor2robot_tpu_torch.obs import usage
from tensor2robot_tpu_torch.predictors import predictors

torch.set_num_threads(1)

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JOIN_S = 60.0

PACKAGES = {
    "port": types.SimpleNamespace(
        graftrace=graftrace, aggregate=aggregate, trace=trace,
        metrics=metrics, graftscope=graftscope, serving=serving,
        replay=replay, publish=publish, checkpoints=checkpoints),
    "jax": types.SimpleNamespace(
        graftrace=jax_graftrace, aggregate=jax_aggregate, trace=jax_trace,
        metrics=jax_metrics, graftscope=jax_graftscope,
        serving=jax_serving, replay=jax_replay, publish=jax_publish,
        checkpoints=jax_checkpoints),
}


def _reset():
  for p in PACKAGES.values():
    p.trace.disable()
    p.trace.clear()
    p.graftrace._reset_for_tests()


@pytest.fixture(autouse=True)
def _clean_trace_state():
  """Every test starts and ends with disabled, empty tracers and
  disarmed exporters in both packages."""
  _reset()
  yield
  _reset()


@pytest.fixture(params=sorted(PACKAGES))
def pkg(request):
  return PACKAGES[request.param]


def _timed_events(p):
  return [e for e in p.trace.get_tracer().events()
          if e.get("ph") in ("X", "i")]


def _events_named(p, name):
  return [e for e in _timed_events(p) if e["name"] == name]


# -- trace contexts ------------------------------------------------------------


class TestTraceContext:

  def test_mint_child_args(self, pkg):
    root = pkg.graftrace.mint()
    assert root.parent_id is None
    assert "parent_id" not in root.args()
    child = root.child()
    assert child.trace_id == root.trace_id
    assert child.span_id != root.span_id
    assert child.parent_id == root.span_id
    assert child.args() == {"trace_id": root.trace_id,
                            "span_id": child.span_id,
                            "parent_id": root.span_id}

  def test_ids_unique_across_threads(self, pkg):
    ids = []
    lock = threading.Lock()

    def mint_many():
      local = [pkg.graftrace.mint().span_id for _ in range(200)]
      with lock:
        ids.extend(local)

    threads = [threading.Thread(target=mint_many) for _ in range(4)]
    for t in threads:
      t.start()
    for t in threads:
      t.join(JOIN_S)
    assert len(ids) == 800 and len(set(ids)) == len(ids)

  def test_request_context_children_under_activation(self, pkg):
    gt = pkg.graftrace
    assert gt.current() is None
    orphan = gt.request_context()
    assert orphan.parent_id is None
    root = gt.mint()
    with gt.activate(root):
      assert gt.current() is root
      req = gt.request_context()
      assert req.trace_id == root.trace_id
      assert req.parent_id == root.span_id
      with gt.activate(req):
        assert gt.current() is req
      assert gt.current() is root
    assert gt.current() is None

  def test_provider_injects_context_into_events(self, pkg):
    pkg.trace.enable()
    ctx = pkg.graftrace.mint()
    with pkg.graftrace.activate(ctx):
      with pkg.trace.span("inner", cat="t", foo=1):
        pass
      # Explicit args win over the provider on key collision.
      pkg.trace.instant("explicit", span_id="mine")
    inner = _events_named(pkg, "inner")[0]
    assert inner["args"]["trace_id"] == ctx.trace_id
    assert inner["args"]["span_id"] == ctx.span_id
    assert inner["args"]["foo"] == 1
    assert _events_named(pkg, "explicit")[0]["args"]["span_id"] == "mine"
    pkg.trace.instant("bare")
    assert "args" not in _events_named(pkg, "bare")[0]

  def test_contexts_do_not_cross_packages(self):
    """Each package installs its provider into its own tracer: a port
    context never leaks into a JAX event, nor the reverse."""
    trace.enable()
    jax_trace.enable()
    with graftrace.activate(graftrace.mint()):
      trace.instant("port")
      jax_trace.instant("jax")
    assert "args" not in _events_named(PACKAGES["jax"], "jax")[0]
    assert "span_id" in _events_named(PACKAGES["port"], "port")[0]["args"]


# -- stage decomposition -------------------------------------------------------


def _record_stages(p):
  for i in range(10):
    p.graftrace.record_stage("queue_wait", 2.0 + 0.1 * i)
    p.graftrace.record_stage("batch_form", 1.0)
    p.graftrace.record_stage("dispatch", 5.0)
    p.graftrace.record_stage("split", 2.0 - 0.1 * i)
    # Sub-stages INSIDE dispatch: reported, never summed.
    p.graftrace.record_stage("pad", 1.0)
    p.graftrace.record_stage("device", 4.0)
    p.metrics.histogram("serve/request_ms").record(10.0)
  return p.graftrace.stage_breakdown()


class TestStageBreakdown:

  def test_reconciles_summed_stages_against_request_window(self, pkg):
    with pkg.metrics.isolated():
      block = _record_stages(pkg)
    assert block["summed"] == ["queue_wait", "batch_form", "dispatch",
                               "split"]
    assert block["stage_sum_mean_ms"] == pytest.approx(10.0)
    assert block["request_mean_ms"] == pytest.approx(10.0)
    assert block["reconciliation_ratio"] == pytest.approx(1.0)
    assert block["stages"]["device"]["p99_ms"] == pytest.approx(4.0)
    assert block["stages"]["queue_wait"]["count"] == 10.0

  def test_both_packages_break_down_the_same_samples_alike(self):
    blocks = {}
    for which, p in PACKAGES.items():
      with p.metrics.isolated():
        blocks[which] = _record_stages(p)
    assert blocks["port"] == blocks["jax"]

  def test_none_when_no_stage_recorded(self, pkg):
    with pkg.metrics.isolated():
      assert pkg.graftrace.stage_breakdown() is None

  def test_record_stage_emits_trace_event_when_timed(self, pkg):
    pkg.trace.enable()
    ctx = pkg.graftrace.mint()
    with pkg.metrics.isolated():
      start_ns = time.perf_counter_ns()
      pkg.graftrace.record_stage("queue_wait", 1.5, ctx=ctx,
                                 start_ns=start_ns)
      pkg.graftrace.record_stage("queue_wait", 2.5)  # histogram-only
    events = _events_named(pkg, "serve/stage/queue_wait")
    assert len(events) == 1
    assert events[0]["args"]["span_id"] == ctx.span_id
    assert events[0]["dur"] == pytest.approx(1500.0)


# -- tracer ring bounds + histogram exemplars -----------------------------------


class TestRingAndExemplars:

  def test_byte_bound_evicts_oldest_and_counts_drops(self, pkg):
    tracer = pkg.trace.Tracer(max_events=10_000, max_bytes=2_000)
    tracer.enable()
    for i in range(100):
      tracer.instant(f"event-{i:04d}", payload="x" * 64)
    assert tracer.dropped_events > 0
    assert tracer.buffered_bytes <= 2_000
    kept = [e["name"] for e in tracer.events() if e["ph"] == "i"]
    assert kept[-1] == "event-0099"
    assert "event-0000" not in kept

  def test_worst_sample_exemplar_per_window(self, pkg):
    with pkg.metrics.isolated() as registry:
      hist = registry.histogram("serve/request_ms")
      hist.record(5.0, exemplar="trace-fast")
      hist.record(50.0, exemplar="trace-slow")
      hist.record(20.0, exemplar="trace-mid")
      ex = registry.exemplars(clear=True)
      assert ex["serve/request_ms"] == {"value": 50.0,
                                       "trace_id": "trace-slow"}
      assert registry.exemplars() == {}
      hist.record(7.0, exemplar="trace-next")
      assert registry.exemplars()["serve/request_ms"]["trace_id"] == (
          "trace-next")


# -- shard export ----------------------------------------------------------------


class TestShardExport:

  def test_flush_unconfigured_is_noop(self, pkg):
    assert not pkg.graftrace.is_configured()
    assert pkg.graftrace.export_dir() is None
    assert pkg.graftrace.flush() is None

  def test_flush_writes_clock_stamped_shards_and_prunes(self, pkg,
                                                        tmp_path):
    root = str(tmp_path / "trace")
    with pkg.metrics.isolated():
      pkg.graftrace.configure(root, role="test-role", max_gens=2)
      assert pkg.graftrace.export_dir() == root
      assert pkg.trace.get_tracer().enabled  # configure arms the tracer
      paths = []
      for gen in range(3):
        pkg.trace.instant(f"gen-{gen}")
        paths.append(pkg.graftrace.flush())
    pid = os.getpid()
    assert paths[-1].endswith(f"trace-{pid}-000002.json")
    assert sorted(os.listdir(root)) == [f"metrics-{pid}-000001.json",
                                        f"metrics-{pid}-000002.json",
                                        f"trace-{pid}-000001.json",
                                        f"trace-{pid}-000002.json"]
    shard = pkg.aggregate.load_shard(paths[-1])
    assert shard["role"] == "test-role" and shard["gen"] == 2
    assert shard["clock"]["perf_ns"] > 0 and shard["clock"]["epoch_ns"] > 0
    assert [e["name"] for e in shard["traceEvents"]
            if e.get("ph") == "i"] == ["gen-2"]

  def test_flush_never_raises(self, pkg, tmp_path, monkeypatch):
    pkg.graftrace.configure(str(tmp_path / "t"))
    monkeypatch.setattr(json, "dump",
                        lambda *a, **k: (_ for _ in ()).throw(OSError()))
    assert pkg.graftrace.flush() is None  # swallowed: teardown telemetry

  def test_skew_knob_read_from_env(self, pkg, tmp_path, monkeypatch):
    monkeypatch.setenv("GRAFTRACE_EPOCH_SKEW_NS", "-5000000000")
    pkg.graftrace.configure(str(tmp_path / "t"))
    shard = pkg.aggregate.load_shard(pkg.graftrace.flush())
    behind_ns = time.time_ns() - shard["clock"]["epoch_ns"]
    assert behind_ns > 4_000_000_000

  def test_both_packages_write_the_same_shard_layout(self, tmp_path):
    layouts = {}
    for which, p in PACKAGES.items():
      with p.metrics.isolated() as registry:
        p.graftrace.configure(str(tmp_path / which), role="r")
        registry.counter("c").inc(3)
        registry.histogram("serve/request_ms").record(4.0, exemplar="t")
        with p.graftrace.activate(p.graftrace.mint()):
          p.trace.instant("i")
        path = p.graftrace.flush()
      p.trace.disable()
      shard = p.aggregate.load_shard(path)
      mpath = path.replace(os.sep + "trace-", os.sep + "metrics-")
      mshard = p.aggregate.load_metrics_shard(mpath)
      layouts[which] = (
          sorted(shard), sorted(shard["clock"]),
          [(e["name"], e["ph"], sorted(e.get("args", {})))
           for e in shard["traceEvents"] if e.get("ph") == "i"],
          sorted(mshard), mshard["snapshot"], mshard["exemplars"],
          os.path.basename(path))
    assert layouts["port"] == layouts["jax"]


# -- aggregation -----------------------------------------------------------------


def _shard(path, pid, events, perf_ns=0, epoch_ns=0, role="worker"):
  payload = {"graftrace": "v1", "role": role, "pid": pid, "gen": 0,
             "clock": {"perf_ns": perf_ns, "epoch_ns": epoch_ns},
             "traceEvents": events, "displayTimeUnit": "ms"}
  with open(path, "w") as f:
    json.dump(payload, f)


def _evt(name, ts, pid, span_id, parent_id=None, links=None, dur=100.0):
  args = {"trace_id": "t1", "span_id": span_id}
  if parent_id is not None:
    args["parent_id"] = parent_id
  if links is not None:
    args["links"] = links
  return {"name": name, "cat": "t", "ph": "X", "ts": ts, "dur": dur,
          "pid": pid, "tid": 1, "args": args}


def _skewed_pair(root):
  # pid 1111: honest clock. pid 2222: wall clock 3 s BEHIND, so its
  # causally-downstream event would land before its cause.
  _shard(os.path.join(root, "trace-1111-000000.json"), 1111,
         [_evt("proc/a", ts=1000.0, pid=1111, span_id="sA")],
         perf_ns=0, epoch_ns=10_000_000_000, role="parent")
  _shard(os.path.join(root, "trace-2222-000000.json"), 2222,
         [_evt("proc/b", ts=2000.0, pid=2222, span_id="sB",
               parent_id="sA")],
         perf_ns=0, epoch_ns=7_000_000_000, role="child")


class TestAggregate:

  def test_merge_aligns_clocks_and_repairs_skew(self, pkg, tmp_path):
    _skewed_pair(str(tmp_path))
    merged = pkg.aggregate.merge_timeline(str(tmp_path))
    stats = merged["stats"]
    assert stats["shards"] == 2 and stats["skipped"] == 0
    assert stats["processes"] == 2
    assert "2222" in stats["skew_corrected_pids"]
    timed = [e for e in merged["payload"]["traceEvents"]
             if e.get("ph") == "X"]
    by_name = {e["name"]: e for e in timed}
    assert by_name["proc/b"]["ts"] >= by_name["proc/a"]["ts"]
    flows = [e for e in merged["payload"]["traceEvents"]
             if e.get("ph") in ("s", "f")]
    assert stats["flow_links"] == 1 and len(flows) == 2
    assert flows[0]["id"] == flows[1]["id"]
    meta = [e for e in merged["payload"]["traceEvents"]
            if e.get("ph") == "M" and e.get("name") == "process_name"]
    assert {m["args"]["name"] for m in meta} == {"parent (pid 1111)",
                                                "child (pid 2222)"}

  def test_corrupt_and_foreign_shards_skipped_not_raised(self, pkg,
                                                         tmp_path):
    (tmp_path / "trace-1-000000.json").write_text("{truncated")
    (tmp_path / "trace-2-000000.json").write_text(
        json.dumps({"some": "other tool"}))
    _shard(str(tmp_path / "trace-3-000000.json"), 3,
           [_evt("ok", ts=0.0, pid=3, span_id="s1")],
           epoch_ns=1_000_000_000)
    stats = pkg.aggregate.merge_timeline(str(tmp_path))["stats"]
    assert stats["shards"] == 1 and stats["skipped"] == 2
    assert stats["events"] == 1

  def test_has_causal_chain_walk(self, pkg):
    events = [
        _evt("episode", 0.0, 1, "e1"),
        _evt("episode", 1.0, 1, "e2"),
        _evt("shard", 2.0, 1, "sh1", links=["e2"]),
        _evt("round", 3.0, 1, "r1", links=["sh1"]),
        _evt("publish", 4.0, 1, "p1", parent_id="r1"),
    ]
    chain = pkg.aggregate.has_causal_chain
    assert chain(events, ["episode", "shard", "round", "publish"])
    assert chain(events, ["shard", "round"])
    assert chain(events, [])
    assert not chain(events, ["episode", "round"])
    assert not chain(events, ["publish", "episode"])
    assert not chain(events, ["missing"])

  def test_both_packages_merge_one_shard_set_alike(self, tmp_path):
    """Shards written by both packages' exporters (and hand-made skewed
    ones) in one directory merge into the same timeline."""
    root = str(tmp_path)
    _skewed_pair(root)
    for which, p in PACKAGES.items():
      with p.metrics.isolated():
        p.graftrace.configure(os.path.join(root, which), role=which)
        ctx = p.graftrace.mint()
        with p.graftrace.activate(ctx):
          with p.trace.span("serve/request", cat="serve"):
            p.graftrace.record_stage("queue_wait", 1.0, ctx=ctx,
                                     start_ns=time.perf_counter_ns())
        p.graftrace.flush()
      p.trace.disable()
    merged = {which: p.aggregate.merge_timeline(root)
              for which, p in PACKAGES.items()}
    assert merged["port"] == merged["jax"]
    assert merged["port"]["stats"]["shards"] == 4


# -- the serving seams -------------------------------------------------------------


class _RowBackend:

  def __init__(self, delay_s=0.0):
    self._delay_s = delay_s

  def __call__(self, features):
    if self._delay_s:
      time.sleep(self._delay_s)
    return {"out": np.asarray(features["x"]) * 2.0}


class _StubEngine:
  """The session engine surface `SessionBatcher` drives."""

  _max_tick_batch = 8
  max_tick_batch = 8

  def open(self):
    return 7

  def close_session(self, sid):
    pass

  def step_many(self, items):
    return [{"out": np.zeros((1,), np.float32)} for _ in items]


def _bundle_predictor(delay_s=0.0):
  """A `serving_bundle` predictor over a torch function (CPU)."""

  def predict_fn(state, features):
    if delay_s:
      time.sleep(delay_s)
    return {"out": features["x"] * 2.0}

  class _Predictor:
    def serving_bundle(self):
      return predictors.ServingBundle(
          predict_fn=predict_fn, get_state=lambda: None,
          preprocess=lambda f: specs.SpecStruct(
              {k: torch.as_tensor(v) for k, v in f.items()}),
          feature_spec=specs.SpecStruct(
              {"x": specs.TensorSpec(shape=(2,), dtype=np.float32)}))

  return _Predictor()


def _micro_batcher_one_request(p):
  """One request through the package's MicroBatcher under a router
  context: (snapshot, exemplars, root, events)."""
  p.trace.enable()
  root = p.graftrace.mint()
  with p.metrics.isolated() as registry:
    with p.serving.MicroBatcher(backend=_RowBackend(), max_batch_size=4,
                                max_delay_ms=2.0) as batcher:
      with p.graftrace.activate(root):
        batcher.predict({"x": np.ones((1, 2), np.float32)})
    snap = registry.snapshot()
    exemplars = registry.exemplars()
  return snap, exemplars, root, _timed_events(p)


class TestServingPropagation:

  def test_router_context_flows_through_micro_batcher(self):
    snap, exemplars, root, _ = _micro_batcher_one_request(
        PACKAGES["port"])
    p = PACKAGES["port"]
    for stage in graftrace.SUMMED_STAGES:
      assert snap[f"hist/serve/stage/{stage}_ms/count"] == 1.0
    assert exemplars["serve/request_ms"]["trace_id"] == root.trace_id
    requests = _events_named(p, "serve/request")
    assert len(requests) == 1
    assert requests[0]["args"]["trace_id"] == root.trace_id
    assert requests[0]["args"]["parent_id"] == root.span_id
    batches = _events_named(p, "serve/batcher/dispatch")
    assert batches and requests[0]["args"]["span_id"] in (
        batches[0]["args"]["links"])
    queue_waits = _events_named(p, "serve/stage/queue_wait")
    assert queue_waits[0]["args"]["trace_id"] == root.trace_id
    assert aggregate.has_causal_chain(
        _timed_events(p), ["serve/request", "serve/batcher/dispatch"])

  def test_micro_batcher_records_what_the_jax_batcher_records(self):
    """One request through each package's batcher: the same metric keys
    and the same events (names, categories and arg keys)."""
    out = {}
    for which, p in PACKAGES.items():
      snap, _, _, events = _micro_batcher_one_request(p)
      p.trace.disable()
      out[which] = (
          sorted(k for k in snap if not k.startswith("gauge/")),
          sorted((e["name"], e.get("cat"), tuple(sorted(e.get("args", {}))))
                 for e in events))
    assert out["port"] == out["jax"]

  def test_session_batcher_records_tick_stages(self):
    trace.enable()
    root = graftrace.mint()
    ledger = usage.UsageLedger(name="t/usage")
    with metrics.isolated() as registry:
      with serving.SessionBatcher(engine=_StubEngine(), max_delay_ms=1.0,
                                  usage=ledger.recorder("s")) as front:
        sid = front.open()
        with graftrace.activate(root):
          for _ in range(3):
            front.step(sid, {"observation": np.zeros((2,), np.float32)})
        front.close_session(sid)
      snap = registry.snapshot()
      summary = ledger.summary()
    assert snap["hist/serve/stage/queue_wait_ms/count"] == 3.0
    assert snap["hist/serve/stage/dispatch_ms/count"] == 3.0
    assert summary["groups"]["s"]["requests"] == 3
    assert snap["counter/t/usage/busy_requests/s"] == 3.0
    batches = _events_named(PACKAGES["port"], "serve/session/batch")
    assert len(batches) == 3
    linked = set()
    for batch in batches:
      linked.update(batch["args"].get("links", []))
    ticks = _events_named(PACKAGES["port"], "serve/stage/queue_wait")
    assert len(ticks) == 3
    assert all(t["args"]["trace_id"] == root.trace_id for t in ticks)
    assert all(t["args"]["span_id"] in linked for t in ticks)
    assert aggregate.has_causal_chain(
        _timed_events(PACKAGES["port"]),
        ["serve/stage/dispatch", "serve/session/batch"])

  def test_session_batchers_record_the_same_stages(self):
    out = {}
    for which, p in PACKAGES.items():
      p.trace.enable()
      with p.metrics.isolated() as registry:
        with p.serving.SessionBatcher(engine=_StubEngine(),
                                      max_delay_ms=1.0) as front:
          sid = front.open()
          for _ in range(2):
            front.step(sid, {"observation": np.zeros((2,), np.float32)})
        snap = registry.snapshot()
      p.trace.disable()
      out[which] = (
          {k: v for k, v in snap.items() if k.endswith("/count")},
          sorted((e["name"], tuple(sorted(e.get("args", {}))))
                 for e in _timed_events(p)))
    assert out["port"] == out["jax"]

  def test_engine_records_pad_and_device_under_the_batch_context(self):
    trace.enable()
    ledger = usage.UsageLedger(name="t/usage")
    with metrics.isolated() as registry:
      engine = serving.BucketedEngine(predictor=_bundle_predictor(),
                                      max_batch_size=4)
      engine.warmup()
      with serving.MicroBatcher(backend=engine, max_batch_size=4,
                                max_delay_ms=1.0,
                                usage=ledger.recorder("critic")) as front:
        for rows in (3, 4):  # rung 4: padded, then exact
          out = front.predict({"x": np.ones((rows, 2), np.float32)})
          np.testing.assert_array_equal(out["out"], 2.0)
      snap = registry.snapshot()
      summary = ledger.summary()
    assert snap["hist/serve/stage/pad_ms/count"] == 1.0
    assert snap["hist/serve/stage/device_ms/count"] == 2.0
    busy_ms = summary["groups"]["critic"]["device_seconds_busy"] * 1e3
    assert 0.0 < snap["counter/serve/engine/device_busy_ms"]
    # The device window lies inside the dispatch window the ledger
    # charges (the ledger rounds its seconds to 4 places).
    assert snap["counter/serve/engine/device_busy_ms"] <= busy_ms + 0.05
    assert summary["groups"]["critic"]["requests"] == 2
    events = _timed_events(PACKAGES["port"])
    dispatches = {e["args"]["span_id"]
                  for e in events if e["name"] == "serve/batcher/dispatch"}
    inner = [e for e in events
             if e["name"] in ("serve/stage/pad", "serve/stage/device",
                              "serve/engine/predict")]
    assert len(inner) == 5
    assert all(e["args"]["span_id"] in dispatches for e in inner)

  def test_deadline_shed_counts_one_slo_breach(self):
    """A positive deadline far below one dispatch sheds every time (a
    deadline of 0 is no deadline at all)."""
    with metrics.isolated() as registry:
      with serving.MicroBatcher(backend=_RowBackend(), max_batch_size=4,
                                max_delay_ms=1.0) as front:
        with pytest.raises(serving.DeadlineError):
          front.predict({"x": np.ones((1, 2), np.float32)},
                        deadline_ms=1e-3)
        front.predict({"x": np.ones((1, 2), np.float32)}, deadline_ms=0)
      snap = registry.snapshot()
    assert snap["counter/serve/slo_breaches"] == 1.0
    assert snap["counter/serve/batcher/shed_deadline"] == 1.0
    assert snap["counter/serve/batcher/batches"] == 1.0

  def test_stage_sum_reconciles_with_the_request_window(self):
    """Concurrent clients over a batcher whose dispatch takes 40 ms: the
    four summed stages account for `serve/request_ms` within 5% (the
    residual is each client's wakeup, which a loaded host stretches to
    a millisecond or two)."""
    errors = []
    with metrics.isolated():
      with serving.MicroBatcher(backend=_RowBackend(delay_s=0.04),
                                max_batch_size=4,
                                max_delay_ms=2.0) as front:
        def client(seed):
          try:
            for i in range(12):
              rows = 1 + (seed + i) % 2
              front.predict({"x": np.ones((rows, 2), np.float32)})
          except Exception as e:  # noqa: BLE001 - surfaced below
            errors.append(e)

        threads = [threading.Thread(target=client, args=(s,))
                   for s in range(4)]
        for t in threads:
          t.start()
        for t in threads:
          t.join(JOIN_S)
      block = graftrace.stage_breakdown()
    assert not errors, errors
    assert block["stages"]["dispatch"]["count"] == 48.0
    assert 0.95 <= block["reconciliation_ratio"] <= 1.05, block

  def test_bypass_is_one_dispatch_stage_and_one_usage_window(self):
    ledger = usage.UsageLedger(name="t/usage")
    with metrics.isolated() as registry:
      with serving.MicroBatcher(backend=_RowBackend(), max_batch_size=2,
                                usage=ledger.recorder("g")) as front:
        front.predict({"x": np.ones((5, 2), np.float32)})
      snap = registry.snapshot()
    assert snap["counter/serve/batcher/bypass"] == 1.0
    assert snap["hist/serve/stage/dispatch_ms/count"] == 1.0
    assert "hist/serve/stage/queue_wait_ms/count" not in snap
    assert ledger.summary()["groups"]["g"]["requests"] == 1

  def test_closing_a_batcher_flushes_a_shard(self, tmp_path):
    root = str(tmp_path / "shards")
    with metrics.isolated():
      graftrace.configure(root, role="batcher", max_gens=64)
      with serving.MicroBatcher(backend=_RowBackend()) as front:
        front.predict({"x": np.ones((1, 2), np.float32)})
      with serving.SessionBatcher(engine=_StubEngine()) as front:
        front.step(front.open(), {"observation": np.zeros((2,))})
    names = sorted(os.listdir(root))
    # The MicroBatcher flushes when its worker ends and again at close;
    # the SessionBatcher when its worker ends: three generations.
    pid = os.getpid()
    assert names == sorted([f"{kind}-{pid}-{gen:06d}.json"
                            for kind in ("metrics", "trace")
                            for gen in range(3)])
    merged = aggregate.merge_timeline(root)["payload"]["traceEvents"]
    assert aggregate.has_causal_chain(
        merged, ["serve/request", "serve/batcher/dispatch"])
    assert aggregate.has_causal_chain(
        merged, ["serve/stage/dispatch", "serve/session/batch"])


# -- the loop's causal chain --------------------------------------------------------


class TestLoopCausality:

  def test_replay_shard_links_episode_spans(self, pkg, tmp_path):
    pkg.trace.enable()
    ep1, ep2 = pkg.graftrace.mint(), pkg.graftrace.mint()
    with pkg.metrics.isolated():
      sink = pkg.replay.ReplayRecordSink(str(tmp_path / "r"),
                                         episodes_per_shard=2)
      with sink:
        with pkg.graftrace.activate(ep1):
          assert sink.append_episode([b"x" * 64])
        # An explicit carrier beats the thread-local (the cross-thread
        # hand-off path).
        assert sink.append_episode([b"y" * 64], trace_ctx=ep2)
        shards = sink.finished_shards()
      assert len(shards) == 1
      spans = sink.shard_spans()
      assert set(spans) == {shards[0]}
    shard_events = _events_named(pkg, "loop/replay/shard")
    assert len(shard_events) == 1
    args = shard_events[0]["args"]
    assert args["span_id"] == spans[shards[0]]
    assert set(args["links"]) == {ep1.span_id, ep2.span_id}
    # The chain is walkable from either episode to the shard event.
    episode_evt = _evt("loop/episode", 0.0, os.getpid(), ep1.span_id)
    assert pkg.aggregate.has_causal_chain(
        [episode_evt] + shard_events, ["loop/episode",
                                       "loop/replay/shard"])

  def test_publish_parented_on_learner_round_context(self, pkg, tmp_path):

    class _Fleet:
      # The publisher records the span under what the fleet serves after
      # the rollout (fleet.global_step), not the intent.
      global_step = 10

      def rollout(self, probe_request=None, verify=None,
                  drain_timeout_s=0.0):
        return {"swapped": 1, "aborted": None, "parity_ok": True,
                "canary_index": 0}

    ckpt = str(tmp_path / "ckpt")
    step_dir = os.path.join(ckpt, "10")
    os.makedirs(step_dir)
    with open(os.path.join(step_dir, "state.bin"), "wb") as f:
      f.write(b"params10")
    pkg.checkpoints.write_manifest(ckpt, 10)

    pkg.trace.enable()
    round_ctx = pkg.graftrace.mint()
    with pkg.metrics.isolated():
      pub = pkg.publish.CheckpointPublisher(_Fleet(), ckpt)
      # The learner requests publication inside its round activation, as
      # the loop's learner does around train_eval_model.
      with pkg.graftrace.activate(round_ctx):
        pub.request_publish(10)
      report = pub.publish(10)
      assert report["published"]
    events = _events_named(pkg, "loop/publish")
    assert len(events) == 1
    args = events[0]["args"]
    assert args["trace_id"] == round_ctx.trace_id
    assert args["parent_id"] == round_ctx.span_id
    assert args["step"] == 10 and args["ordinal"] == 1
    assert pub.publish_span_id(10) == args["span_id"]
    assert pub.publish_span_id(99) is None


# -- graftscope timeline ------------------------------------------------------------


class TestTimelineCli:

  def test_merges_real_shards_to_perfetto_json(self, pkg, tmp_path,
                                               capsys):
    root = str(tmp_path / "run")
    with pkg.metrics.isolated():
      pkg.graftrace.configure(root, role="cli-test")
      with pkg.graftrace.activate(pkg.graftrace.mint()):
        with pkg.trace.span("serve/request", cat="serve"):
          pass
      pkg.graftrace.flush()
    out = str(tmp_path / "merged.json")
    assert pkg.graftscope.main(["timeline", root, "--out", out]) == 0
    assert "1 shard(s)" in capsys.readouterr().out
    with open(out) as f:
      payload = json.load(f)
    assert "serve/request" in [e.get("name") for e in
                               payload["traceEvents"]]
    assert payload["displayTimeUnit"] == "ms"

  def test_exit_codes(self, pkg, tmp_path, capsys):
    assert pkg.graftscope.main(
        ["timeline", str(tmp_path / "missing")]) == 2
    empty = tmp_path / "empty"
    empty.mkdir()
    assert pkg.graftscope.main(["timeline", str(empty)]) == 1
    capsys.readouterr()

  def test_both_clis_write_the_same_timeline(self, tmp_path, capsys):
    root = str(tmp_path / "run")
    _skewed_pair(os.makedirs(root) or root)
    texts, payloads = {}, {}
    for which, p in PACKAGES.items():
      out = str(tmp_path / f"{which}.json")
      assert p.graftscope.main(["timeline", root, "--out", out]) == 0
      texts[which] = capsys.readouterr().out.replace(out, "<out>")
      with open(out) as f:
        payloads[which] = json.load(f)
    assert texts["port"] == texts["jax"]
    assert "clock-skew repair" in texts["port"]
    assert payloads["port"] == payloads["jax"]


# -- processes ---------------------------------------------------------------------

_BLOCK = ("import sys\n"
          "for _name in ('torch', 'jax', 'tensor2robot_tpu'):\n"
          "  sys.modules[_name] = None\n")

_CHILD_CODE = _BLOCK + """
from tensor2robot_tpu_torch.obs import graftrace
from tensor2robot_tpu_torch.obs import trace as obs_trace
root, role, parent_span = sys.argv[1], sys.argv[2], sys.argv[3]
graftrace.configure(root, role=role)
ctx = graftrace.mint()
if parent_span != "-":
  ctx = graftrace.TraceContext("shared-trace", ctx.span_id, parent_span)
obs_trace.instant("proc/" + role, cat="test", **ctx.args())
path = graftrace.flush()
assert path is not None, "flush produced no shard"
print("SPAN=" + ctx.span_id)
"""


def _run_child(root, role, parent_span, skew_ns):
  env = {**os.environ, "PYTHONPATH": REPO_ROOT,
         "GRAFTRACE_EPOCH_SKEW_NS": str(skew_ns)}
  result = subprocess.run(
      [sys.executable, "-c", _CHILD_CODE, root, role, parent_span],
      capture_output=True, text=True, timeout=120, cwd=REPO_ROOT, env=env)
  assert result.returncode == 0, result.stderr[-2000:]
  for line in result.stdout.splitlines():
    if line.startswith("SPAN="):
      return line[len("SPAN="):]
  raise AssertionError(f"no span id printed: {result.stdout!r}")


def test_two_subprocesses_with_skewed_clocks_merge_causally(tmp_path):
  """Two real processes, the second's event causally parented on the
  first's and its wall clock stamped 60 s behind: far more than any gap
  between the two starts, so the merge must repair it whatever the
  machine's load."""
  root = str(tmp_path)
  upstream = _run_child(root, "upstream", "-", skew_ns=0)
  _run_child(root, "downstream", upstream, skew_ns=-60_000_000_000)
  for p in PACKAGES.values():
    merged = p.aggregate.merge_timeline(root)
    stats = merged["stats"]
    assert stats["shards"] == 2 and stats["processes"] == 2
    assert stats["flow_links"] >= 1
    (shift_ms,) = stats["skew_corrected_pids"].values()
    assert shift_ms > 50_000.0
    events = [e for e in merged["payload"]["traceEvents"]
              if e.get("ph") == "i"]
    by_name = {e["name"]: e for e in events}
    assert (by_name["proc/downstream"]["ts"]
            >= by_name["proc/upstream"]["ts"])
    assert p.aggregate.has_causal_chain(
        events, ["proc/upstream", "proc/downstream"])


def test_graftrace_surface_runs_with_torch_and_jax_blocked(tmp_path):
  """graftrace, aggregate, usage, slo, the micro-batcher and the timeline
  and watch CLIs run end to end in a process where torch, jax and the
  JAX package cannot be imported."""
  code = _BLOCK + """
import json, os
import numpy as np
from tensor2robot_tpu_torch.obs import aggregate, graftrace, slo, usage
from tensor2robot_tpu_torch.obs import trace as obs_trace
import importlib.util
# The batcher module itself imports no torch (the serving package's
# __init__ imports the engines, which do): load it by path.
spec = importlib.util.spec_from_file_location(
    "batcher", os.path.join("tensor2robot_tpu_torch", "serving", "batcher.py"))
batcher = importlib.util.module_from_spec(spec)
spec.loader.exec_module(batcher)
root = sys.argv[1]
graftrace.configure(root, role="blocked")
ledger = usage.UsageLedger()
with batcher.MicroBatcher(backend=lambda f: {"y": f["x"]},
                          usage=ledger.recorder("g")) as front:
  front.predict({"x": np.ones((1, 1), np.float32)})
ledger.summary()
path = graftrace.flush()
assert path is not None
from tensor2robot_tpu_torch.bin import graftscope
from tensor2robot_tpu_torch.loop import publish
from tensor2robot_tpu_torch.loop import replay
assert graftscope.main(["timeline", root]) == 0
payload = json.load(open(os.path.join(root, "timeline.json")))
assert aggregate.has_causal_chain(payload["traceEvents"],
                                  ["serve/request", "serve/batcher/dispatch"])
assert graftscope.main(["watch", root, "--snapshot", "--json"]) == 0
loaded = [m for m in ("torch", "jax") if sys.modules.get(m)]
assert not loaded, loaded
print("GRAFTRACE_FRAMEWORK_FREE_OK")
"""
  result = subprocess.run(
      [sys.executable, "-c", code, str(tmp_path / "run")],
      capture_output=True, text=True, timeout=120, cwd=REPO_ROOT,
      env={**os.environ, "PYTHONPATH": REPO_ROOT})
  assert result.returncode == 0, (result.stdout[-2000:],
                                  result.stderr[-2000:])
  assert "GRAFTRACE_FRAMEWORK_FREE_OK" in result.stdout
