"""The port's telemetry modules against the JAX package's, on the CPU.

The same inputs go through the JAX module and the port's, and the outputs
are compared EXACTLY (both are pure-Python arithmetic over the same
values):

* `obs.faultlab`: fire sequences, fired events and summaries over several
  seeds and specs (`at`, `every`, `count`, `rate`, keys), and the
  crc32-derived draw itself;
* `obs.sentinel`: the incidents of synthetic step-record and metric
  streams (spike, regime shift, barrier-dominated skip, starvation,
  non-finite parameters and metrics with their latches and re-arm, HBM
  drift and a slow leak), under one fixed clock;
* `obs.stepstats`: the window records of a scripted clock patched into
  both modules (the port's `compile` is 0 on every window: eager PyTorch
  compiles nothing; the JAX package counts its first dispatch);
* `obs.runlog`: `make_record`, `step_stats_summary`, `key_metrics`,
  `diff_records` / `format_diff`, `trend_records` / `format_trend` and
  `history_lines`;
* `obs.flightrec`: the bundles of the same steps and incidents (a NaN
  survives strict JSON), and a SIGTERM dump in a subprocess that has
  torch and jax blocked;
* `obs.xray.memory_accounting` of a bridged small `TrainState` against
  the JAX package's on the same parameters and batch.
"""

from __future__ import annotations

import json
import os
import random
import signal
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from tensor2robot_tpu.models import sequence_model as jax_sequence_model
from tensor2robot_tpu.obs import faultlab as jax_faultlab
from tensor2robot_tpu.obs import flightrec as jax_flightrec
from tensor2robot_tpu.obs import metrics as jax_metrics
from tensor2robot_tpu.obs import runlog as jax_runlog
from tensor2robot_tpu.obs import sentinel as jax_sentinel
from tensor2robot_tpu.obs import stepstats as jax_stepstats
from tensor2robot_tpu.obs import xray as jax_xray
from tensor2robot_tpu.parallel import train_step as jax_train_step
from tensor2robot_tpu.utils import backend as jax_backend
from tensor2robot_tpu_torch import bridge
from tensor2robot_tpu_torch.obs import faultlab
from tensor2robot_tpu_torch.obs import flightrec
from tensor2robot_tpu_torch.obs import metrics
from tensor2robot_tpu_torch.obs import runlog
from tensor2robot_tpu_torch.obs import sentinel
from tensor2robot_tpu_torch.obs import stepstats
from tensor2robot_tpu_torch.obs import xray
from tensor2robot_tpu_torch.utils import backend

torch.set_num_threads(1)

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLOCK = 1792000000.25


@pytest.fixture(autouse=True)
def _fresh_heartbeats():
  jax_backend.heartbeat_monitor().reset()
  backend.heartbeat_monitor().reset()
  yield
  jax_backend.heartbeat_monitor().reset()
  backend.heartbeat_monitor().reset()


# -- faultlab ------------------------------------------------------------------

_PLANS = [
    [dict(point="train.nonfinite", at=(2, 5))],
    [dict(point="ckpt.torn", every=3, count=2),
     dict(point="ckpt.bitflip", at=(1,))],
    [dict(point="serve.dispatch", rate=0.3, key=1),
     dict(point="serve.dispatch", every=4)],
    [dict(point="data.corrupt_record", rate=0.5, count=4),
     dict(point="data.preprocess", every=2, count=3),
     dict(point="data.record_io", at=(0, 7))],
    [dict(point="loop.actor_crash", rate=0.2, key=0),
     dict(point="loop.actor_hang", every=5, arg=1.5),
     dict(point="serve.latency", rate=1.0, count=2, arg=25.0)],
]
_ARRIVALS = [(point, key) for point in sorted(faultlab.KNOWN_POINTS)
             for key in (None, 0, 1)]


def _fire_sequence(module, specs, seed, order):
  plan = module.FaultPlan([module.FaultSpec(**spec) for spec in specs],
                          seed=seed, registry=module.metrics_lib.Registry()
                          if hasattr(module, "metrics_lib") else None)
  fires = []
  with plan.activated():
    for point, key in order:
      spec = module.maybe_fire(point, key=key)
      fires.append(None if spec is None else (spec.point, spec.key,
                                              spec.arg))
  assert module.active() is None
  return fires, plan.fired(), plan.summary()


@pytest.mark.parametrize("seed", [0, 1, 7, 13])
@pytest.mark.parametrize("plan_index", range(len(_PLANS)))
def test_fault_plans_fire_the_same_arrivals(seed, plan_index):
  order = [random.Random(seed + 100 * plan_index).choice(_ARRIVALS)
           for _ in range(240)]
  with metrics.isolated(), jax_metrics.isolated():
    got = _fire_sequence(faultlab, _PLANS[plan_index], seed, order)
    want = _fire_sequence(jax_faultlab, _PLANS[plan_index], seed, order)
    assert metrics.snapshot(prefix="faultlab/") == jax_metrics.snapshot(
        prefix="faultlab/")
  assert got == want
  assert got[2]["injected"] == sum(f is not None for f in got[0])


def test_fault_draws_specs_and_config_match():
  for n in range(500):
    for key in (None, 0, 3, "replica-2"):
      assert faultlab._unit(n % 17, "serve.dispatch", key, n) == \
          jax_faultlab._unit(n % 17, "serve.dispatch", key, n)
  assert faultlab.KNOWN_POINTS == jax_faultlab.KNOWN_POINTS
  assert len(faultlab.KNOWN_POINTS) == 10
  for bad in (dict(point="nope", at=(1,)), dict(point="ckpt.torn"),
              dict(point="ckpt.torn", at=(1,), every=2),
              dict(point="ckpt.torn", rate=1.5),
              dict(point="ckpt.torn", every=-2),
              dict(point="ckpt.torn", at=(-1,))):
    with pytest.raises(ValueError) as got:
      faultlab.FaultSpec(**bad)
    with pytest.raises(ValueError) as want:
      jax_faultlab.FaultSpec(**bad)
    assert str(got.value) == str(want.value)
  config = {"seed": 5, "faults": [{"point": "train.nonfinite",
                                   "at": [3]}]}
  assert (faultlab.FaultPlan.from_config(config).summary()
          == jax_faultlab.FaultPlan.from_config(config).summary())


# -- sentinel ------------------------------------------------------------------

def _steady(step_ms=100.0, wait_ms=5.0, **kw):
  record = {"step_ms": step_ms, "data_wait_ms": wait_ms,
            "barrier_dominated": 0.0, "nonfinite_params": 0.0}
  record.update(kw)
  return record


def _sentinel_stream():
  """(method, step, payload) events: every detector fires, latches and
  re-arms at least once."""
  rs = np.random.RandomState(3)
  events = []
  step = 0

  def window(**kw):
    nonlocal step
    step += 1
    events.append(("step", step, _steady(**kw)))

  for _ in range(12):
    window(step_ms=100.0 + rs.rand() * 4.0)
  window(step_ms=900.0)                          # spike, one incident
  window(step_ms=950.0)                          # same episode
  window(step_ms=101.0)
  window(step_ms=5000.0, barrier_dominated=1.0)  # skipped entirely
  for _ in range(6):
    window(step_ms=400.0)                        # regime shift adapts
  for _ in range(4):
    window(step_ms=400.0, wait_ms=350.0)         # starvation after 3
  window(step_ms=400.0, wait_ms=10.0)
  for _ in range(2):
    window(step_ms=400.0, wait_ms=390.0)         # two: no incident
  window(nonfinite_params=1.0)                   # fatal, latched
  window(nonfinite_params=1.0)
  window(nonfinite_params=0.0)
  window(nonfinite_params=1.0)                   # re-armed by a finite one
  events.append(("metrics", step, {"loss": float("nan"), "mse": 1.0}))
  events.append(("metrics", step, {"loss": float("inf")}))    # latched
  events.append(("metrics", step, {"loss": np.float32(0.5),
                                   "mse": np.array([float("nan")]),
                                   "vec": np.zeros(3), "name": "x"}))
  events.append(("metrics", step, {"loss": float("nan")}))    # re-armed
  events.append(("reset", step, None))
  events.append(("metrics", step, {"loss": float("nan")}))    # after reset
  gib = float(2**30)
  for value in (1.0, 1.1, 1.3, 1.35, 1.4, 1.5, 1.62, 1.75, 1.9, 2.1):
    window(device_bytes_in_use=value * gib)      # drift + slow leak
  window(live_bytes=8.0 * gib)                   # fallback key
  window(device_bytes_in_use=float("nan"))
  return events


def _run_sentinel(module, events):
  seen = []
  watcher = module.Sentinel(sinks=[seen.append], clock=lambda: CLOCK,
                            registry=module.metrics_lib.Registry())
  for method, step, payload in events:
    if method == "step":
      watcher.observe_step_record(step, payload)
    elif method == "metrics":
      watcher.observe_metrics(step, payload)
    else:
      watcher.reset_nonfinite_latch()
  return watcher.incidents(), watcher.summary(), seen


def test_sentinel_incidents_match_on_synthetic_streams():
  events = _sentinel_stream()
  got = _run_sentinel(sentinel, events)
  want = _run_sentinel(jax_sentinel, events)
  assert got == want
  incidents, summary, _ = got
  assert summary["by_kind"] == {
      "step_time_spike": 2, "data_starvation": 1, "nonfinite_params": 2,
      "nonfinite_metric": 4, "hbm_drift": 4}, summary
  assert all(json.dumps(i, allow_nan=False) for i in incidents)
  assert sentinel.SentinelConfig() == sentinel.SentinelConfig(
      **jax_sentinel.SentinelConfig().__dict__)
  for elapsed, slo in ((10.0, 20.0), (30.0, 20.0), (30.0, None)):
    assert sentinel.observe_serving_latency(
        elapsed, slo, metrics.Registry()) == \
        jax_sentinel.observe_serving_latency(elapsed, slo,
                                             jax_metrics.Registry())


# -- stepstats -------------------------------------------------------------------

class _ScriptedTime:
  """A `time` module whose perf_counter_ns advances by seeded steps."""

  def __init__(self, seed):
    self._rs = np.random.RandomState(seed)
    self._now = 10**12

  def perf_counter_ns(self):
    self._now += int(self._rs.randint(1, 40)) * 250_000
    return self._now


def _run_recorder(module, monkeypatch, every_n, schedule, barrier_values):
  monkeypatch.setattr(module, "time", _ScriptedTime(11))
  values = iter(barrier_values)
  registry = module.metrics_lib.Registry()
  rec = module.StepStatsRecorder(
      batch_size=8, every_n_steps=every_n,
      barrier=lambda state: next(values), registry=registry,
      tracer=module.trace_lib.Tracer(), device_gauges=False)
  seen = []
  rec.add_observer(lambda step, record: seen.append((step, dict(record))))
  step = 0
  rec.start()
  with rec.data_wait():
    pass
  for k in schedule:
    rec.before_dispatch()
    rec.after_dispatch()
    step += k
    with rec.data_wait():
      pass
    rec.end_step(step, state=object(), num_steps=k)
  records = rec.drain()
  assert records == seen
  return records, {key: value for key, value in registry.snapshot().items()
                   if key.startswith("hist/stepstats/")}


@pytest.mark.parametrize("every_n,schedule", [
    (1, [1] * 12), (3, [1] * 10), (2, [1, 3, 1, 1, 2, 4])])
def test_step_stats_records_match_under_a_scripted_clock(
    monkeypatch, every_n, schedule):
  barrier_values = [np.array([1.0, 2.0], np.float32),
                    np.array([float("nan")]), None] + [np.ones(2)] * 20
  got, got_hists = _run_recorder(stepstats, monkeypatch, every_n, schedule,
                                 barrier_values)
  want, want_hists = _run_recorder(jax_stepstats, monkeypatch, every_n,
                                   schedule, barrier_values)
  assert [step for step, _ in got] == [step for step, _ in want]
  assert len(got) >= 3
  for (_, record), (_, jax_record) in zip(got, want):
    assert record.pop("compile") == 0.0
    jax_record.pop("compile")
    assert record == jax_record
    assert set(record) >= {"step_ms", "device_ms", "data_wait_ms",
                           "host_ms", "dispatch_ms", "examples_per_sec",
                           "steps_in_window", "barrier_dominated"}
  assert got_hists == want_hists
  assert any(r.get("nonfinite_params") == 1.0 for _, r in got)


def test_cpu_barrier_stamps_no_heartbeat_and_reads_no_gauges():
  state = type("State", (), {})()
  state.params = {"w": torch.ones(3, 2), "b": torch.tensor([1.0, np.nan])}
  rec = stepstats.StepStatsRecorder(batch_size=2,
                                    registry=metrics.Registry())
  rec.start()
  rec.before_dispatch()
  rec.after_dispatch()
  rec.end_step(1, state)
  ((step, record),) = rec.drain()
  assert step == 1 and record["nonfinite_params"] == 1.0
  assert "live_bytes" not in record and record["compile"] == 0.0
  assert backend.heartbeat_monitor().state == "unknown"
  assert backend.device_memory_stats(torch.device("cpu")) == {}
  np.testing.assert_array_equal(backend.state_barrier(state),
                                np.array([1.0, np.nan], np.float32))


# -- runlog ----------------------------------------------------------------------

def _feed_registry(registry, rs):
  for value in rs.rand(20) * 50.0:
    registry.histogram("stepstats/step_ms").record(float(value))
    registry.histogram("stepstats/device_ms").record(float(value) * 0.7)
    registry.histogram("stepstats/data_wait_ms").record(float(value) * 0.1)
    registry.histogram("stepstats/examples_per_sec").record(
        1e3 / max(float(value), 1e-3))
    registry.histogram("data/overlap_parse_ms").record(float(value) * 0.2)
  registry.counter("stepstats/compile_events").inc(2)
  registry.gauge("data/overlap_host_queue_depth").set(3.0)


def _records(module, rs_seed):
  rs = np.random.RandomState(rs_seed)
  out = []
  for i in range(7):
    registry = module.metrics_lib.Registry()
    _feed_registry(registry, rs)
    summary = module.step_stats_summary(registry.snapshot())
    record = module.make_record(
        "train" if i % 3 else "bench", run_id=f"run-{i}", platform="gpu",
        device_kind="NVIDIA H100 80GB HBM3", num_devices=1,
        step_stats=summary,
        compile_records=([{"name": "train_step", "compile_s": 1.5 + i,
                           "flops": 1e9 * (1 + i), "jaxpr_eqns": 100 + i,
                           "cache": {"hit": i % 2 == 0}}] if i % 2 else None),
        memory={"hbm_watermark_bytes": 2.0**30 * (1 + 0.05 * i)},
        bench=({"metric": "m", "value": 100.0 - i, "unit": "examples/sec",
                "warmup_ms": 10.0 * i, "chaos_goodput_ratio": 0.9}
               if i % 3 == 0 else None),
        extra={"graftguard": {"rewinds": i % 2, "rewind_steps": [10]}})
    record["unix_time"] = CLOCK + 3600.0 * i
    out.append(record)
  return out


def test_runlog_records_summaries_diffs_trends_and_history_match():
  got, want = _records(runlog, 5), _records(jax_runlog, 5)
  assert got == want
  assert runlog.DEFAULT_THRESHOLDS == jax_runlog.DEFAULT_THRESHOLDS
  for record in got:
    assert runlog.key_metrics(record) == jax_runlog.key_metrics(record)
  for a, b in ((got[0], got[1]), (got[1], got[2]), (got[2], got[6]),
               (got[3], got[0])):
    deltas = runlog.diff_records(a, b, thresholds={"step_ms": ("up", 0.01)})
    assert deltas == jax_runlog.diff_records(
        a, b, thresholds={"step_ms": ("up", 0.01)})
    assert runlog.format_diff(a, b, deltas) == jax_runlog.format_diff(
        a, b, deltas)
  for k in (1, 2, 3):
    trends = runlog.trend_records(got, k=k)
    assert trends == jax_runlog.trend_records(got, k=k)
    assert runlog.format_trend("src", trends, k=k) == \
        jax_runlog.format_trend("src", trends, k=k)
  assert runlog.history_lines(got, "runs.jsonl") == \
      jax_runlog.history_lines(got, "runs.jsonl")
  incident = dict(kind="nonfinite_metric", step=3, severity="fatal",
                  value=float("nan"), threshold=1.0,
                  detail={"metric": "loss"}, unix_time=CLOCK)
  assert runlog.make_incident(**incident) == \
      jax_runlog.make_incident(**incident)


def test_runlog_files_resolve_alike(tmp_path):
  for record in _records(runlog, 9):
    runlog.append_record(str(tmp_path / runlog.RUNS_FILENAME), record)
  with open(tmp_path / runlog.RUNS_FILENAME, "a") as f:
    f.write('{"torn": \n')
  with metrics.isolated(), jax_metrics.isolated():
    assert runlog.load_records(str(tmp_path / runlog.RUNS_FILENAME)) == \
        jax_runlog.load_records(str(tmp_path / runlog.RUNS_FILENAME))
    for ref in ("", "#2", "#-1", "#run-4"):
      assert runlog.resolve_run(str(tmp_path) + ref) == \
          jax_runlog.resolve_run(str(tmp_path) + ref)
    with pytest.raises(runlog.RunResolveError):
      runlog.resolve_run(str(tmp_path) + "#run-99")


# -- flightrec -------------------------------------------------------------------

def _bundle(module, out_dir):
  registry = module.metrics_lib.Registry()
  registry.counter("sentinel/incidents").inc(2)
  registry.histogram("stepstats/step_ms").record(12.5)
  recorder = module.FlightRecorder(str(out_dir), capacity=4,
                                   registry=registry,
                                   tracer=module.trace_lib.Tracer(),
                                   clock=lambda: CLOCK)
  for step in range(6):
    recorder.record_step(step, {"step_ms": 10.0 + step,
                                "nonfinite_params": float(step == 5),
                                "loss": float("nan") if step == 5 else 1.0})
  recorder.record_incident({"kind": "step_time_spike", "severity": "warn",
                            "step": 3, "unix_time": CLOCK})
  recorder.record_incident({"kind": "nonfinite_params",
                            "severity": "fatal", "step": 5,
                            "unix_time": CLOCK})
  recorder.record_incident({"kind": "nonfinite_params",
                            "severity": "fatal", "step": 6,
                            "unix_time": CLOCK})
  try:
    raise RuntimeError("diverged")
  except RuntimeError as e:
    recorder.dump("exception", exc=e)
  bundles = [json.load(open(path)) for path in
             module.find_bundles(str(out_dir))]
  for bundle in bundles:
    bundle["watchdog"].pop("stalled_secs")
    if bundle["exception"]:
      bundle["exception"]["traceback"] = bundle["exception"][
          "traceback"].splitlines()[-1]
  names = [os.path.basename(d).split("-", 2)[2] for d in recorder.dumps()]
  return bundles, names


def test_flight_recorder_bundles_match(tmp_path, capsys):
  got = _bundle(flightrec, tmp_path / "port")
  want = _bundle(jax_flightrec, tmp_path / "jax")
  assert got == want
  bundles, names = got
  assert names == ["01-incident_nonfinite_params", "02-exception"]
  assert [r["step"] for r in bundles[0]["steps"]] == [2, 3, 4, 5]
  assert bundles[0]["steps"][-1]["loss"] == "nan"
  assert bundles[1]["exception"]["message"] == "diverged"
  assert flightrec.POSTMORTEM_SCHEMA == jax_flightrec.POSTMORTEM_SCHEMA


def test_sigterm_dumps_a_bundle_with_torch_and_jax_blocked(tmp_path):
  code = """
import os, signal, sys, time
for name in ("torch", "jax", "tensor2robot_tpu"):
  sys.modules[name] = None
from tensor2robot_tpu_torch.obs import flightrec
recorder = flightrec.FlightRecorder(os.environ["OUT_DIR"], capacity=8)
for i in range(3):
  recorder.record_step(i, {"step_ms": 1.0})
recorder.install()
os.kill(os.getpid(), signal.SIGTERM)
time.sleep(30)  # never reached
raise SystemExit("survived SIGTERM")
"""
  env = {**os.environ, "PYTHONPATH": REPO_ROOT, "OUT_DIR": str(tmp_path)}
  result = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120, env=env, cwd=REPO_ROOT)
  assert result.returncode == -signal.SIGTERM, result.stderr[-2000:]
  (path,) = flightrec.find_bundles(str(tmp_path))
  bundle = json.load(open(path))
  assert bundle["reason"] == "sigterm"
  assert [r["step"] for r in bundle["steps"]] == [0, 1, 2]
  assert bundle["heartbeat"]["state"] == "unknown"


# -- xray ------------------------------------------------------------------------

def test_memory_accounting_of_a_bridged_state_matches():
  kwargs = dict(obs_size=4, action_size=2, hidden_size=32, num_blocks=2,
                num_heads=2, sequence_length=16, use_ema=True)
  jax_model = jax_sequence_model.SequenceRegressionModel(device_type="cpu",
                                                         **kwargs)
  rs = np.random.RandomState(0)
  batch = {"features": {"observation": rs.randn(2, 16, 4).astype(
      np.float32)}, "labels": {"action": rs.randn(2, 16, 2).astype(
          np.float32)}}
  jax_state, _ = jax_train_step.create_train_state(
      jax_model, jax.random.PRNGKey(0), batch["features"])
  state = bridge.train_state_from_jax(jax_state)
  got = xray.memory_accounting(state, batch=batch)
  want = jax_xray.memory_accounting(jax_state, batch=batch)
  # The port keeps the optimizer's step counts as Python ints (no
  # bytes); the JAX package's are int32 scalars.
  counts = [leaf for leaf in jax.tree_util.tree_leaves(jax_state.opt_state)
            if np.ndim(leaf) == 0]
  assert counts
  for key in ("opt_state_bytes", "opt_state_bytes_per_shard",
              "state_bytes", "state_bytes_per_shard"):
    assert got.pop(key) == want.pop(key) - 4 * len(counts), key
  assert got == want
  assert got["ema_bytes"] == got["params_bytes"] > 0
  assert xray.hbm_watermark_estimate(got) > got["params_bytes"]
  assert xray.records() == []
