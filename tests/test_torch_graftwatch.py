"""The SLO engine, the device-time ledger and `graftscope watch` on the
port, against the JAX package.

The port of the JAX package's `tests/test_graftwatch.py` cases that have
a subject in the port; each runs on both packages (`pkg`), and where
both read the same snapshots or shards their outputs are equal:

* `SloSpec` declarations are validated alike;
* burn rates match hand-computed multi-window values (a fast-only spike
  does not alert, a sustained burn alerts once per episode and re-arms;
  budget exhaustion latches once, fatally), and both engines emit the
  same incident stream from one snapshot stream;
* a seeded `obs.faultlab` serve.latency storm against a real
  `ServingFleet` (600 ms dispatches against a 200 ms latency objective)
  exhausts the budget at a precomputed request count without evicting
  a replica, and one seed gives one incident stream, in both packages
  and across them;
* `UsageLedger`: busy + idle reconciles with wall x devices (on a
  2-replica fleet's real dispatch windows too), windowed utilization is
  hand-computed, closing freezes the window, and the registry mirror
  counts;
* the fleet's ledger-backed scale-in gate: trough traffic recommends
  one replica, a busy burst in the window holds two;
* `graftscope watch --snapshot`: exit 0 healthy / 1 over budget / 2
  unusable, corrupt shards counted, stale workers excluded, the newest
  generation per pid wins, and both CLIs render one directory to the
  same frame.
"""

from __future__ import annotations

import json
import os
import re
import time
import types

import numpy as np
import pytest

from tensor2robot_tpu import serving as jax_serving
from tensor2robot_tpu.bin import graftscope as jax_graftscope
from tensor2robot_tpu.obs import faultlab as jax_faultlab
from tensor2robot_tpu.obs import metrics as jax_metrics
from tensor2robot_tpu.obs import sentinel as jax_sentinel
from tensor2robot_tpu.obs import slo as jax_slo
from tensor2robot_tpu.obs import usage as jax_usage
from tensor2robot_tpu_torch import serving
from tensor2robot_tpu_torch.bin import graftscope
from tensor2robot_tpu_torch.obs import faultlab
from tensor2robot_tpu_torch.obs import metrics
from tensor2robot_tpu_torch.obs import sentinel
from tensor2robot_tpu_torch.obs import slo
from tensor2robot_tpu_torch.obs import usage

PACKAGES = {
    "port": types.SimpleNamespace(
        slo=slo, usage=usage, metrics=metrics, sentinel=sentinel,
        faultlab=faultlab, serving=serving, graftscope=graftscope),
    "jax": types.SimpleNamespace(
        slo=jax_slo, usage=jax_usage, metrics=jax_metrics,
        sentinel=jax_sentinel, faultlab=jax_faultlab, serving=jax_serving,
        graftscope=jax_graftscope),
}

X1 = {"x": np.ones((1, 2), np.float32)}


@pytest.fixture(params=sorted(PACKAGES))
def pkg(request):
  return PACKAGES[request.param]


def _ratio_spec(p, **overrides):
  base = dict(budget=0.5, fast_window_s=2.0, slow_window_s=8.0,
              bad_key="counter/bad", total_key="counter/total",
              burn_factor=3.0)
  base.update(overrides)
  return p.slo.SloSpec("obj", **base)


def _timeless(records):
  """Incident records without their wall-clock stamp."""
  return [{k: v for k, v in r.items() if k != "unix_time"}
          for r in records]


# -- SloSpec -------------------------------------------------------------------


class TestSloSpec:

  def test_exactly_one_family(self, pkg):
    with pytest.raises(ValueError):
      pkg.slo.SloSpec("x", budget=0.1, fast_window_s=1.0,
                      slow_window_s=2.0)  # neither family
    with pytest.raises(ValueError):
      pkg.slo.SloSpec("x", budget=0.1, fast_window_s=1.0,
                      slow_window_s=2.0, bad_key="a", total_key="b",
                      value_key="c", ceiling=1.0)  # both
    with pytest.raises(ValueError):
      pkg.slo.SloSpec("x", budget=0.1, fast_window_s=1.0,
                      slow_window_s=2.0, bad_key="a")  # half a family

  @pytest.mark.parametrize("overrides", [
      dict(budget=0.0), dict(budget=1.5),
      dict(fast_window_s=8.0, slow_window_s=2.0), dict(burn_factor=1.0)])
  def test_budget_and_windows_validated(self, pkg, overrides):
    with pytest.raises(ValueError):
      _ratio_spec(pkg, **overrides)

  def test_describe_round_trips_the_family(self, pkg):
    ratio = _ratio_spec(pkg)
    assert ratio.describe()["kind"] == pkg.slo.RATIO
    assert ratio.describe()["bad_key"] == "counter/bad"
    value = pkg.slo.SloSpec("v", budget=0.1, fast_window_s=1.0,
                            slow_window_s=2.0, value_key="gauge/x",
                            ceiling=2.0)
    assert value.describe()["kind"] == pkg.slo.VALUE
    assert value.describe()["ceiling"] == 2.0

  def test_value_spec_counts_one_event_per_observation(self, pkg):
    spec = pkg.slo.SloSpec("v", budget=0.5, fast_window_s=1.0,
                           slow_window_s=4.0, value_key="gauge/x",
                           ceiling=2.0)
    bad, total = spec.counts({"gauge/x": 1.0}, 0.0, 0.0)
    assert (bad, total) == (0.0, 1.0)
    bad, total = spec.counts({"gauge/x": 3.0}, bad, total)
    assert (bad, total) == (1.0, 2.0)
    assert spec.counts({}, bad, total) == (1.0, 2.0)

  def test_default_specs_match_the_jax_package(self):
    for name in ("default_serving_slos", "default_loop_slos"):
      port, jax = (getattr(p.slo, name)() for p in PACKAGES.values())
      assert [s.describe() for s in port] == [s.describe() for s in jax]


# -- burn math -------------------------------------------------------------------


class TestBurnMath:

  def test_windowed_burns_match_hand_computed_values(self, pkg):
    with pkg.metrics.isolated():
      engine = pkg.slo.SloEngine([_ratio_spec(pkg)])
      engine.observe({"counter/bad": 0.0, "counter/total": 0.0}, now=0.0)
      st = engine.state(now=0.0)["obj"]
      assert (st["fast_burn"], st["slow_burn"],
              st["budget_consumed"]) == (0.0, 0.0, 0.0)
      engine.observe({"counter/bad": 2.0, "counter/total": 10.0},
                     now=1.0)
      st = engine.state(now=1.0)["obj"]
      assert st["fast_burn"] == pytest.approx(0.4)
      assert st["slow_burn"] == pytest.approx(0.4)
      assert st["budget_consumed"] == pytest.approx(0.4)
      engine.observe({"counter/bad": 6.0, "counter/total": 20.0},
                     now=2.0)
      st = engine.state(now=2.0)["obj"]
      assert st["fast_burn"] == pytest.approx(0.6)
      assert st["slow_burn"] == pytest.approx(0.6)
      engine.observe({"counter/bad": 6.0, "counter/total": 20.0},
                     now=10.0)
      st = engine.state(now=10.0)["obj"]
      assert st["fast_burn"] == 0.0 and st["slow_burn"] == 0.0
      # Consumed is cumulative-from-genesis: a quiet window does not
      # refill the budget.
      assert st["budget_consumed"] == pytest.approx(0.6)

  def test_genesis_baseline_ignores_preexisting_counts(self, pkg):
    with pkg.metrics.isolated():
      engine = pkg.slo.SloEngine([_ratio_spec(pkg, budget=0.5)])
      engine.observe({"counter/bad": 5.0, "counter/total": 100.0},
                     now=0.0)
      assert engine.state()["obj"]["budget_consumed"] == 0.0
      engine.observe({"counter/bad": 10.0, "counter/total": 110.0},
                     now=1.0)
      assert engine.state()["obj"]["budget_consumed"] == pytest.approx(
          1.0)

  def test_burn_alert_needs_fast_and_slow_and_rearms(self, pkg):
    spec = _ratio_spec(pkg, budget=0.2, fast_window_s=2.0,
                       slow_window_s=10.0, burn_factor=3.0)
    incidents = []
    with pkg.metrics.isolated() as reg:
      engine = pkg.slo.SloEngine([spec], sinks=[incidents.append])
      counts = {"counter/bad": 0.0, "counter/total": 0.0}
      engine.observe(dict(counts), now=0.0)
      for now in range(1, 6):  # quiet: the slow window fills clean
        counts["counter/total"] += 100.0
        assert engine.observe(dict(counts), now=float(now)) == []
      first_burst = []
      for now in range(6, 16):  # burst
        counts["counter/bad"] += 8.0
        counts["counter/total"] += 10.0
        first_burst.extend(engine.observe(dict(counts), now=float(now)))
      assert len(first_burst) == 1
      assert first_burst[0]["severity"] == "warn"
      assert first_burst[0]["detail"]["trigger"] == "burn_rate"
      assert first_burst[0]["kind"] == pkg.sentinel.SLO_BURN
      assert engine.healthy() is False
      for now in range(16, 31):  # quiet again: re-arm
        counts["counter/total"] += 100.0
        assert engine.observe(dict(counts), now=float(now)) == []
      assert engine.healthy() is True
      second_burst = []
      for now in range(31, 41):
        counts["counter/bad"] += 8.0
        counts["counter/total"] += 10.0
        second_burst.extend(engine.observe(dict(counts), now=float(now)))
      assert len(second_burst) == 1
      assert engine.state()["obj"]["exhausted"] is False
      snap = reg.snapshot()
      assert snap[f"counter/sentinel/{pkg.sentinel.SLO_BURN}"] == 2.0
      assert snap["counter/sentinel/incidents"] == 2.0
      assert snap["gauge/slo/obj/fast_burn"] >= 3.0
    assert incidents == first_burst + second_burst

  def test_budget_exhaustion_latches_once_and_is_fatal(self, pkg):
    incidents = []
    with pkg.metrics.isolated():
      engine = pkg.slo.SloEngine(
          [_ratio_spec(pkg, budget=0.05, fast_window_s=2.0,
                       slow_window_s=8.0)],
          sinks=[incidents.append])
      engine.observe({"counter/bad": 0.0, "counter/total": 0.0}, now=0.0)
      engine.observe({"counter/bad": 1.0, "counter/total": 10.0},
                     now=1.0, step=1)
      assert len(incidents) == 1
      assert incidents[0]["severity"] == "fatal"
      assert incidents[0]["detail"]["trigger"] == "budget_exhausted"
      assert incidents[0]["value"] == pytest.approx(2.0)
      for now in range(2, 8):
        engine.observe({"counter/bad": float(now),
                        "counter/total": float(10 * now)},
                       now=float(now))
      assert len(incidents) == 1
      st = engine.state()["obj"]
      assert st["exhausted"] is True and st["incidents"] == 1
      assert engine.healthy() is False
      assert engine.worst_burn() >= 1.0

  def test_evaluate_snapshot_point_in_time(self, pkg):
    specs = [
        _ratio_spec(pkg, budget=0.1),
        pkg.slo.SloSpec("v", budget=0.5, fast_window_s=1.0,
                        slow_window_s=4.0, value_key="gauge/x",
                        ceiling=2.0),
    ]
    out = pkg.slo.evaluate_snapshot(
        specs, {"counter/bad": 3.0, "counter/total": 10.0,
                "gauge/x": 5.0})
    assert out["obj"]["ok"] is False
    assert out["obj"]["budget_consumed"] == pytest.approx(3.0)
    assert out["v"]["ok"] is False
    ok = pkg.slo.evaluate_snapshot(
        specs, {"counter/bad": 0.0, "counter/total": 10.0})
    assert ok["obj"]["ok"] is True and ok["v"]["ok"] is True

  def test_both_engines_judge_one_stream_alike(self):
    """A seeded snapshot stream through both engines: the same incidents,
    per-observe outputs, final states and gauges."""
    rng = np.random.RandomState(5)
    stream, bad, total = [], 0.0, 0.0
    for now in range(60):
      total += float(rng.randint(5, 50))
      bad += float(rng.randint(0, 6)) if 20 <= now < 35 else 0.0
      stream.append(({"counter/bad": bad, "counter/total": total,
                      "gauge/x": float(rng.rand() * 3)}, float(now)))
    out = {}
    for which, p in PACKAGES.items():
      specs = [_ratio_spec(p, budget=0.05, fast_window_s=3.0,
                           slow_window_s=12.0, burn_factor=2.0),
               p.slo.SloSpec("v", budget=0.3, fast_window_s=2.0,
                             slow_window_s=6.0, value_key="gauge/x",
                             ceiling=2.0, burn_factor=1.5)]
      with p.metrics.isolated() as reg:
        engine = p.slo.SloEngine(specs)
        emitted = [_timeless(engine.observe(snap, now=now, step=i))
                   for i, (snap, now) in enumerate(stream)]
        out[which] = (emitted, engine.state(), engine.worst_burn(),
                      reg.snapshot(prefix="slo/"))
    assert out["port"] == out["jax"]
    assert sum(len(e) for e in out["port"][0]) >= 2


# -- the seeded storm --------------------------------------------------------------


class _FakeEngine:
  """A replica without a backend (the JAX test's, trimmed to what the
  ledger and SLO paths touch)."""

  def __init__(self, index):
    self.index = index
    self.version = 1

  def predict(self, features):
    return {"out": np.asarray(features["x"]) * float(self.version)}

  def warmup(self):
    pass

  @property
  def model_version(self):
    return self.version

  @property
  def global_step(self):
    return self.version

  def close(self):
    pass


def _make_fleet(p, num_replicas=2, **kwargs):
  kwargs.setdefault("max_delay_ms", 1.0)
  return p.serving.ServingFleet(
      replica_factory=lambda index, devices: _FakeEngine(index),
      num_replicas=num_replicas, **kwargs)


# Storm shape: every 4th routed predict on replica 0 holds the dispatch
# open 600 ms against a 200 ms latency objective -> breaches =
# floor(k/4) after k requests. With budget 0.25 the consumption
# (floor(k/4)/k)/0.25 first reaches 1.0 at k = 4.
_STORM_EVERY = 4
_STORM_BUDGET = 0.25
_STORM_REQUESTS = 8
_STORM_EXHAUST_AT = next(
    k for k in range(1, _STORM_REQUESTS + 1)
    if (k // _STORM_EVERY) / k >= _STORM_BUDGET)
_STORM_SLO_MS = 200.0


def _run_storm(p, spec_kwargs, seed, budget=_STORM_BUDGET,
               requests=_STORM_REQUESTS, spike_ms=600.0):
  """A seeded latency storm against a real 1-replica fleet of the
  package. Returns (incident stream, final snapshot, sink capture)."""
  captured = []
  with p.metrics.isolated() as reg:
    fleet = _make_fleet(p, num_replicas=1, latency_slo_ms=_STORM_SLO_MS)
    spec = p.slo.SloSpec(
        "storm_latency", budget=budget, fast_window_s=4.0,
        slow_window_s=16.0, bad_key="counter/serve/slo_breaches",
        total_key="counter/serve/fleet/requests")
    engine = p.slo.SloEngine(
        [spec], sinks=[captured.append, fleet.sentinel_sink()])
    plan = p.faultlab.FaultPlan(
        [p.faultlab.FaultSpec(point=p.faultlab.SERVE_LATENCY, key=0,
                              arg=spike_ms, **spec_kwargs)], seed=seed)
    stream = []
    try:
      with plan.activated():
        # Genesis observation before traffic: the budget's baseline is
        # the empty fleet, so "total" counts every storm request.
        stream.extend(engine.observe(reg.snapshot(), now=0.0, step=0))
        for i in range(1, requests + 1):
          fleet.predict(X1)
          stream.extend(engine.observe(reg.snapshot(), now=float(i),
                                       step=i))
      # The fatal burn names no replica: the sink passed it through
      # without evicting, and the fleet still serves.
      fleet.predict(X1)
      assert fleet.healthy_replicas() == [0]
    finally:
      fleet.close()
    return stream, reg.snapshot(), captured


class TestStormDeterminism:

  def test_budget_exhausts_at_the_precomputed_request_count(self, pkg):
    assert _STORM_EXHAUST_AT == 4  # the hand-derived pin itself
    stream, snap, captured = _run_storm(pkg, dict(every=_STORM_EVERY),
                                        seed=7)
    assert "counter/serve/fleet/unhealthy" not in snap
    assert snap["counter/serve/slo_breaches"] == float(
        _STORM_REQUESTS // _STORM_EVERY)
    assert len(stream) == 1
    incident = stream[0]
    assert incident["kind"] == pkg.sentinel.SLO_BURN
    assert incident["severity"] == "fatal"
    assert incident["step"] == _STORM_EXHAUST_AT
    assert incident["detail"]["trigger"] == "budget_exhausted"
    assert incident["detail"]["bad"] == 1.0
    assert incident["detail"]["total"] == float(_STORM_EXHAUST_AT)
    assert incident["value"] == pytest.approx(1.0)
    assert incident["threshold"] == _STORM_BUDGET
    assert captured == stream
    assert snap[f"counter/sentinel/{pkg.sentinel.SLO_BURN}"] == 1.0

  def test_identical_seed_reproduces_the_incident_stream(self):
    """A seeded Bernoulli storm: one seed gives one stream, twice in each
    package and across the packages; another seed another stream."""
    streams = {}
    for which, p in PACKAGES.items():
      for run in range(2):
        stream, snap, _ = _run_storm(p, dict(rate=0.35), seed=13,
                                     budget=0.1, requests=16,
                                     spike_ms=300.0)
        streams[which, run] = (_timeless(stream),
                               snap["counter/serve/slo_breaches"])
    assert len(set(json.dumps(s, sort_keys=True)
                   for s in streams.values())) == 1
    assert streams["port", 0][0]
    other, _, _ = _run_storm(PACKAGES["port"], dict(rate=0.35), seed=14,
                             budget=0.1, requests=16, spike_ms=300.0)
    assert _timeless(other) != streams["port", 0][0]


# -- UsageLedger ---------------------------------------------------------------------


class TestUsageLedger:

  def test_busy_plus_idle_reconciles_with_wall_clock(self, pkg):
    t = [0.0]
    ledger = pkg.usage.UsageLedger(
        name="t/fleet", cost_per_device_hour_usd=3.6,
        sample_window_s=10.0, sample_interval_s=0.0, clock=lambda: t[0])
    with pkg.metrics.isolated():
      ledger.open_group("g0", devices=4)
      t[0] = 2.0
      ledger.record_busy("g0", 1.5, requests=3)
      t[0] = 10.0
      out = ledger.summary(now=10.0)
    assert out["devices"] == 4
    assert out["device_seconds_busy"] == pytest.approx(6.0)
    assert out["device_seconds_idle"] == pytest.approx(34.0)
    assert (out["device_seconds_busy"] + out["device_seconds_idle"]
            == pytest.approx(40.0))
    assert out["utilization"] == pytest.approx(0.15)
    assert out["requests"] == 3
    assert out["cost_usd"] == pytest.approx(0.04)
    assert out["cost_per_request_usd"] == pytest.approx(0.04 / 3)
    assert out["groups"]["g0"]["wall_s"] == pytest.approx(10.0)

  def test_window_utilization_hand_computed(self, pkg):
    t = [0.0]
    ledger = pkg.usage.UsageLedger(
        name="t/fleet", sample_window_s=100.0, sample_interval_s=0.0,
        clock=lambda: t[0])
    with pkg.metrics.isolated():
      ledger.open_group("g0", devices=1)
      for tick in range(1, 9):
        t[0] = float(tick)
        ledger.record_busy("g0", 0.5)
      util, coverage = ledger.window_utilization(4.0, now=8.0)
      assert util == pytest.approx(0.5) and coverage == pytest.approx(4.0)
      util, coverage = ledger.window_utilization(100.0, now=8.0)
      assert util == pytest.approx(0.5) and coverage == pytest.approx(8.0)
      ledger.close_group("g0")
      assert ledger.window_utilization(4.0, now=9.0) == (0.0, 0.0)

  def test_close_freezes_the_wall_window(self, pkg):
    t = [0.0]
    ledger = pkg.usage.UsageLedger(name="t/fleet", clock=lambda: t[0])
    with pkg.metrics.isolated():
      ledger.open_group("g0", devices=2)
      t[0] = 3.0
      ledger.record_busy("g0", 1.0)
      t[0] = 5.0
      ledger.close_group("g0")
      t[0] = 20.0
      out = ledger.summary()
    assert out["groups"]["g0"]["wall_s"] == pytest.approx(5.0)
    assert out["device_seconds_busy"] == pytest.approx(2.0)
    assert out["device_seconds_idle"] == pytest.approx(8.0)

  def test_record_busy_mirrors_registry_counters(self, pkg):
    ledger = pkg.usage.UsageLedger(name="t/fleet")
    with pkg.metrics.isolated() as reg:
      ledger.record_busy("replica0", 0.25, requests=2)
      snap = reg.snapshot()
    assert snap["counter/t/fleet/busy_ms/replica0"] == pytest.approx(250.0)
    assert snap["counter/t/fleet/busy_requests/replica0"] == 2.0

  def test_both_ledgers_summarize_one_record_stream_alike(self):
    out = {}
    for which, p in PACKAGES.items():
      t = [0.0]
      rng = np.random.RandomState(3)
      ledger = p.usage.UsageLedger(name="t/usage", sample_window_s=5.0,
                                   sample_interval_s=0.5,
                                   clock=lambda: t[0])
      with p.metrics.isolated() as reg:
        ledger.open_group("a", devices=2)
        for i in range(40):
          t[0] = 0.25 * (i + 1)
          ledger.record_busy("ab"[i % 2], float(rng.rand() * 0.1),
                             requests=int(rng.randint(1, 9)))
        ledger.close_group("b")
        windows = [ledger.window_utilization(w, now=10.0)
                   for w in (1.0, 4.0, 20.0)]
        out[which] = (ledger.summary(now=12.0), windows, reg.snapshot())
    assert out["port"] == out["jax"]

  def test_real_fleet_ledger_reconciles(self, pkg):
    # The identity over real dispatch windows: traffic through a
    # 2-replica fleet, then busy + idle equals wall x devices (within
    # the block's 4-decimal rounding) and the batchers' usage hooks
    # attributed every request.
    with pkg.metrics.isolated():
      fleet = _make_fleet(pkg, num_replicas=2)
      try:
        for _ in range(8):
          fleet.predict(X1)
      finally:
        fleet.close()
      out = fleet.utilization_summary()
    assert out["requests"] == 8
    assert out["device_seconds_busy"] > 0.0
    wall = sum(g["wall_s"] * g["devices"] for g in out["groups"].values())
    assert (out["device_seconds_busy"] + out["device_seconds_idle"]
            == pytest.approx(wall, abs=2e-3))
    assert set(out["groups"]) == {"replica0", "replica1"}
    assert out["cost_per_request_usd"] > 0.0


# -- the ledger-backed scale-in gate -------------------------------------------------


class TestScaleInGate:

  def test_trough_traffic_scales_in(self, pkg):
    # Quick stateless traffic: the outstanding window reads ~0, the
    # ledger agrees (dispatches are microseconds) -> advisory 1.
    with pkg.metrics.isolated():
      fleet = _make_fleet(pkg, num_replicas=2, autoscale_sample_s=0.0)
      try:
        for _ in range(6):
          fleet.predict(X1)
        assert fleet.recommended_replicas() == 1
      finally:
        fleet.close()

  def test_busy_window_blocks_scale_in(self, pkg):
    # The same trough by the outstanding signal, but the ledger holds a
    # recent busy burst: the projected utilization on the smaller fleet
    # exceeds the target and the gate holds at 2.
    with pkg.metrics.isolated() as reg:
      fleet = _make_fleet(pkg, num_replicas=2, autoscale_sample_s=0.0)
      try:
        for _ in range(6):
          fleet.predict(X1)
        fleet._usage.record_busy("replica0", 5.0)
        assert fleet.recommended_replicas() == 2
        snap = reg.snapshot()
      finally:
        fleet.close()
    assert snap["gauge/serve/fleet/window_utilization"] == 1.0
    assert snap["gauge/serve/fleet/recommended_replicas"] == 2.0


# -- graftscope watch ----------------------------------------------------------------


def _write_shard(root, pid, gen, snapshot, role="worker", age_s=0.0):
  payload = {
      "graftrace": "v1", "pid": pid, "gen": gen, "role": role,
      "clock": {"perf_ns": time.perf_counter_ns(),
                "epoch_ns": time.time_ns() - int(age_s * 1e9)},
      "snapshot": snapshot,
  }
  path = os.path.join(root, f"metrics-{pid}-{gen:06d}.json")
  with open(path, "w") as f:
    json.dump(payload, f)
  return path


_HEALTHY_SNAPSHOT = {
    "counter/serve/fleet/requests": 100.0,
    "counter/serve/fleet/shed": 0.0,
    "counter/serve/slo_breaches": 0.0,
    "counter/serve/fleet/busy_ms/replica0": 1500.0,
    "hist/serve/request_ms/p50": 3.0,
    "hist/serve/request_ms/p99": 9.0,
    "gauge/serve/fleet/utilization": 0.4,
    "gauge/serve/fleet/device_seconds_busy": 12.0,
    "gauge/serve/fleet/device_seconds_idle": 18.0,
    "gauge/serve/fleet/cost_per_request_usd": 0.0001,
}


def _watch_json(p, capsys, root, *extra):
  code = p.graftscope.main(["watch", str(root), "--snapshot", "--json",
                            *extra])
  return code, json.loads(capsys.readouterr().out)


class TestWatch:

  def test_snapshot_json_healthy_exit0(self, pkg, tmp_path, capsys):
    _write_shard(str(tmp_path), 11, 1, _HEALTHY_SNAPSHOT)
    _write_shard(str(tmp_path), 22, 3,
                 {"counter/serve/fleet/requests": 50.0,
                  "counter/serve/fleet/busy_ms/replica1": 800.0},
                 role="server")
    code, view = _watch_json(pkg, capsys, tmp_path)
    assert code == 0
    assert view["healthy"] is True
    assert view["live_workers"] == 2
    assert view["fleet"]["requests"] == 150.0
    assert view["utilization"]["utilization"] == 0.4
    assert view["utilization"]["busy_s_by_group"] == {
        "replica0": 1.5, "replica1": 0.8}
    assert all(s["ok"] for s in view["slo"].values())

  def test_over_budget_exits_1(self, pkg, tmp_path, capsys):
    bad = dict(_HEALTHY_SNAPSHOT)
    bad["counter/serve/slo_breaches"] = 50.0  # 50% vs the 1% budget
    _write_shard(str(tmp_path), 11, 1, bad)
    code = pkg.graftscope.main(["watch", str(tmp_path), "--snapshot"])
    out = capsys.readouterr().out
    assert code == 1
    assert "BURNING" in out and "OVER BUDGET" in out
    assert "serve_latency" in out

  def test_stale_worker_excluded_from_the_merge(self, pkg, tmp_path,
                                                capsys):
    _write_shard(str(tmp_path), 11, 1, _HEALTHY_SNAPSHOT)
    dead = {"counter/serve/fleet/requests": 1000.0,
            "counter/serve/slo_breaches": 1000.0}
    _write_shard(str(tmp_path), 22, 9, dead, age_s=120.0)
    code, view = _watch_json(pkg, capsys, tmp_path)
    assert code == 0 and view["healthy"] is True
    assert view["live_workers"] == 1
    (stale,) = [w for w in view["workers"] if w["pid"] == 22]
    assert stale["stale"] is True and stale["age_s"] >= 119.0
    assert view["fleet"]["requests"] == 100.0
    code, view = _watch_json(pkg, capsys, tmp_path, "--stale-s", "3600")
    assert code == 1
    assert view["fleet"]["requests"] == 1100.0

  def test_corrupt_and_foreign_shards_are_counted_not_raised(
      self, pkg, tmp_path, capsys):
    _write_shard(str(tmp_path), 11, 1, _HEALTHY_SNAPSHOT)
    (tmp_path / "metrics-99-000001.json").write_text("{torn mid-write")
    (tmp_path / "metrics-98-000001.json").write_text(
        json.dumps({"some": "foreign file"}))
    code, view = _watch_json(pkg, capsys, tmp_path)
    assert code == 0
    assert view["skipped"] == 2 and view["live_workers"] == 1

  def test_newest_generation_per_pid_wins(self, pkg, tmp_path, capsys):
    _write_shard(str(tmp_path), 11, 1,
                 {"counter/serve/fleet/requests": 10.0})
    _write_shard(str(tmp_path), 11, 2,
                 {"counter/serve/fleet/requests": 30.0})
    _, view = _watch_json(pkg, capsys, tmp_path)
    assert view["fleet"]["requests"] == 30.0
    assert len(view["workers"]) == 1

  def test_unusable_directories_exit_2(self, pkg, tmp_path, capsys):
    assert pkg.graftscope.main(
        ["watch", str(tmp_path), "--snapshot"]) == 2  # empty
    assert pkg.graftscope.main(
        ["watch", str(tmp_path / "missing"), "--snapshot"]) == 2
    capsys.readouterr()

  def test_serving_shards_without_fleet_counters_are_healthy(
      self, pkg, tmp_path, capsys):
    """A batcher's shard holds no `serve/fleet/*` counter: the stock
    serving SLOs judge 0 of 0 events, within budget (exit 0)."""
    _write_shard(str(tmp_path), 11, 1,
                 {"counter/serve/batcher/requests": 40.0,
                  "counter/serve/slo_breaches": 1.0,
                  "counter/serve/fleet/busy_ms/critic": 120.0})
    code, view = _watch_json(pkg, capsys, tmp_path)
    assert code == 0 and view["healthy"] is True
    assert view["fleet"]["requests"] == 0.0
    assert view["fleet"]["slo_breaches"] == 1.0
    assert view["slo"]["serve_latency"]["total"] == 0.0
    assert view["utilization"]["busy_s_by_group"] == {"critic": 0.12}

  def test_both_clis_render_one_directory_alike(self, tmp_path, capsys):
    _write_shard(str(tmp_path), 11, 1, _HEALTHY_SNAPSHOT)
    bad = dict(_HEALTHY_SNAPSHOT, **{"counter/serve/fleet/shed": 9.0})
    _write_shard(str(tmp_path), 22, 4, bad, role="server")
    _write_shard(str(tmp_path), 33, 2, bad, age_s=300.0)
    out = {}
    for which, p in PACKAGES.items():
      code, view = _watch_json(p, capsys, tmp_path)
      for worker in view["workers"]:
        worker.pop("age_s")  # read from the clock at each call
      text_code = p.graftscope.main(["watch", str(tmp_path), "--snapshot"])
      # The shard-age column reads the clock at each call.
      text = re.sub(r"[0-9.]+s(?=  (ok|STALE))", "<age>",
                    capsys.readouterr().out)
      out[which] = (code, view, text_code, text)
    assert out["port"] == out["jax"]
    assert out["port"][0] == 1  # 9 sheds of 200 requests vs 2%
    assert out["port"][3].count("<age>") == 3
