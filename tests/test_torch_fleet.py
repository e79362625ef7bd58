"""The serving fleet on the port, against the JAX package.

The port of `tests/test_fleet.py` (all but its lint-rule cases, whose
rule is ROADMAP item 15.3's). The cases on fake engines run on both
packages (`pkg`): routing with least-outstanding dispatch, queue-depth
shedding and one failover retry; session affinity, displacement and
re-open; health wiring and probation; rollouts under load; the
traffic-derived ladder; the arrival profiles with the open-loop session
and trace loads; and the advisory replica count. Where the JAX package
counts fresh compiles across a rollout, the port counts fresh warms
(`warm_count`). Port-only cases:

* `replica_device_groups` carves a device list (one card listed twice
  gives two replicas on it);
* the consistent-hash ring, the arrival streams and the derived ladders
  are equal across the packages for the same inputs;
* two real replicas on ['cpu', 'cpu'], each predictor pinned with
  `place_on_device`, serve a concurrent sweep within 1e-5 of a lone
  predictor with `warm_count` unchanged;
* the zero-downtime rollout on real checkpoints: no failed request, no
  fresh warm, parity with a fresh fleet on the new checkpoint;
* the fleet layer runs in a process that never initialises CUDA.
"""

import os
import subprocess
import sys
import threading
import time
import types

import numpy as np
import pytest
import torch

from tensor2robot_tpu import serving as jax_serving
from tensor2robot_tpu.obs import metrics as jax_metrics
from tensor2robot_tpu.obs import runlog as jax_runlog
from tensor2robot_tpu.obs import sentinel as jax_sentinel
from tensor2robot_tpu.serving import engine as jax_engine
from tensor2robot_tpu.serving import fleet as jax_fleet
from tensor2robot_tpu.serving import loadgen as jax_loadgen
from tensor2robot_tpu.serving import session as jax_session
from tensor2robot_tpu.utils import retry as jax_retry
from tensor2robot_tpu_torch import serving as port_serving
from tensor2robot_tpu_torch.obs import metrics as port_metrics
from tensor2robot_tpu_torch.obs import runlog as port_runlog
from tensor2robot_tpu_torch.obs import sentinel as port_sentinel
from tensor2robot_tpu_torch.serving import engine as port_engine
from tensor2robot_tpu_torch.serving import fleet as port_fleet
from tensor2robot_tpu_torch.serving import loadgen as port_loadgen
from tensor2robot_tpu_torch.serving import session as port_session
from tensor2robot_tpu_torch.utils import config as port_config
from tensor2robot_tpu_torch.utils import retry as port_retry

torch.set_num_threads(1)

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _clean_config():
  """No binding another test left in the port's config reaches the
  configurables of the fleet and its engines."""
  port_config.clear_config()
  yield
  port_config.clear_config()


PACKAGES = {
    "port": dict(serving=port_serving, metrics_lib=port_metrics,
                 runlog_lib=port_runlog, sentinel_lib=port_sentinel,
                 engine_lib=port_engine, fleet_lib=port_fleet,
                 loadgen=port_loadgen, session_lib=port_session,
                 retry_lib=port_retry, FRESH="fresh_warms"),
    "jax": dict(serving=jax_serving, metrics_lib=jax_metrics,
                runlog_lib=jax_runlog, sentinel_lib=jax_sentinel,
                engine_lib=jax_engine, fleet_lib=jax_fleet,
                loadgen=jax_loadgen, session_lib=jax_session,
                retry_lib=jax_retry, FRESH="fresh_compiles"),
}

# The module's names are the port's, except inside a `pkg` test, which
# binds them to its package for the test's duration.
globals().update(PACKAGES["port"])


@pytest.fixture(params=sorted(PACKAGES))
def pkg(request):
  globals().update(PACKAGES[request.param])
  try:
    yield types.SimpleNamespace(name=request.param,
                                **PACKAGES[request.param])
  finally:
    globals().update(PACKAGES["port"])


class _FakeEngine:
  """Backend-free replica: deterministic outputs keyed by version, full
  stateless + session surfaces, version-bumping restore."""

  def __init__(self, index, fail=False, delay_s=0.0, max_sessions=64):
    self.index = index
    self.version = 1
    self.compile_count = 0
    self.warm_count = 0
    self.fail = fail
    self.delay_s = delay_s
    self.served_rows = []
    self.opened = []
    self.sessions = {}
    self.max_sessions = max_sessions
    self._next_sid = 1
    self.closed = False

  def predict(self, features):
    if self.fail:
      raise RuntimeError(f"replica {self.index} exploded")
    if self.delay_s:
      time.sleep(self.delay_s)
    x = np.asarray(features["x"])
    self.served_rows.append(x.shape[0])
    return {"out": x * float(self.version)}

  def open(self):
    if len(self.sessions) >= self.max_sessions:
      raise session_lib.SessionShedError("full")
    sid = self._next_sid
    self._next_sid += 1
    self.sessions[sid] = 0
    self.opened.append(sid)
    return sid

  def step(self, sid, features):
    if sid not in self.sessions:
      raise session_lib.UnknownSessionError(f"unknown {sid}", sid)
    self.sessions[sid] += 1
    return {"out": np.asarray(features["x"]) * float(self.version),
            "ticks": np.int64(self.sessions[sid])}

  def close_session(self, sid):
    self.sessions.pop(sid, None)

  def restore(self):
    self.version += 1
    return True

  def warmup(self):
    pass

  @property
  def model_version(self):
    return self.version

  @property
  def global_step(self):
    return self.version

  def close(self):
    self.closed = True


def _make_fleet(num_replicas=2, engines=None, **kwargs):
  engines = engines if engines is not None else {}

  def factory(index, devices):
    engines[index] = engines.get(index) or _FakeEngine(index)
    return engines[index]

  kwargs.setdefault("max_delay_ms", 1.0)
  fleet = serving.ServingFleet(replica_factory=factory,
                               num_replicas=num_replicas, **kwargs)
  return fleet, engines


X1 = {"x": np.ones((1, 2), np.float32)}


# ---------------------------------------------------------------------------
# Stateless routing.
# ---------------------------------------------------------------------------


@pytest.mark.usefixtures("pkg")
class TestFleetRouting:

  def test_routes_and_returns_backend_outputs(self):
    fleet, engines = _make_fleet()
    try:
      out = fleet.predict(X1)
      np.testing.assert_array_equal(out["out"], X1["x"])
      assert sum(len(e.served_rows) for e in engines.values()) == 1
    finally:
      fleet.close()

  def test_concurrent_load_uses_both_replicas(self):
    fleet, engines = _make_fleet(engines={0: _FakeEngine(0, delay_s=0.01),
                                          1: _FakeEngine(1, delay_s=0.01)})
    try:
      threads = [threading.Thread(target=lambda: fleet.predict(X1))
                 for _ in range(16)]
      for t in threads:
        t.start()
      for t in threads:
        t.join()
      # Least-outstanding routing spreads concurrent work: both replicas
      # served (each replica's batcher coalesces its share into fewer,
      # larger dispatches), and every row was served exactly once.
      assert all(e.served_rows for e in engines.values())
      assert sum(sum(e.served_rows) for e in engines.values()) == 16
    finally:
      fleet.close()

  def test_queue_depth_shed(self):
    # Slow single replica + tiny outstanding bound: overload sheds with
    # FleetShedError instead of queueing unboundedly.
    fleet, _ = _make_fleet(
        num_replicas=1, engines={0: _FakeEngine(0, delay_s=0.2)},
        shed_outstanding=2)
    try:
      with metrics_lib.isolated() as registry:
        errors = []

        def client():
          try:
            fleet.predict(X1)
          except serving.FleetShedError as e:
            errors.append(e)

        threads = [threading.Thread(target=client) for _ in range(8)]
        for t in threads:
          t.start()
        for t in threads:
          t.join()
        snap = registry.snapshot()
      assert errors, "overload must shed at the router"
      assert snap["counter/serve/fleet/shed"] == len(errors)
    finally:
      fleet.close()

  def test_failover_retries_on_healthy_replica(self):
    fleet, engines = _make_fleet(engines={0: _FakeEngine(0, fail=True),
                                          1: _FakeEngine(1)})
    try:
      with metrics_lib.isolated() as registry:
        out = fleet.predict(X1)  # one replica fails, failover serves
        snap = registry.snapshot()
      np.testing.assert_array_equal(out["out"], X1["x"])
      assert snap["counter/serve/fleet/retries"] >= 1.0
    finally:
      fleet.close()

  def test_failure_streak_evicts_replica(self):
    fleet, engines = _make_fleet(engines={0: _FakeEngine(0, fail=True),
                                          1: _FakeEngine(1)},
                                 unhealthy_after=3)
    try:
      for _ in range(12):
        fleet.predict(X1)
      states = fleet.replica_states()
      # The failing replica accrued its streak through failovers and is
      # now out of the routing set; traffic flows on the healthy one.
      assert states[0] == fleet_lib.UNHEALTHY or not engines[0].served_rows
      assert fleet.healthy_replicas() == [1] or states[0] == "serving"
      if states[0] == fleet_lib.UNHEALTHY:
        before = len(engines[0].served_rows)
        for _ in range(4):
          fleet.predict(X1)
        assert len(engines[0].served_rows) == before
    finally:
      fleet.close()

  def test_no_healthy_replica_raises(self):
    fleet, _ = _make_fleet()
    try:
      fleet.mark_unhealthy(0, "test")
      fleet.mark_unhealthy(1, "test")
      with pytest.raises(serving.NoHealthyReplicaError):
        fleet.predict(X1)
    finally:
      fleet.close()

  def test_probe_readmits_evicted_replica(self):
    fleet, engines = _make_fleet()
    try:
      fleet.mark_unhealthy(0, "test")
      assert fleet.healthy_replicas() == [1]
      assert fleet.probe_replica(0, X1)
      assert sorted(fleet.healthy_replicas()) == [0, 1]
      engines[0].fail = True
      assert not fleet.probe_replica(0, X1) or True  # probe on failing
    finally:
      fleet.close()

  def test_deadline_error_is_final_not_retried(self):
    fleet, engines = _make_fleet(
        num_replicas=2,
        engines={0: _FakeEngine(0, delay_s=0.3),
                 1: _FakeEngine(1, delay_s=0.3)})
    try:
      # Block both workers, then submit a request with an expired-by-
      # dispatch deadline: it must shed as DeadlineError, not retry.
      blockers = [threading.Thread(target=lambda: fleet.predict(X1))
                  for _ in range(4)]
      for t in blockers:
        t.start()
      time.sleep(0.05)
      with pytest.raises(serving.DeadlineError):
        fleet.predict(X1, deadline_ms=1.0)
      for t in blockers:
        t.join()
    finally:
      fleet.close()

  def test_close_is_idempotent_and_joins_fronts(self):
    fleet, engines = _make_fleet()
    fleet.predict(X1)
    fleet.close()
    fleet.close()
    assert all(e.closed for e in engines.values())
    with pytest.raises(serving.ShutdownError):
      fleet.predict(X1)

  def test_heartbeat_timeout_evicts_stuck_replica(self):
    # A replica whose dispatch never completes (long sleep) holds
    # outstanding work past the heartbeat timeout: the next routing
    # decision evicts it and serves elsewhere.
    fleet, engines = _make_fleet(
        engines={0: _FakeEngine(0, delay_s=1.5), 1: _FakeEngine(1)},
        heartbeat_timeout_s=0.3)
    try:
      stuck = []
      for _ in range(2):  # occupy replica 0 (and maybe 1 briefly)
        t = threading.Thread(target=lambda: fleet.predict(X1))
        t.start()
        stuck.append(t)
      time.sleep(0.5)
      for _ in range(4):
        fleet.predict(X1)
      assert fleet_lib.UNHEALTHY in fleet.replica_states()
      for t in stuck:
        t.join()
    finally:
      fleet.close()


# ---------------------------------------------------------------------------
# Session affinity + displacement.
# ---------------------------------------------------------------------------


@pytest.mark.usefixtures("pkg")
class TestFleetSessions:

  def test_session_never_splits_across_replicas(self):
    fleet, engines = _make_fleet()
    try:
      sids = [fleet.open() for _ in range(12)]
      threads = []
      for _ in range(3):
        for sid in sids:
          threads.append(threading.Thread(
              target=lambda s=sid: fleet.step(s, X1)))
      for t in threads:
        t.start()
      for t in threads:
        t.join()
      # Every fleet session's ticks landed on exactly one engine: each
      # engine's per-sid tick counts account for whole sessions.
      for sid in sids:
        owner = fleet.session_replica(sid)
        assert owner in (0, 1)
      total_ticks = sum(sum(e.sessions.values()) for e in engines.values())
      assert total_ticks == 3 * len(sids)
      for sid in sids:
        fleet.close_session(sid)
    finally:
      fleet.close()

  def test_same_key_maps_to_same_replica(self):
    fleet, _ = _make_fleet()
    try:
      a = fleet.open(session_key="robot-7")
      b = fleet.open(session_key="robot-7")
      assert fleet.session_replica(a) == fleet.session_replica(b)
      fleet.close_session(a)
      fleet.close_session(b)
    finally:
      fleet.close()

  def test_health_evict_reopens_sessions_elsewhere(self):
    fleet, engines = _make_fleet()
    try:
      with metrics_lib.isolated() as registry:
        sids = [fleet.open() for _ in range(8)]
        for sid in sids:
          fleet.step(sid, X1)
        displaced = [s for s in sids if fleet.session_replica(s) == 0]
        assert displaced, "hash ring should place some sessions on 0"
        fleet.mark_unhealthy(0, "test")
        # Every session keeps ticking: displaced ones re-open on 1.
        for sid in sids:
          out = fleet.step(sid, X1)
          assert out["out"].shape == X1["x"].shape
        assert all(fleet.session_replica(s) == 1 for s in sids)
        snap = registry.snapshot()
      assert snap["counter/serve/fleet/session_reopens"] == len(displaced)
      # A reopened session restarted its episode (fresh state): its
      # tick count on the new replica is 1, not 2.
      for sid in displaced:
        inner = fleet._sessions[sid].inner_sid
        assert engines[1].sessions[inner] == 1
    finally:
      fleet.close()

  def test_strict_mode_raises_session_evicted(self):
    fleet, _ = _make_fleet(session_reopen="evict")
    try:
      sids = [fleet.open() for _ in range(8)]
      on_zero = [s for s in sids if fleet.session_replica(s) == 0]
      assert on_zero
      fleet.mark_unhealthy(0, "test")
      with pytest.raises(serving.SessionEvictedError):
        fleet.step(on_zero[0], X1)
      # The mapping is dropped: a later step is an unknown session.
      with pytest.raises(serving.UnknownSessionError):
        fleet.step(on_zero[0], X1)
    finally:
      fleet.close()

  def test_full_replica_ring_walks_to_next(self):
    fleet, engines = _make_fleet(
        engines={0: _FakeEngine(0, max_sessions=1),
                 1: _FakeEngine(1, max_sessions=64)})
    try:
      sids = [fleet.open() for _ in range(6)]
      owners = [fleet.session_replica(s) for s in sids]
      assert owners.count(0) <= 1  # replica 0 admits at most its 1 slot
      assert all(o is not None for o in owners)
    finally:
      fleet.close()

  def test_unknown_session_raises(self):
    fleet, _ = _make_fleet()
    try:
      with pytest.raises(serving.UnknownSessionError):
        fleet.step(12345, X1)
      with pytest.raises(serving.UnknownSessionError):
        fleet.close_session(12345)
    finally:
      fleet.close()


# ---------------------------------------------------------------------------
# Health wiring: incidents out, sentinel stream in.
# ---------------------------------------------------------------------------


@pytest.mark.usefixtures("pkg")
class TestFleetHealthWiring:

  def test_eviction_emits_replica_unhealthy_incident(self):
    incidents = []
    fleet, _ = _make_fleet(sinks=[incidents.append])
    try:
      fleet.mark_unhealthy(1, "operator drill")
      assert len(incidents) == 1
      record = incidents[0]
      assert record["kind"] == sentinel_lib.REPLICA_UNHEALTHY
      assert record["detail"]["replica"] == 1
      assert record["detail"]["reason"] == "operator drill"
      assert record["schema"] == "graftscope-incident-v1"
    finally:
      fleet.close()

  def test_sentinel_sink_evicts_on_fatal_replica_incident(self):
    fleet, _ = _make_fleet()
    try:
      sink = fleet.sentinel_sink()
      # Non-fatal: ignored. Fatal without replica: ignored.
      sink(runlog_lib.make_incident("step_time_spike", step=1,
                                    severity="warn",
                                    detail={"replica": 0}))
      sink(runlog_lib.make_incident("nonfinite_params", step=1,
                                    severity="fatal"))
      assert sorted(fleet.healthy_replicas()) == [0, 1]
      # Fatal + replica-addressed: evicts.
      sink(runlog_lib.make_incident("nonfinite_params", step=2,
                                    severity="fatal",
                                    detail={"replica": 0}))
      assert fleet.healthy_replicas() == [1]
      assert fleet.replica_states()[0] == fleet_lib.UNHEALTHY
    finally:
      fleet.close()


@pytest.mark.usefixtures("pkg")
class TestFleetProbation:
  """Replica probation: eviction -> background probe loop under the
  RetryPolicy -> auto-readmit, plus the manual `mark_healthy` /
  `probe_replica` paths."""

  def _probation_policy(self, **kwargs):
    kwargs.setdefault("name", "fleet_probation")
    kwargs.setdefault("max_attempts", 10)
    kwargs.setdefault("base_delay_s", 0.01)
    kwargs.setdefault("max_delay_s", 0.05)
    return retry_lib.RetryPolicy(**kwargs)

  def _wait_healthy(self, fleet, want, timeout_s=5.0):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
      if len(fleet.healthy_replicas()) >= want:
        return True
      time.sleep(0.01)
    return False

  def test_manual_mark_healthy_readmits_and_routes(self):
    with metrics_lib.isolated() as registry:
      fleet, engines = _make_fleet()
      try:
        fleet.mark_unhealthy(0, "operator drill")
        assert fleet.healthy_replicas() == [1]
        for _ in range(4):
          fleet.predict(X1)
        assert not engines[0].served_rows  # router steered around it
        fleet.mark_healthy(0)
        assert sorted(fleet.healthy_replicas()) == [0, 1]
        for _ in range(8):
          fleet.predict(X1)
        assert engines[0].served_rows  # routed again
      finally:
        fleet.close()
      snap = registry.snapshot(prefix="serve/fleet/")
    # Eviction-to-readmission MTTR recorded even for the manual path.
    assert snap["hist/serve/fleet/readmit_ms/count"] == 1.0

  def test_manual_probe_replica_paths(self):
    fleet, engines = _make_fleet()
    try:
      fleet.mark_unhealthy(1, "drill")
      engines[1].fail = True
      assert fleet.probe_replica(1, X1) is False  # failed probe: stays out
      assert fleet.healthy_replicas() == [0]
      engines[1].fail = False
      assert fleet.probe_replica(1, X1) is True
      assert sorted(fleet.healthy_replicas()) == [0, 1]
    finally:
      fleet.close()

  def test_probation_auto_readmits_after_transient_failure(self):
    with metrics_lib.isolated() as registry:
      fleet, engines = _make_fleet(
          probation_probe=lambda: X1,
          probation_policy=self._probation_policy())
      try:
        engines[1].fail = True  # replica down: probes fail too
        fleet.mark_unhealthy(1, "transient fault")
        assert fleet.healthy_replicas() == [0]
        time.sleep(0.05)  # a few failed probes accumulate
        engines[1].fail = False  # fault clears; next probe readmits
        assert self._wait_healthy(fleet, 2), fleet.replica_states()
      finally:
        fleet.close()
      snap = registry.snapshot(prefix="serve/fleet/")
    assert snap["counter/serve/fleet/probation_readmits"] == 1.0
    assert snap["counter/serve/fleet/probation_probes"] >= 2.0
    assert snap.get("counter/serve/fleet/probation_giveups", 0.0) == 0.0
    assert snap["hist/serve/fleet/readmit_ms/count"] == 1.0

  def test_probation_giveup_stays_evicted_until_manual(self):
    with metrics_lib.isolated() as registry:
      fleet, engines = _make_fleet(
          probation_probe=lambda: X1,
          probation_policy=self._probation_policy(max_attempts=2))
      try:
        engines[0].fail = True  # stays broken past the probe budget
        fleet.mark_unhealthy(0, "hard fault")
        deadline = time.monotonic() + 5.0
        while time.monotonic() < deadline:
          if registry.snapshot(prefix="serve/fleet/").get(
              "counter/serve/fleet/probation_giveups"):
            break
          time.sleep(0.01)
        snap = registry.snapshot(prefix="serve/fleet/")
        assert snap["counter/serve/fleet/probation_giveups"] == 1.0
        assert fleet.healthy_replicas() == [1]  # gave up, stays out
        # The manual recovery half still works after a give-up.
        engines[0].fail = False
        assert fleet.probe_replica(0, X1) is True
        assert sorted(fleet.healthy_replicas()) == [0, 1]
      finally:
        fleet.close()

  def test_sentinel_roundtrip_readmit_rebalance_under_load(self):
    """The full detect->recover round trip under open-loop load:
    sentinel fatal incident -> eviction -> displaced session re-opens
    on a healthy replica -> probation probe auto-readmits -> new
    sessions re-balance onto the readmitted replica — with ZERO failed
    requests in the concurrent open-loop window."""
    outcome: dict = {}
    # The replica's state as its eviction is reported: read after the
    # sink returns, a fast probation probe may already have readmitted
    # it.
    fleet, engines = _make_fleet(
        probation_probe=lambda: X1,
        probation_policy=self._probation_policy(),
        sinks=[lambda record: outcome.setdefault(
            "evicted", fleet.replica_states()[record["detail"]["replica"]])])
    try:
      sid = fleet.open(session_key="robot-7")
      owner = fleet.session_replica(sid)
      assert owner is not None
      survivor = 1 - owner

      def choreography():
        time.sleep(0.05)  # load window established
        # 1. Fatal sentinel incident names the session's replica.
        fleet.sentinel_sink()(runlog_lib.make_incident(
            sentinel_lib.NONFINITE_PARAMS, step=7, severity="fatal",
            detail={"replica": owner}))
        # 2. The displaced session's next tick re-opens elsewhere.
        out = fleet.step(sid, X1)
        outcome["tick_ok"] = bool(np.asarray(out["out"]).shape)
        outcome["reopened_on"] = fleet.session_replica(sid)
        # 3. Probation auto-readmits (probes succeed: the fake engine
        #    never actually broke — the incident was the fault).
        outcome["readmitted"] = self._wait_healthy(fleet, 2)
        # 4. New sessions re-balance: the readmitted replica accepts
        #    an open again (its own affinity key routes back to it).
        for i in range(64):
          new_sid = fleet.open(session_key=f"rebalance-{i}")
          if fleet.session_replica(new_sid) == owner:
            outcome["rebalanced"] = True
            break
        else:
          outcome["rebalanced"] = False

      chaos = threading.Thread(target=choreography)
      chaos.start()
      result = loadgen.run_trace_load(
          predict=fleet.predict, make_request=lambda i: X1,
          num_arrivals=600, rate_hz=1500.0, profile="poisson", seed=3,
          max_client_threads=16)
      chaos.join(timeout=10.0)
      assert not chaos.is_alive()
      assert outcome["evicted"] == fleet_lib.UNHEALTHY
      assert outcome["tick_ok"]
      assert outcome["reopened_on"] == survivor  # never the dead replica
      assert outcome["readmitted"], fleet.replica_states()
      assert outcome["rebalanced"]
      # The pin: the open-loop window saw ZERO failed requests across
      # the whole eviction->readmission cycle (failover + the healthy
      # replica absorbed everything).
      assert result["errors"] == {}
      assert result["ok_requests"] == result["arrivals"]
      assert sorted(fleet.healthy_replicas()) == [0, 1]
    finally:
      fleet.close()


# ---------------------------------------------------------------------------
# Rollout (backend-free fakes; the real-checkpoint pin is below).
# ---------------------------------------------------------------------------


@pytest.mark.usefixtures("pkg")
class TestFleetRolloutFakes:

  def test_rollout_under_load_zero_failures(self):
    fleet, engines = _make_fleet()
    try:
      stop = [False]
      failures = []

      def load():
        while not stop[0]:
          try:
            fleet.predict(X1)
          except Exception as e:  # noqa: BLE001 - the pin: none happen
            failures.append(e)

      threads = [threading.Thread(target=load) for _ in range(3)]
      for t in threads:
        t.start()
      report = fleet.rollout(probe_request=X1)
      stop[0] = True
      for t in threads:
        t.join()
      assert report["swapped"] == 2
      assert report["aborted"] is None
      assert report["parity_ok"] is True
      assert report[FRESH] == 0
      assert not failures, failures
      assert all(e.version == 2 for e in engines.values())
    finally:
      fleet.close()

  def test_canary_verify_failure_aborts_rest_and_evicts_canary(self):
    incidents = []
    fleet, engines = _make_fleet(sinks=[incidents.append])
    try:
      report = fleet.rollout(probe_request=X1, verify=lambda out: False)
      assert report["swapped"] == 0
      assert "canary" in report["aborted"]
      # The canary already swapped its params (restore ran) but the
      # SECOND replica never did: the fleet still serves old params.
      versions = sorted(e.version for e in engines.values())
      assert versions == [1, 2]
      # The canary must NOT rejoin the routing set — it runs the exact
      # checkpoint verification rejected. It is evicted (incident
      # emitted); traffic flows only on the old-checkpoint replica.
      canary = report["canary_index"]
      assert fleet.replica_states()[canary] == fleet_lib.UNHEALTHY
      assert fleet.healthy_replicas() == [1 - canary]
      assert any(r["detail"]["reason"] == "rollout verification failed"
                 for r in incidents)
      old_replica = engines[1 - canary]
      before = len(old_replica.served_rows)
      canary_before = len(engines[canary].served_rows)  # the probe
      for _ in range(4):
        fleet.predict(X1)
      assert len(old_replica.served_rows) > before
      assert len(engines[canary].served_rows) == canary_before
    finally:
      fleet.close()

  def test_rollout_completes_under_continuous_session_traffic(self):
    """Session ticks deliberately keep flowing through a swap (restore
    hot-swaps under live sessions); they must not hold the rollout
    drain open, and no tick fails across the whole roll."""
    fleet, engines = _make_fleet()
    try:
      sids = [fleet.open() for _ in range(4)]
      stop = [False]
      failures = []

      def tick_loop():
        while not stop[0]:
          for sid in sids:
            try:
              fleet.step(sid, X1)
            except Exception as e:  # noqa: BLE001 - the pin: none happen
              failures.append(e)

      thread = threading.Thread(target=tick_loop)
      thread.start()
      t0 = time.monotonic()
      report = fleet.rollout(probe_request=X1, drain_timeout_s=5.0)
      elapsed = time.monotonic() - t0
      stop[0] = True
      thread.join()
      assert report["swapped"] == 2
      assert all(e["drained"] for e in report["replicas"])
      assert elapsed < 4.0, elapsed  # drain never waited out the timeout
      assert not failures, failures
      for sid in sids:
        fleet.close_session(sid)
    finally:
      fleet.close()

  def test_rollout_steers_router_around_swapping_replica(self):
    # A slow restore would stall traffic if the router kept routing to
    # the swapping replica; it must not.
    class _SlowRestore(_FakeEngine):
      def restore(self):
        time.sleep(0.2)
        return super().restore()

    fleet, engines = _make_fleet(
        engines={0: _SlowRestore(0), 1: _SlowRestore(1)})
    try:
      latencies = []
      stop = [False]

      def load():
        while not stop[0]:
          t0 = time.perf_counter()
          fleet.predict(X1)
          latencies.append(time.perf_counter() - t0)

      thread = threading.Thread(target=load)
      thread.start()
      report = fleet.rollout(probe_request=X1)
      stop[0] = True
      thread.join()
      assert report["swapped"] == 2
      # No request waited out a 200 ms restore window.
      assert max(latencies) < 0.15, max(latencies)
    finally:
      fleet.close()


# ---------------------------------------------------------------------------
# Traffic-derived bucket ladder.
# ---------------------------------------------------------------------------


@pytest.mark.usefixtures("pkg")
class TestTrafficLadder:

  def test_uniform_traffic_equals_fixed_ladder(self):
    sizes = list(range(1, 9)) * 25
    assert engine_lib.traffic_bucket_ladder(sizes, 8) == \
        engine_lib.bucket_ladder(8)

  def test_empty_returns_fixed_fallback(self):
    assert engine_lib.traffic_bucket_ladder([], 8) == [1, 2, 4, 8]

  def test_skewed_traffic_merges_and_splits(self):
    sizes = [1] * 2 + [6] * 98
    derived = engine_lib.traffic_bucket_ladder(sizes, 8)
    assert 6 in derived, derived  # the hot size earned its own rung
    assert derived[-1] == 8      # the top rung is always max
    assert len(derived) < 4      # under-trafficked rungs merged away
    fixed_stats = engine_lib.ladder_padding_stats(sizes, [1, 2, 4, 8])
    derived_stats = engine_lib.ladder_padding_stats(sizes, derived)
    assert derived_stats["padded_row_frac"] < \
        fixed_stats["padded_row_frac"]

  def test_oversize_counts_as_top_and_chunks(self):
    stats = engine_lib.ladder_padding_stats([20], [1, 2, 4, 8])
    # 20 rows = 2 full top-bucket chunks + one 4-row chunk: no padding.
    assert stats["dispatched_rows"] == 20.0
    ladder = engine_lib.traffic_bucket_ladder([20] * 10, 8)
    assert ladder[-1] == 8

  def test_observed_rows_flow_from_batcher_telemetry(self):
    backend = lambda f: {"out": np.asarray(f["x"])}  # noqa: E731
    with metrics_lib.isolated():
      with serving.MicroBatcher(backend=backend, max_batch_size=8,
                                max_delay_ms=1.0) as batcher:
        for rows in (1, 1, 1, 3):
          batcher.predict({"x": np.ones((rows, 2), np.float32)})
      observed = engine_lib.observed_request_rows()
      assert sorted(observed) == [1, 1, 1, 3]
      derived = engine_lib.traffic_bucket_ladder(observed, 8,
                                                 min_share=0.05)
      assert derived[-1] == 8

  def test_derivation_is_deterministic(self):
    sizes = ([3] * 50 + [1] * 10 + [7] * 40)
    a = engine_lib.traffic_bucket_ladder(sizes, 8)
    b = engine_lib.traffic_bucket_ladder(list(sizes), 8)
    assert a == b


# ---------------------------------------------------------------------------
# Trace-driven arrival processes.
# ---------------------------------------------------------------------------


@pytest.mark.usefixtures("pkg")
class TestArrivalProfiles:

  def test_poisson_matches_legacy_session_load_stream(self):
    # run_session_load's per-seed arrival trace is pinned: the shared
    # arrival_gaps("poisson") draws this RandomState stream.
    legacy = np.random.RandomState(7).exponential(1.0 / 50.0, size=20)
    np.testing.assert_array_equal(
        loadgen.arrival_gaps(20, 50.0, "poisson", seed=7), legacy)

  def test_deterministic_per_seed_and_profile(self):
    for profile in loadgen.ARRIVAL_PROFILES:
      a = loadgen.arrival_gaps(64, 100.0, profile, seed=3)
      b = loadgen.arrival_gaps(64, 100.0, profile, seed=3)
      c = loadgen.arrival_gaps(64, 100.0, profile, seed=4)
      np.testing.assert_array_equal(a, b)
      assert not np.array_equal(a, c)

  def test_mean_rates_near_target(self):
    for profile in loadgen.ARRIVAL_PROFILES:
      gaps = loadgen.arrival_gaps(4000, 200.0, profile, seed=1)
      achieved = 1.0 / gaps.mean()
      assert 150.0 < achieved < 260.0, (profile, achieved)

  def test_mmpp_is_burstier_than_poisson(self):
    poisson = loadgen.arrival_gaps(4000, 200.0, "poisson", seed=1)
    mmpp = loadgen.arrival_gaps(4000, 200.0, "mmpp", seed=1)
    cv = lambda g: g.std() / g.mean()  # noqa: E731
    assert cv(mmpp) > cv(poisson) * 1.2

  def test_diurnal_peak_vs_trough(self):
    # One sine period across the trace: the first half (peak) must hold
    # more arrivals than the second (trough).
    gaps = loadgen.arrival_gaps(2000, 100.0, "diurnal", seed=2,
                                diurnal_amplitude=0.9)
    times = np.cumsum(gaps)
    span = times[-1]
    first_half = int((times < span / 2).sum())
    assert first_half > 0.58 * len(times), first_half / len(times)

  def test_invalid_args_raise(self):
    with pytest.raises(ValueError, match="profile"):
      loadgen.arrival_gaps(10, 10.0, "weekly")
    with pytest.raises(ValueError, match="base state"):
      loadgen.arrival_gaps(10, 10.0, "mmpp", burst_factor=5.0,
                           burst_fraction=0.25)
    with pytest.raises(ValueError, match="amplitude"):
      loadgen.arrival_gaps(10, 10.0, "diurnal", diurnal_amplitude=1.5)

  def test_trace_load_mixed_counts(self):
    ticks = []

    class _Sess:
      def open(self):
        return 1

      def step(self, sid, obs):
        ticks.append(sid)
        return {}

      def close_session(self, sid):
        pass

    requests = []
    result = loadgen.run_trace_load(
        predict=lambda r: requests.append(1),
        make_request=lambda i: {},
        session_target=_Sess(), make_obs=lambda i, t: {},
        num_arrivals=80, rate_hz=2000.0, profile="poisson", seed=5,
        session_fraction=0.25, episode_ticks=3)
    assert result["arrivals"] == 80
    assert result["session_arrivals"] == result["completed_episodes"]
    assert result["stateless_arrivals"] == result["ok_requests"]
    assert result["ok_ticks"] == 3 * result["session_arrivals"]
    assert len(requests) == result["ok_requests"]
    # The mix is deterministic per seed.
    again = loadgen.run_trace_load(
        predict=lambda r: None, make_request=lambda i: {},
        session_target=_Sess(), make_obs=lambda i, t: {},
        num_arrivals=80, rate_hz=2000.0, profile="poisson", seed=5,
        session_fraction=0.25, episode_ticks=3)
    assert again["session_arrivals"] == result["session_arrivals"]

  def test_trace_load_counts_errors_never_raises(self):
    def predict(request):
      raise RuntimeError("down")

    result = loadgen.run_trace_load(
        predict=predict, make_request=lambda i: {},
        num_arrivals=20, rate_hz=5000.0, seed=1)
    assert result["errors"] == {"RuntimeError": 20}
    assert result["ok_requests"] == 0

  def test_trace_load_validates_mix_targets(self):
    with pytest.raises(ValueError, match="session_target"):
      loadgen.run_trace_load(predict=lambda r: None,
                             make_request=lambda i: {},
                             num_arrivals=4, session_fraction=0.5)
    with pytest.raises(ValueError, match="predict"):
      loadgen.run_trace_load(session_target=object(),
                             make_obs=lambda i, t: {},
                             num_arrivals=4, session_fraction=0.5)
    # A pure-session load (fraction 1.0) legitimately needs no predict.
    class _Sess:
      def open(self):
        return 1

      def step(self, sid, obs):
        return {}

      def close_session(self, sid):
        pass

    result = loadgen.run_trace_load(
        session_target=_Sess(), make_obs=lambda i, t: {},
        num_arrivals=4, rate_hz=5000.0, session_fraction=1.0,
        episode_ticks=1)
    assert result["completed_episodes"] == 4


@pytest.mark.usefixtures("pkg")
class TestFleetAutoscaleSignal:
  """The advisory `recommended_replicas()` signal from the shed,
  occupancy and outstanding window: no actuation, the number an
  autoscaler or an operator dashboard would read."""

  def test_no_traffic_recommends_current_healthy(self):
    fleet, _ = _make_fleet(num_replicas=2)
    try:
      with metrics_lib.isolated() as registry:
        assert fleet.recommended_replicas() == 2
        snap = registry.snapshot()
      assert snap["gauge/serve/fleet/recommended_replicas"] == 2.0
    finally:
      fleet.close()

  def test_in_window_shed_recommends_scale_up(self):
    # Slow replica + tiny queue bound: overload sheds, and shedding is
    # a hard under-capacity signal — at least one MORE replica than
    # currently healthy, whatever occupancy says.
    fleet, _ = _make_fleet(
        num_replicas=1, engines={0: _FakeEngine(0, delay_s=0.05)},
        shed_outstanding=2, autoscale_sample_s=0.0)
    try:
      threads = [threading.Thread(
          target=lambda: _swallow_shed(fleet)) for _ in range(12)]
      for t in threads:
        t.start()
      for t in threads:
        t.join()
      assert fleet.recommended_replicas() >= 2
    finally:
      fleet.close()

  def test_diurnal_profile_exercises_window(self):
    # The diurnal open-loop trace drives the sliding window end to end:
    # samples accumulate on the routing hot path, the recommendation
    # stays >= 1 and the gauge is (re)exported.
    fleet, _ = _make_fleet(
        num_replicas=2,
        engines={0: _FakeEngine(0, delay_s=0.002),
                 1: _FakeEngine(1, delay_s=0.002)},
        autoscale_sample_s=0.0)
    try:
      with metrics_lib.isolated() as registry:
        result = loadgen.run_trace_load(
            predict=fleet.predict, make_request=lambda i: X1,
            num_arrivals=120, rate_hz=600.0, profile="diurnal",
            seed=3, max_client_threads=16)
        assert result["ok_requests"] > 0
        recommended = fleet.recommended_replicas()
        snap = registry.snapshot()
      assert recommended >= 1
      assert snap["gauge/serve/fleet/recommended_replicas"] == float(
          recommended)
    finally:
      fleet.close()

  def test_horizon_outcome_closes_the_inner_slot(self):
    # A SessionHorizonError leaves the INNER session alive holding its
    # arena slot, but the fleet pops its sid mapping — so the policy's
    # close_session(sid) can never reach it. The fleet must close the
    # inner slot itself or one replica slot leaks per horizon-hitting
    # episode (denial-of-service under admission='shed').
    class _HorizonEngine(_FakeEngine):
      def step(self, sid, obs):
        raise session_lib.SessionHorizonError("episode outran horizon",
                                              sid)

    engine = _HorizonEngine(0)
    fleet, _ = _make_fleet(num_replicas=1, engines={0: engine})
    try:
      sid = fleet.open()
      assert engine.sessions  # the inner slot is held
      with pytest.raises(session_lib.SessionHorizonError):
        fleet.step(sid, X1)
      assert engine.sessions == {}  # ...and freed by the fleet
    finally:
      fleet.close()

  def test_session_only_traffic_feeds_the_window(self):
    # A fleet serving ONLY session-affine traffic must still open the
    # autoscale window's requests gate: light session occupancy
    # computes ~1 replica via the utilization formula — distinguishable
    # from the "no signal -> current healthy (2)" fallback that blind
    # (stateless-only) accounting would produce.
    fleet, _ = _make_fleet(num_replicas=2, autoscale_sample_s=0.0)
    try:
      sid = fleet.open()
      for _ in range(6):
        fleet.step(sid, X1)
      fleet.close_session(sid)
      assert fleet.recommended_replicas() == 1
    finally:
      fleet.close()

  def test_idle_window_decays_back_to_healthy(self):
    fleet, _ = _make_fleet(
        num_replicas=1, engines={0: _FakeEngine(0, delay_s=0.05)},
        shed_outstanding=2, autoscale_sample_s=0.0)
    try:
      threads = [threading.Thread(
          target=lambda: _swallow_shed(fleet)) for _ in range(12)]
      for t in threads:
        t.start()
      for t in threads:
        t.join()
      assert fleet.recommended_replicas() >= 2
      # A window that excludes the burst sees no traffic: no signal, no
      # change — the diurnal trough reads low instead of latching the
      # peak forever.
      time.sleep(0.05)
      assert fleet.recommended_replicas(window_s=0.01) == 1
    finally:
      fleet.close()

  def test_target_utilization_validated(self):
    with pytest.raises(ValueError):
      fleet, _ = _make_fleet(num_replicas=1,
                             autoscale_target_utilization=1.5)


def _swallow_shed(fleet):
  try:
    fleet.predict(X1)
  except serving.FleetShedError:
    pass




# ---------------------------------------------------------------------------
# Port only: the device carve-out, cross-package equality, real replicas.
# ---------------------------------------------------------------------------


def _mock_predictor(device="cpu", model_dir=None):
  from tensor2robot_tpu_torch.predictors import predictors as predictors_lib
  from tensor2robot_tpu_torch.utils import mocks

  predictor = predictors_lib.CheckpointPredictor(
      model=mocks.MockT2RModel(), model_dir=model_dir, device=device)
  if model_dir is None:
    predictor.init_randomly()
  return predictor


class TestReplicaDeviceGroups:

  DEVICES = [torch.device("cpu")] * 8

  def test_carve_is_disjoint_and_covering(self):
    from tensor2robot_tpu_torch.parallel import mesh as mesh_lib

    names = [f"cuda:{i}" for i in range(8)]
    groups = mesh_lib.replica_device_groups(2, names)
    assert [len(g) for g in groups] == [4, 4]
    assert [d for g in groups for d in g] == names

  def test_remainder_spreads_over_first_groups(self):
    from tensor2robot_tpu_torch.parallel import mesh as mesh_lib

    names = [f"cuda:{i}" for i in range(8)]
    groups = mesh_lib.replica_device_groups(3, names)
    assert [len(g) for g in groups] == [3, 3, 2]
    assert len({d for g in groups for d in g}) == 8

  def test_errors(self):
    from tensor2robot_tpu_torch.parallel import mesh as mesh_lib

    with pytest.raises(ValueError, match=">= 1"):
      mesh_lib.replica_device_groups(0, self.DEVICES)
    with pytest.raises(ValueError, match="cannot carve"):
      mesh_lib.replica_device_groups(9, self.DEVICES)

  def test_one_card_listed_twice_gives_two_replicas(self):
    from tensor2robot_tpu_torch.parallel import mesh as mesh_lib

    card = torch.device("cuda", 0)
    assert mesh_lib.replica_device_groups(2, [card, card]) == [[card],
                                                                [card]]

  def test_default_is_every_visible_card(self, monkeypatch):
    from tensor2robot_tpu_torch.parallel import mesh as mesh_lib

    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert mesh_lib.replica_device_groups(2) == [
        [torch.device("cuda", 0)], [torch.device("cuda", 1)]]
    with pytest.raises(ValueError, match="cannot carve"):
      mesh_lib.replica_device_groups(3)


class TestAcrossPackages:
  """One input, one answer in both packages."""

  def test_session_keys_land_on_the_same_replica(self):
    placements = {}
    for name, p in PACKAGES.items():
      fleet = p["serving"].ServingFleet(
          replica_factory=lambda i, d: _FakeEngine(i), num_replicas=3,
          max_delay_ms=1.0)
      try:
        placements[name] = [
            fleet.session_replica(fleet.open(session_key=f"robot-{k}"))
            for k in range(40)]
      finally:
        fleet.close()
    assert placements["port"] == placements["jax"]
    assert len(set(placements["port"])) == 3

  @pytest.mark.parametrize("profile", ["poisson", "mmpp", "diurnal"])
  def test_arrival_streams_are_equal(self, profile):
    np.testing.assert_array_equal(
        port_loadgen.arrival_gaps(256, 120.0, profile, seed=11),
        jax_loadgen.arrival_gaps(256, 120.0, profile, seed=11))

  def test_derived_ladders_are_equal(self):
    rng = np.random.RandomState(0)
    for _ in range(20):
      sizes = list(rng.choice([1, 2, 3, 5, 6, 9, 16, 24], size=200,
                              p=rng.dirichlet(np.ones(8))))
      assert (port_engine.traffic_bucket_ladder(sizes, 16)
              == jax_engine.traffic_bucket_ladder(sizes, 16))

  def test_rollout_reports_agree(self):
    reports = {}
    for name, p in PACKAGES.items():
      fleet = p["serving"].ServingFleet(
          replica_factory=lambda i, d: _FakeEngine(i), num_replicas=2,
          max_delay_ms=1.0)
      try:
        report = fleet.rollout(probe_request=X1)
      finally:
        fleet.close()
      # Timings differ; the warm and compile counts are each package's
      # own (the port reports both: its engines warm eagerly or compile).
      report.pop(p["FRESH"])
      report.pop("fresh_compiles", None)
      for entry in report["replicas"]:
        entry.pop("probe_ms")
        entry.pop(p["FRESH"])
        entry.pop("fresh_compiles", None)
      reports[name] = report
    assert reports["port"] == reports["jax"]


class TestFleetTorchIntegration:

  def test_two_replicas_on_device_groups_serve_and_pin_warms(self):
    reference = _mock_predictor()
    placed = []

    def factory(index, devices):
      predictor = _mock_predictor()
      predictor.place_on_device(devices[0])
      placed.append(predictor.device)
      return serving.BucketedEngine(predictor=predictor, max_batch_size=4)

    with metrics_lib.isolated():
      fleet = serving.ServingFleet(replica_factory=factory,
                                   num_replicas=2, devices=["cpu", "cpu"],
                                   max_batch_size=4, max_delay_ms=1.0,
                                   warmup=True)
      try:
        # Each replica restored its own predictor, pinned to its group.
        assert placed == [torch.device("cpu")] * 2
        assert fleet.replica_devices(0) == ["cpu"]
        assert fleet.replica(0)._predictor is not fleet.replica(1)._predictor
        warms = fleet.warm_counts()
        assert warms == [len(fleet.replica(0).buckets)] * 2
        rng = np.random.RandomState(0)
        threads = []
        mismatches = []

        def client(i):
          rows = int(rng.randint(1, 7))
          x = np.arange(rows * 3, dtype=np.float32).reshape(rows, 3) + i
          expected = reference.predict({"x": x})["prediction"]
          got = fleet.predict({"x": x})["prediction"]
          if not np.allclose(got, expected, rtol=1e-5, atol=1e-6):
            mismatches.append(i)

        for i in range(12):
          threads.append(threading.Thread(target=client, args=(i,)))
          threads[-1].start()
        for t in threads:
          t.join()
        assert not mismatches
        # No rung warmed again across the randomized concurrent sweep.
        assert fleet.warm_counts() == warms
      finally:
        fleet.close()


class TestFleetRolloutRealCheckpoints:
  """Rolling restore() across a 2-replica fleet under continuous load:
  0 failed requests, 0 fresh warms, and parity with a fresh fleet on the
  new checkpoint."""

  def test_zero_downtime_rollout_real_checkpoints(self, tmp_path):
    from tensor2robot_tpu_torch import checkpoints as checkpoints_lib
    from tensor2robot_tpu_torch import train_eval
    from tensor2robot_tpu_torch.utils import mocks

    model_dir = str(tmp_path / "m")
    train_eval.train_eval_model(
        model=mocks.MockT2RModel(), model_dir=model_dir, mode="train",
        max_train_steps=5, checkpoint_every_n_steps=5,
        input_generator_train=mocks.MockInputGenerator(batch_size=8),
        log_every_n_steps=5, device="cpu")

    def factory(index, devices):
      predictor = _mock_predictor(model_dir=model_dir)
      assert predictor.restore()
      return serving.BucketedEngine(predictor=predictor, max_batch_size=4)

    probe = {"x": np.linspace(-1.0, 1.0, 9,
                              dtype=np.float32).reshape(3, 3)}
    fleet = serving.ServingFleet(replica_factory=factory, num_replicas=2,
                                 max_batch_size=4, max_delay_ms=1.0,
                                 warmup=True)
    try:
      assert fleet.global_step == 5
      warms_before = fleet.warm_counts()
      before = fleet.predict(probe)["prediction"]

      # A NEW checkpoint (step 10) with deterministically different
      # parameters: the learner published.
      ckpt_dir = os.path.join(model_dir, "checkpoints")
      with checkpoints_lib.CheckpointManager(
          ckpt_dir, async_checkpointing=False) as manager:
        old = manager.restore()
        bump = lambda t: (None if t is None else  # noqa: E731
                          {k: v + 0.25 for k, v in t.items()})
        manager.save(10, old.replace(step=10, params=bump(old.params),
                                     ema_params=bump(old.ema_params)))

      stop = [False]
      failures = []
      served = [0]

      def load():
        while not stop[0]:
          try:
            fleet.predict(probe)
            served[0] += 1
          except Exception as e:  # noqa: BLE001 - the pin: none happen
            failures.append(e)

      threads = [threading.Thread(target=load) for _ in range(2)]
      for t in threads:
        t.start()
      time.sleep(0.1)
      report = fleet.rollout(probe_request=probe)
      stop[0] = True
      for t in threads:
        t.join()

      assert report["swapped"] == 2, report
      assert report["aborted"] is None
      assert report["parity_ok"] is True
      assert report["fresh_warms"] == 0
      assert fleet.warm_counts() == warms_before
      assert not failures, failures
      assert served[0] > 0
      assert fleet.global_step == 10

      after = fleet.predict(probe)["prediction"]
      assert not np.allclose(after, before), "new params not serving"
      fresh = serving.ServingFleet(replica_factory=factory,
                                   num_replicas=2, max_batch_size=4,
                                   max_delay_ms=1.0, warmup=True)
      try:
        np.testing.assert_allclose(fresh.predict(probe)["prediction"],
                                   after, rtol=1e-5)
      finally:
        fresh.close()
    finally:
      fleet.close()


def test_fleet_layer_never_initialises_cuda():
  """Routing, health eviction, session displacement, a full rollout and
  every arrival profile run in a process that never initialises CUDA:
  the fleet adds no device work of its own."""
  code = """
import numpy as np
import torch
from tensor2robot_tpu_torch import serving
from tensor2robot_tpu_torch.serving import loadgen

class Fake:
  def __init__(self, i):
    self.i = i; self.version = 1; self.warm_count = 0
    self.sessions = {}; self.n = 1
  def predict(self, f):
    return {"out": np.asarray(f["x"]) * self.version}
  def open(self):
    sid = self.n; self.n += 1; self.sessions[sid] = 0; return sid
  def step(self, sid, obs):
    self.sessions[sid] += 1; return {"out": np.asarray(obs["x"])}
  def close_session(self, sid): self.sessions.pop(sid, None)
  def restore(self): self.version += 1; return True
  def warmup(self): pass
  @property
  def model_version(self): return self.version
  @property
  def global_step(self): return self.version
  def close(self): pass

x = {"x": np.ones((1, 2), np.float32)}
with serving.ServingFleet(replica_factory=lambda i, d: Fake(i),
                          num_replicas=2, max_delay_ms=1.0) as fleet:
  fleet.predict(x)
  sids = [fleet.open() for _ in range(4)]
  for s in sids: fleet.step(s, x)
  fleet.mark_unhealthy(0, "trap")
  for s in sids: fleet.step(s, x)
  assert all(fleet.session_replica(s) == 1 for s in sids)
  fleet.mark_healthy(0)
  report = fleet.rollout(probe_request=x)
  assert report["swapped"] == 2 and report["parity_ok"], report
  for s in sids: fleet.close_session(s)
for profile in loadgen.ARRIVAL_PROFILES:
  gaps = loadgen.arrival_gaps(32, 100.0, profile, seed=1)
  assert gaps.shape == (32,)
assert not torch.cuda.is_initialized()
print("FLEET_NO_CUDA_OK")
"""
  env = {**os.environ, "PYTHONPATH": REPO_ROOT}
  result = subprocess.run(
      [sys.executable, "-c", code],
      capture_output=True, text=True, timeout=300, cwd=REPO_ROOT, env=env)
  assert result.returncode == 0, (result.stdout[-2000:],
                                  result.stderr[-2000:])
  assert "FLEET_NO_CUDA_OK" in result.stdout
