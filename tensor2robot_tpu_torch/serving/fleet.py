"""The serving fleet: several replicas behind a load-aware router, with
health eviction and a zero-downtime checkpoint rollout.

Counterpart of `tensor2robot_tpu.serving.fleet`, with the same states,
counters, incidents and configurable name. `ServingFleet` is a pool of N
engines in one process, each on its own device group
(`parallel.mesh.replica_device_groups` carves the device list the caller
gives; one card listed twice gives two replicas on that card, each with
its own weights and session arenas):

* REPLICAS: `replica_factory(index, devices)` builds each replica's
  engine (a `BucketedEngine`, a `SessionEngine`, or any object with the
  same surface); the factory builds the predictor and pins it with
  `predictor.place_on_device`. A replica with a `predict` surface gets
  its own `MicroBatcher` front; session surfaces are routed directly,
  or through a per-replica `SessionBatcher` with
  `session_batching=True`.
* ROUTER, stateless requests: least-outstanding-work dispatch,
  queue-depth shedding (`FleetShedError` when every healthy replica is at
  `shed_outstanding`), and ONE failover retry on another replica after a
  dispatch error or a replica's backpressure (a deadline expiry is
  final). The routing state is host-side counters.
* ROUTER, sessions: session -> replica affinity by consistent hashing
  (64 vnodes a replica) with a ring walk past unhealthy, swapping or
  full replicas. Every tick of a fleet session lands on the replica that
  holds its decode state.
* HEALTH: a replica is evicted on a streak of `unhealthy_after`
  dispatch failures, a stalled heartbeat (`heartbeat_timeout_s`: work
  outstanding, no completion), or a fatal incident naming it through
  `sentinel_sink()`. Eviction emits a `replica_unhealthy` incident,
  drains the replica and displaces its sessions: their next tick
  re-opens on a healthy replica (fresh decode state, counted
  `serve/fleet/session_reopens`; `session_reopen='evict'` raises
  `SessionEvictedError` instead). `probe_replica` and `mark_healthy`
  re-admit.
* PROBATION: with `probation_probe` set (a request factory), an evicted
  replica is probed in the background under `utils.retry.RetryPolicy`
  (`serve/fleet/probation_probes`) and re-admitted on the first probe
  that succeeds (`serve/fleet/probation_readmits`, eviction to
  readmission in `serve/fleet/readmit_ms`); past the policy's budget it
  stays evicted (`serve/fleet/probation_giveups`). The `obs.faultlab`
  points `serve.dispatch` and `serve.latency` inject per-replica
  dispatch failures and latency spikes inside the health accounting.
* ROLLOUT (`rollout()`): canary first, then one replica at a time under
  live traffic. Per replica: steer the router around it, wait for its
  stateless work to drain, `restore()` (a parameter swap: the warmed
  rungs stay warm), probe it directly, re-admit. The canary's probe
  outputs are the reference for every later replica; a canary that fails
  verification aborts the rollout with the rest of the fleet on the old
  checkpoint. As in the JAX package a rollout pays no fresh compile
  (`fresh_compiles` 0, from the engines' `compile_count`) and warms no
  new rung (`fresh_warms` 0, from their `warm_count`) unless it is given
  a new `ladder`, whose rungs `reladder` compiles (or loads) before the
  swap.

`derived_ladder()` gives the traffic-derived bucket ladder for the
request sizes seen; `recommended_replicas()` is the advisory replica
count from the load window (queue-bound sheds scale up; scale-in must be
backed by the `obs.usage.UsageLedger` utilization of the window);
`utilization_summary()` is the ledger's per-replica busy and idle
device-seconds. With `latency_slo_ms=` every routed predict's wall time
feeds `serve/slo_breaches` through `obs.sentinel.observe_serving_latency`.
A replica factory that gives its engines a `cache` (and one
`cache_namespace`) compiles the rungs once: the first replica stores the
compiler's artifacts and every later one loads them.
`warmup_provenance()` and `compile_counts()` read the replicas' compile
provenance, as the JAX fleet's do.

Telemetry: serve/fleet/{replicas,healthy,outstanding,version_skew,
warmup_ms,recommended_replicas,window_utilization} gauges;
serve/fleet/{requests,shed,retries,no_healthy,unhealthy,session_opens,
session_reopens,rollouts,rollout_swapped,probation_probes,
probation_readmits,probation_giveups} counters; serve/fleet/readmit_ms
histogram; the ledger's serve/fleet/device_seconds_{busy,idle},
utilization, cost_per_request_usd and busy_ms/<replica> mirrors.
"""

from __future__ import annotations

import collections
import math
import threading
import time
import zlib
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence

import numpy as np

from tensor2robot_tpu_torch.obs import faultlab as faultlab_lib
from tensor2robot_tpu_torch.obs import graftrace
from tensor2robot_tpu_torch.obs import metrics as obs_metrics
from tensor2robot_tpu_torch.obs import runlog as runlog_lib
from tensor2robot_tpu_torch.obs import sentinel as sentinel_lib
from tensor2robot_tpu_torch.obs import trace as obs_trace
from tensor2robot_tpu_torch.obs import usage as usage_lib
from tensor2robot_tpu_torch.serving import batcher as batcher_lib
from tensor2robot_tpu_torch.serving import session as session_lib
from tensor2robot_tpu_torch.utils import config
from tensor2robot_tpu_torch.utils import retry as retry_lib

__all__ = ["ServingFleet", "FleetShedError", "NoHealthyReplicaError"]

# Replica states. SERVING receives routed traffic; SWAPPING (a rollout
# swap in progress) is steered around but finishes what it holds;
# UNHEALTHY was evicted by the health machinery; CLOSED is terminal.
SERVING = "serving"
SWAPPING = "swapping"
UNHEALTHY = "unhealthy"
CLOSED = "closed"

_VNODES_PER_REPLICA = 64


class FleetShedError(batcher_lib.ShedError):
  """The fleet refused the request (every healthy replica at its
  queue-depth bound — backpressure, not failure)."""


class NoHealthyReplicaError(FleetShedError):
  """No replica is in the SERVING state (all unhealthy/swapping/closed)."""


class _Replica:
  """One fleet member: engine + front + router-side accounting.

  `outstanding` counts ALL router-tracked work (the least-loaded
  signal); `stateless_outstanding` counts only batcher-path requests —
  the rollout drain waits on THAT, because session ticks deliberately
  keep flowing through a swap (`restore()` hot-swaps under live
  sessions, the SessionEngine contract) and would otherwise hold the
  drain open for the whole timeout."""

  __slots__ = ("index", "devices", "engine", "front", "session_front",
               "state", "outstanding", "stateless_outstanding",
               "failure_streak", "last_ok_s", "unhealthy_reason")

  def __init__(self, index: int, devices, engine, front, session_front):
    self.index = index
    self.devices = devices
    self.engine = engine
    self.front = front
    self.session_front = session_front
    self.state = SERVING
    self.outstanding = 0
    self.stateless_outstanding = 0
    self.failure_streak = 0
    self.last_ok_s = time.monotonic()
    self.unhealthy_reason: Optional[str] = None


class _FleetSession:
  """Fleet-level session: a stable routing key + the replica-local sid
  it currently maps to."""

  __slots__ = ("key", "replica", "inner_sid", "displaced")

  def __init__(self, key: str, replica: _Replica, inner_sid: int):
    self.key = key
    self.replica = replica
    self.inner_sid = inner_sid
    self.displaced = False


def _hash32(text: str) -> int:
  # crc32: stable across processes (hash() is PYTHONHASHSEED-salted),
  # the same choice obs.metrics makes for its reservoir RNG seeds.
  return zlib.crc32(text.encode("utf-8")) & 0xFFFFFFFF


@config.configurable
class ServingFleet:
  """Multi-replica serving pool with load-aware routing (module doc).

  `replica_factory(index, devices)` -> engine-like object. The engine
  may expose a stateless surface (`predict`), a session surface
  (`open`/`step`/`step_many`/`close_session`), or both; the fleet
  routes each surface independently. `devices` is the per-replica
  device group (None entries when the fleet was built without device
  carve-out — e.g. backend-free tests).
  """

  def __init__(self,
               replica_factory: Optional[Callable[[int, Any], Any]] = None,
               num_replicas: int = 2,
               devices: Optional[Sequence[Any]] = None,
               max_batch_size: int = 8,
               max_delay_ms: float = 2.0,
               max_queue: int = 64,
               shed_outstanding: Optional[int] = None,
               unhealthy_after: int = 3,
               heartbeat_timeout_s: Optional[float] = None,
               session_reopen: str = "reopen",
               session_batching: bool = False,
               warmup: bool = False,
               name: str = "serve/fleet",
               sinks: Optional[List[Callable[[Dict[str, Any]], Any]]] = None,
               probation_probe: Optional[
                   Callable[[], Mapping[str, Any]]] = None,
               probation_policy: Optional[retry_lib.RetryPolicy] = None,
               autoscale_window_s: float = 30.0,
               autoscale_sample_s: float = 0.25,
               autoscale_target_utilization: float = 0.5,
               latency_slo_ms: Optional[float] = None,
               cost_per_device_hour_usd: float =
               usage_lib.COST_PER_DEVICE_HOUR_USD):
    if replica_factory is None:
      raise ValueError("replica_factory is required.")
    if num_replicas < 1:
      raise ValueError(f"num_replicas must be >= 1, got {num_replicas}")
    if session_reopen not in ("reopen", "evict"):
      raise ValueError("session_reopen must be 'reopen' or 'evict', "
                       f"got {session_reopen!r}")
    self._name = name
    self._sinks = list(sinks or [])
    self._unhealthy_after = max(int(unhealthy_after), 1)
    self._heartbeat_timeout_s = heartbeat_timeout_s
    self._session_reopen = session_reopen
    self._shed_outstanding = (shed_outstanding if shed_outstanding
                              is not None else max_queue)
    # Router-level latency objective (graftwatch): when set, every
    # routed predict's wall time feeds `serve/slo_breaches` through
    # `obs.sentinel.observe_serving_latency` — the bad-event counter
    # the SLO engine's burn-rate windows consume. None = not measured
    # (the per-request deadline path still counts its own breaches).
    self._latency_slo_ms = latency_slo_ms
    # Device-time ledger (obs.usage): busy windows flow in through the
    # batcher `usage=` hooks; wall windows open/close with replicas.
    self._usage = usage_lib.UsageLedger(
        name=name, cost_per_device_hour_usd=cost_per_device_hour_usd,
        sample_window_s=max(autoscale_window_s, 1.0),
        sample_interval_s=autoscale_sample_s)
    self._opened_s = time.monotonic()
    self._lock = threading.Lock()
    self._closed = False
    # Replica probation (module docstring): probe factory + policy
    # template; per-replica probe state lives in _probation (attempt
    # index, next-probe monotonic time) and the lazy worker thread.
    self._probation_probe = probation_probe
    self._probation_policy = probation_policy or retry_lib.RetryPolicy(
        name="fleet_probation", max_attempts=8, base_delay_s=0.05,
        multiplier=2.0, max_delay_s=1.0, jitter=0.5)
    self._probation: Dict[int, Dict[str, float]] = {}
    self._probation_thread: Optional[threading.Thread] = None
    self._probation_wake = threading.Event()
    self._evicted_at: Dict[int, float] = {}
    # Advisory-autoscale load window (recommended_replicas): samples of
    # (t, cumulative requests, cumulative queue-bound sheds, router-wide
    # outstanding) appended on the routing hot path at most once per
    # `autoscale_sample_s` — one time check + deque append per sample,
    # nothing per request.
    self._autoscale_window_s = float(autoscale_window_s)
    self._autoscale_sample_s = float(autoscale_sample_s)
    self._autoscale_target_util = float(autoscale_target_utilization)
    if not 0.0 < self._autoscale_target_util <= 1.0:
      raise ValueError("autoscale_target_utilization must be in (0, 1], "
                       f"got {autoscale_target_utilization}")
    self._load_requests = 0
    self._load_sheds = 0
    self._load_samples: collections.deque = collections.deque(
        maxlen=max(int(math.ceil(autoscale_window_s
                                 / max(autoscale_sample_s, 1e-3))) + 2, 8))
    self._last_sample_s = 0.0
    groups: List[Any]
    if devices is not None:
      from tensor2robot_tpu_torch.parallel import mesh as mesh_lib

      groups = mesh_lib.replica_device_groups(num_replicas, devices)
    else:
      groups = [None] * num_replicas
    self._replicas: List[_Replica] = []
    for index in range(num_replicas):
      engine = replica_factory(index, groups[index])
      group_name = f"replica{index}"
      group_devices = (len(groups[index])
                       if groups[index] is not None else 1)
      self._usage.open_group(group_name, devices=group_devices)
      recorder = self._usage.recorder(group_name)
      front = None
      if hasattr(engine, "predict"):
        front = batcher_lib.MicroBatcher(
            backend=engine, max_batch_size=max_batch_size,
            max_delay_ms=max_delay_ms, max_queue=max_queue,
            usage=recorder)
      session_front = None
      if hasattr(engine, "open") and hasattr(engine, "step"):
        # The SessionBatcher records its own dispatch windows; with
        # direct engine routing the fleet's `step()` records instead
        # (`_session_usage` non-None marks that case — exactly one
        # recorder per tick, never both).
        session_front = (session_lib.SessionBatcher(engine=engine,
                                                    usage=recorder)
                         if session_batching else engine)
      if front is None and session_front is None:
        raise ValueError(
            f"replica {index}'s engine exposes neither a predict nor a "
            "session surface")
      self._replicas.append(
          _Replica(index, groups[index], engine, front, session_front))
    # Consistent-hash ring for session affinity: vnodes per replica so
    # the key->replica map moves minimally as replicas come and go.
    ring = []
    for replica in self._replicas:
      for vnode in range(_VNODES_PER_REPLICA):
        ring.append((_hash32(f"{name}/r{replica.index}/v{vnode}"),
                     replica.index))
    self._ring = sorted(ring)
    self._sessions: Dict[int, _FleetSession] = {}
    self._next_session_id = 1
    obs_metrics.gauge("serve/fleet/replicas").set(float(num_replicas))
    self._healthy_gauge_locked()
    if warmup:
      self.warmup()

  # -- introspection --------------------------------------------------------

  @property
  def num_replicas(self) -> int:
    return len(self._replicas)

  def replica(self, index: int) -> Any:
    """The replica's engine (tests, direct probes)."""
    return self._replicas[index].engine

  def replica_devices(self, index: int):
    return self._replicas[index].devices

  def replica_states(self) -> List[str]:
    with self._lock:
      return [r.state for r in self._replicas]

  def healthy_replicas(self) -> List[int]:
    with self._lock:
      return [r.index for r in self._replicas if r.state == SERVING]

  def outstanding(self) -> int:
    with self._lock:
      return sum(r.outstanding for r in self._replicas)

  def compile_counts(self) -> List[Optional[int]]:
    """Each replica engine's `compile_count` (None for an engine
    without)."""
    return [getattr(r.engine, "compile_count", None)
            for r in self._replicas]

  def warmup_provenance(self) -> List[Dict[str, Any]]:
    """Every replica engine's `warmup_provenance` entries, each stamped
    with its `replica` index."""
    out = []
    for replica in self._replicas:
      for entry in getattr(replica.engine, "warmup_provenance", []) or []:
        out.append({"replica": replica.index, **entry})
    return out

  def warm_counts(self) -> List[Optional[int]]:
    """Each replica engine's `warm_count` (None for an engine without)."""
    return [getattr(r.engine, "warm_count", None)
            for r in self._replicas]

  def session_replica(self, session_id: int) -> Optional[int]:
    """Which replica currently owns a fleet session (None = unknown)."""
    with self._lock:
      entry = self._sessions.get(session_id)
      return entry.replica.index if entry is not None else None

  def derived_ladder(self, max_batch_size: int,
                     **kwargs) -> List[int]:
    """The traffic-derived bucket ladder for the request sizes this
    fleet has actually observed (`engine.traffic_bucket_ladder` over
    the `serve/request_rows` reservoir; the fixed ladder when no
    traffic has been seen)."""
    from tensor2robot_tpu_torch.serving import engine as engine_lib

    return engine_lib.traffic_bucket_ladder(
        engine_lib.observed_request_rows(), max_batch_size, **kwargs)

  # -- advisory autoscale ---------------------------------------------------

  def _sample_load_locked(self, now: float) -> None:
    """Appends one load-window sample at most every
    `autoscale_sample_s` (called on the routing hot path under the
    lock: one time comparison per request, one deque append per
    interval)."""
    if now - self._last_sample_s < self._autoscale_sample_s:
      return
    self._last_sample_s = now
    self._load_samples.append(
        (now, self._load_requests, self._load_sheds,
         sum(r.outstanding for r in self._replicas)))

  def recommended_replicas(self,
                           window_s: Optional[float] = None) -> int:
    """ADVISORY replica-count recommendation from the shed/occupancy/
    outstanding counters over a sliding window, with no actuation: the
    signal an autoscaler or an operator dashboard consumes, exported as
    the `serve/fleet/recommended_replicas` gauge.

    The signal, over the samples inside `window_s` (default: the
    constructor's `autoscale_window_s`):

    * mean router-wide OUTSTANDING work, sized against the per-replica
      queue-depth bound at `autoscale_target_utilization` (default
      0.5): `ceil(mean_outstanding / (target_util * shed_outstanding))`
      replicas keep steady-state occupancy at the target — a diurnal
      peak reads high, the trough reads low;
    * queue-bound SHEDS in the window are a hard under-capacity signal:
      any shedding recommends at least one replica more than currently
      healthy (backpressure means the bound already fired — occupancy
      alone underestimates demand that was refused);
    * SCALE-IN (recommended < healthy) must additionally be backed by
      the device-time ledger (graftwatch, `obs.usage.UsageLedger`): the
      window's measured device utilization, PROJECTED onto the smaller
      fleet (`util * healthy / recommended`), must stay at or under the
      target — so a trough recommendation prices SUSTAINED idle
      device-seconds, not one quiet outstanding-count sample, and a
      recent busy burst inside the window blocks scale-in until the
      window actually drains.

    Never recommends below 1 or below what an in-window shed proves is
    needed; with no traffic in the window it recommends the current
    healthy count (no signal = no change).
    """
    window = self._autoscale_window_s if window_s is None else window_s
    now = time.monotonic()
    with self._lock:
      self._sample_load_locked(now)
      healthy = sum(1 for r in self._replicas if r.state == SERVING)
      samples = [s for s in self._load_samples if now - s[0] <= window]
    recommended = max(healthy, 1)
    if len(samples) >= 2:
      requests_delta = samples[-1][1] - samples[0][1]
      sheds_delta = samples[-1][2] - samples[0][2]
      if requests_delta > 0:
        mean_outstanding = (sum(s[3] for s in samples)
                            / float(len(samples)))
        per_replica = max(self._shed_outstanding, 1)
        recommended = max(
            int(math.ceil(mean_outstanding
                          / (self._autoscale_target_util * per_replica))),
            1)
        if sheds_delta > 0:
          recommended = max(recommended, healthy + 1)
    if recommended < healthy:
      # Sustained-idle gate (ledger-backed scale-in; advisory only).
      util, _ = self._usage.window_utilization(window, now=now)
      obs_metrics.gauge("serve/fleet/window_utilization").set(
          round(util, 4))
      projected = util * healthy / float(max(recommended, 1))
      if projected > self._autoscale_target_util:
        recommended = healthy
    obs_metrics.gauge("serve/fleet/recommended_replicas").set(
        float(recommended))
    return recommended

  def utilization_summary(self) -> Dict[str, Any]:
    """The fleet's device-time ledger block (`obs.usage.UsageLedger
    .summary`): per-replica busy/idle device-seconds, utilization, and
    cost-per-request — the `utilization` block a run record
    appends to runs.jsonl and `graftscope watch` renders. Also exports
    the `serve/fleet/device_seconds_{busy,idle}` / `.../utilization` /
    `.../cost_per_request_usd` gauges as a side effect."""
    return self._usage.summary()

  # -- health ---------------------------------------------------------------

  def _healthy_gauge_locked(self) -> None:
    healthy = sum(1 for r in self._replicas if r.state == SERVING)
    obs_metrics.gauge("serve/fleet/healthy").set(float(healthy))

  def _emit_incident(self, kind: str, replica: int, reason: str,
                     severity: str = "warn") -> None:
    record = runlog_lib.make_incident(
        kind, step=0, severity=severity, value=float(replica),
        detail={"replica": replica, "reason": reason, "fleet": self._name})
    for sink in self._sinks:
      try:
        sink(record)
      except Exception:  # noqa: BLE001 - a sink must not break routing
        pass

  def mark_unhealthy(self, index: int, reason: str = "operator") -> None:
    """Evicts a replica from the routing set: the router steers around
    it, its batcher finishes in-flight work (drain, not kill), and its
    fleet sessions are displaced to re-open elsewhere on their next
    tick. With probation armed the replica also enters the background
    probe loop (auto-readmit on success)."""
    with self._lock:
      replica = self._replicas[index]
      if replica.state in (UNHEALTHY, CLOSED):
        return
      replica.state = UNHEALTHY
      replica.unhealthy_reason = reason
      self._evicted_at[index] = time.monotonic()
      for entry in self._sessions.values():
        if entry.replica is replica:
          entry.displaced = True
      self._healthy_gauge_locked()
    obs_metrics.counter("serve/fleet/unhealthy").inc()
    self._emit_incident(sentinel_lib.REPLICA_UNHEALTHY, index, reason)
    self._enter_probation(index)

  def mark_healthy(self, index: int) -> None:
    """Re-admits a replica (after `probe_replica`, the probation loop,
    or operator action); records eviction-to-readmission wall time in
    `serve/fleet/readmit_ms` (the fleet's MTTR histogram)."""
    with self._lock:
      replica = self._replicas[index]
      if replica.state == CLOSED:
        raise ValueError(f"replica {index} is closed")
      was_unhealthy = replica.state == UNHEALTHY
      replica.state = SERVING
      replica.failure_streak = 0
      replica.unhealthy_reason = None
      replica.last_ok_s = time.monotonic()
      evicted_at = self._evicted_at.pop(index, None)
      self._probation.pop(index, None)
      self._healthy_gauge_locked()
    if was_unhealthy and evicted_at is not None:
      obs_metrics.histogram("serve/fleet/readmit_ms").record(
          (time.monotonic() - evicted_at) * 1e3)

  def probe_replica(self, index: int,
                    request: Mapping[str, Any]) -> bool:
    """Sends one request DIRECTLY to a replica (bypassing the router);
    marks it healthy on success. The recovery half of eviction."""
    replica = self._replicas[index]
    obs_metrics.counter("serve/fleet/probation_probes").inc()
    try:
      replica.engine.predict(request)
    except Exception:  # noqa: BLE001 - a failed probe just stays evicted
      return False
    self.mark_healthy(index)
    return True

  # -- probation (module docstring) -----------------------------------------

  def _enter_probation(self, index: int) -> None:
    """Seeds the probe schedule for a just-evicted replica and makes
    sure the (lazy, single) probation worker is running."""
    if self._probation_probe is None:
      return
    policy = self._probation_policy
    with self._lock:
      if self._closed:
        return
      self._probation[index] = {
          "attempt": 0.0,
          "next_s": time.monotonic() + policy.backoff_s(0)}
      if self._probation_thread is None:
        self._probation_thread = threading.Thread(
            target=self._probation_main, daemon=True,
            name=f"{self._name.replace('/', '-')}-probation")
        self._probation_thread.start()
    self._probation_wake.set()

  def _probation_main(self) -> None:
    """Background probe loop: every evicted replica on the schedule is
    probed directly under the RetryPolicy's jittered backoff;
    auto-readmit on success (probe_replica -> mark_healthy), give-up
    past the attempt budget. The loop idles on an event when nothing
    is in probation — it costs nothing in the healthy steady state."""
    policy = self._probation_policy
    while True:
      with self._lock:
        if self._closed:
          return
        now = time.monotonic()
        due = [i for i, s in self._probation.items() if now >= s["next_s"]]
        next_s = min((s["next_s"] for s in self._probation.values()),
                     default=None)
      if not due:
        # Sleep exactly until the earliest scheduled probe — forever
        # when nothing is in probation (the healthy steady state costs
        # zero wakeups and zero routing-lock traffic). _enter_probation
        # and close() set the event; clearing AFTER the wait and
        # re-reading the schedule above means no wakeup can be lost.
        timeout = (None if next_s is None
                   else max(next_s - time.monotonic(), 0.0))
        if timeout is None or timeout > 0.0:
          self._probation_wake.wait(timeout=timeout)
        self._probation_wake.clear()
        continue
      for index in due:
        try:
          request = self._probation_probe()
          readmitted = self.probe_replica(index, request)
        except Exception:  # noqa: BLE001 - a probe must never kill the loop
          readmitted = False
        if readmitted:
          obs_metrics.counter("serve/fleet/probation_readmits").inc()
          continue
        with self._lock:
          state = self._probation.get(index)
          if state is None:
            continue
          attempt = int(state["attempt"]) + 1
          if attempt >= policy.max_attempts:
            self._probation.pop(index, None)
            give_up = True
          else:
            state["attempt"] = float(attempt)
            state["next_s"] = time.monotonic() + policy.backoff_s(attempt)
            give_up = False
        if give_up:
          obs_metrics.counter("serve/fleet/probation_giveups").inc()

  def sentinel_sink(self) -> Callable[[Mapping[str, Any]], None]:
    """An incident-sink callable for `obs.sentinel.Sentinel(sinks=...)`:
    a FATAL incident whose detail names one of this fleet's replicas
    (`detail={"replica": i}`) evicts that replica — the sentinel
    divergence/starvation stream becomes replica eviction pressure."""

    def sink(record: Mapping[str, Any]) -> None:
      detail = record.get("detail") or {}
      index = detail.get("replica")
      if index is None or record.get("severity") != "fatal":
        return
      index = int(index)
      if 0 <= index < len(self._replicas):
        self.mark_unhealthy(index,
                            reason=f"sentinel:{record.get('kind')}")

    return sink

  def _record_outcome(self, replica: _Replica, ok: bool,
                      health_relevant: bool = True,
                      stateless: bool = False) -> None:
    with self._lock:
      replica.outstanding -= 1
      if stateless:
        replica.stateless_outstanding -= 1
      obs_metrics.gauge("serve/fleet/outstanding").set(
          float(sum(r.outstanding for r in self._replicas)))
      if not health_relevant:
        return
      if ok:
        replica.failure_streak = 0
        replica.last_ok_s = time.monotonic()
        return
      replica.failure_streak += 1
      evict = (replica.failure_streak >= self._unhealthy_after
               and replica.state == SERVING)
    if evict:
      self.mark_unhealthy(replica.index,
                          reason=f"{replica.failure_streak} consecutive "
                                 "dispatch failures")

  # -- stateless routing ----------------------------------------------------

  def _pick_replica(self, exclude: Optional[int] = None) -> _Replica:
    """Least-outstanding-work healthy replica; raises the shed family
    when none qualifies. Increments the winner's outstanding count
    (callers MUST pair with `_record_outcome`)."""
    now = time.monotonic()
    with self._lock:
      if self._closed:
        raise batcher_lib.ShutdownError("fleet is closed")
      stale: List[int] = []
      if self._heartbeat_timeout_s is not None:
        # Heartbeat check rides the routing hot path (no extra thread):
        # a replica holding work with no completion for the timeout is
        # stuck mid-dispatch — evict it instead of routing more in.
        stale = [r.index for r in self._replicas
                 if r.state == SERVING and r.outstanding > 0
                 and now - r.last_ok_s > self._heartbeat_timeout_s]
    if stale:
      for index in stale:
        self.mark_unhealthy(index, reason="heartbeat timeout")
      return self._pick_replica(exclude=exclude)
    with self._lock:
      if self._closed:
        raise batcher_lib.ShutdownError("fleet is closed")
      self._load_requests += 1
      self._sample_load_locked(time.monotonic())
      candidates = [r for r in self._replicas
                    if r.state == SERVING and r.index != exclude]
      if not candidates:
        if not any(r.state == SERVING for r in self._replicas):
          obs_metrics.counter("serve/fleet/no_healthy").inc()
          raise NoHealthyReplicaError(
              "no healthy replica in the fleet "
              f"({[r.state for r in self._replicas]})")
        obs_metrics.counter("serve/fleet/shed").inc()
        self._load_sheds += 1
        raise FleetShedError("no alternative replica for failover")
      best = min(candidates, key=lambda r: (r.outstanding, r.index))
      if best.outstanding >= self._shed_outstanding:
        obs_metrics.counter("serve/fleet/shed").inc()
        self._load_sheds += 1
        raise FleetShedError(
            f"every healthy replica is at the queue-depth bound "
            f"({self._shed_outstanding} outstanding); backpressure — "
            "retry later or add replicas")
      best.outstanding += 1
      best.stateless_outstanding += 1
      obs_metrics.gauge("serve/fleet/outstanding").set(
          float(sum(r.outstanding for r in self._replicas)))
    return best

  def predict(self, features: Mapping[str, Any],
              deadline_ms: Optional[float] = None
              ) -> Dict[str, np.ndarray]:
    """Routed predict: least-outstanding replica, one failover retry.

    Raises `FleetShedError`/`NoHealthyReplicaError` on admission
    refusal, `DeadlineError` when the per-request deadline expired
    (final — never retried), and the backend error when both the
    chosen replica and its failover alternative failed.
    """
    obs_metrics.counter("serve/fleet/requests").inc()
    # Router admission is where a request's trace context is born: the
    # batcher below it mints a CHILD at its own admission, so the
    # fleet-level span parents the queue/dispatch decomposition.
    ctx = graftrace.request_context()
    if self._latency_slo_ms is None:
      return self._predict_routed(features, deadline_ms, ctx)
    # Latency objective: the ROUTED wall time (queue + failover + retry
    # included — what the caller experienced) scores against the SLO,
    # breaches and all error outcomes alike; the SLO engine's burn-rate
    # windows read the counters this feeds.
    start = time.monotonic()
    try:
      return self._predict_routed(features, deadline_ms, ctx)
    finally:
      sentinel_lib.observe_serving_latency(
          (time.monotonic() - start) * 1e3, self._latency_slo_ms)

  def _predict_routed(self, features, deadline_ms, ctx
                      ) -> Dict[str, np.ndarray]:
    first_error: Optional[BaseException] = None
    exclude = None
    for attempt in range(2):
      try:
        replica = self._pick_replica(exclude=exclude)
      except FleetShedError:
        if first_error is not None:
          raise first_error  # shed on failover: surface the real error
        raise
      ok = False
      health_relevant = True
      try:
        # faultlab seams (chaos runs): a latency spike holds the
        # dispatch open (spec.arg ms), a dispatch fault fails it — both
        # INSIDE the health accounting, so injected faults exercise
        # exactly the eviction/failover machinery real ones do.
        spike = faultlab_lib.maybe_fire(faultlab_lib.SERVE_LATENCY,
                                        key=replica.index)
        if spike is not None:
          time.sleep(float(spike.arg or 25.0) / 1e3)
        if faultlab_lib.maybe_fire(faultlab_lib.SERVE_DISPATCH,
                                   key=replica.index) is not None:
          raise faultlab_lib.InjectedDispatchError(
              f"faultlab: injected dispatch failure on replica "
              f"{replica.index}")
        with graftrace.activate(ctx), \
            obs_trace.span("serve/fleet/request", cat="serve",
                           replica=replica.index, attempt=attempt):
          if deadline_ms is not None:
            result = replica.front.predict(features,
                                           deadline_ms=deadline_ms)
          else:
            result = replica.front.predict(features)
        ok = True
        return result
      except batcher_lib.DeadlineError:
        # Stale is stale on every replica; shedding it is the batcher
        # doing its job, not a replica fault.
        health_relevant = False
        raise
      except batcher_lib.ShedError as e:
        # Per-replica backpressure: not a health failure; try the other
        # replica once, then surface the shed.
        health_relevant = False
        first_error = first_error or e
        exclude = replica.index
      except BaseException as e:  # noqa: BLE001 - dispatch failure
        first_error = first_error or e
        exclude = replica.index
      finally:
        self._record_outcome(replica, ok, health_relevant,
                             stateless=True)
      if attempt == 0:
        obs_metrics.counter("serve/fleet/retries").inc()
    raise first_error

  # -- session routing ------------------------------------------------------

  def _ring_order(self, key: str) -> List[_Replica]:
    """Replicas in consistent-hash walk order for `key` (each once)."""
    point = _hash32(key)
    start = 0
    for i, (h, _) in enumerate(self._ring):
      if h >= point:
        start = i
        break
    seen: List[int] = []
    for i in range(len(self._ring)):
      _, index = self._ring[(start + i) % len(self._ring)]
      if index not in seen:
        seen.append(index)
        if len(seen) == len(self._replicas):
          break
    return [self._replicas[i] for i in seen]

  def _open_on_ring(self, key: str,
                    exclude: Optional[_Replica] = None) -> tuple:
    """(replica, inner_sid) for a new/reopened session: first healthy
    replica on the key's ring walk that admits the open."""
    last_error: Optional[BaseException] = None
    for replica in self._ring_order(key):
      if replica is exclude:
        continue
      with self._lock:
        if replica.state != SERVING:
          continue
      try:
        return replica, replica.session_front.open()
      except Exception as e:  # noqa: BLE001 - full/shedding replica
        last_error = e
        continue
    if last_error is not None:
      raise last_error
    raise NoHealthyReplicaError(
        "no healthy session-capable replica in the fleet")

  def open(self, session_key: Optional[str] = None) -> int:
    """Opens a fleet session; returns the fleet-level session id.

    `session_key` (default: the id itself) is the affinity key —
    consistent hashing maps it to a replica, so e.g. a robot id as the
    key keeps one robot's episodes co-located across reconnects.
    """
    with self._lock:
      if self._closed:
        raise batcher_lib.ShutdownError("fleet is closed")
      sid = self._next_session_id
      self._next_session_id += 1
    key = session_key if session_key is not None else f"sid:{sid}"
    replica, inner = self._open_on_ring(key)
    with self._lock:
      self._sessions[sid] = _FleetSession(key, replica, inner)
    obs_metrics.counter("serve/fleet/session_opens").inc()
    return sid

  def step(self, session_id: int, features: Mapping[str, Any]
           ) -> Dict[str, np.ndarray]:
    """Advances a fleet session one tick on its affine replica.

    A session displaced by replica eviction transparently RE-OPENS on a
    healthy replica (fresh decode state — an episode restart, counted)
    under the default `session_reopen='reopen'`; `'evict'` raises
    `SessionEvictedError` so the policy's established recovery path
    drives the re-open instead.
    """
    with self._lock:
      entry = self._sessions.get(session_id)
      if entry is None:
        raise session_lib.UnknownSessionError(
            f"unknown fleet session {session_id}", session_id)
      if entry.replica.state in (UNHEALTHY, CLOSED):
        entry.displaced = True
      displaced = entry.displaced
    if displaced:
      if self._session_reopen == "evict":
        with self._lock:
          self._sessions.pop(session_id, None)
        raise session_lib.SessionEvictedError(
            f"fleet session {session_id}'s replica "
            f"{entry.replica.index} was evicted; re-open the episode",
            session_id)
      replica, inner = self._open_on_ring(entry.key,
                                          exclude=entry.replica)
      with self._lock:
        entry.replica = replica
        entry.inner_sid = inner
        entry.displaced = False
      obs_metrics.counter("serve/fleet/session_reopens").inc()
    replica = entry.replica
    with self._lock:
      replica.outstanding += 1
      # Session ticks feed the advisory-autoscale window too: a fleet
      # serving ONLY session-affine traffic must still open the
      # requests_delta gate in recommended_replicas() (outstanding
      # alone is sampled, but the gate keys on request flow).
      self._load_requests += 1
      self._sample_load_locked(time.monotonic())
    ok = False
    ctx = graftrace.request_context()
    # Direct engine routing has no SessionBatcher recording dispatch
    # windows into the ledger — the fleet times the tick itself (a tick
    # IS the dispatch in that topology).
    direct = replica.session_front is replica.engine
    tick_ns = time.perf_counter_ns() if direct else 0
    try:
      with graftrace.activate(ctx):
        result = replica.session_front.step(entry.inner_sid, features)
      ok = True
      if direct:
        self._usage.record_busy(
            f"replica{replica.index}",
            (time.perf_counter_ns() - tick_ns) / 1e9, 1)
      return result
    except session_lib.SessionError as e:
      # A session-lifecycle outcome (evicted under slot pressure,
      # horizon, closed): the fleet mapping is gone but the REPLICA is
      # fine — don't let per-session outcomes accrue into eviction.
      ok = True
      with self._lock:
        entry_now = self._sessions.pop(session_id, None)
        if isinstance(e, session_lib.SessionShedError):
          # Capacity refusal: the hard under-capacity signal of the
          # autoscale window, same as a stateless queue-bound shed.
          self._load_sheds += 1
      if (isinstance(e, session_lib.SessionHorizonError)
          and entry_now is not None):
        # A horizon outcome leaves the INNER session alive and holding
        # its arena slot (the engine contract expects the caller to
        # close it) — but the fleet mapping is gone after the pop
        # above, so the policy's close_session(sid) can never reach
        # it: close the inner slot here or it leaks one replica slot
        # per horizon-hitting episode.
        try:
          replica.session_front.close_session(entry_now.inner_sid)
        except session_lib.SessionError:
          pass  # already evicted/closed inside the replica
      raise
    finally:
      self._record_outcome(replica, ok)

  def close_session(self, session_id: int) -> None:
    with self._lock:
      entry = self._sessions.pop(session_id, None)
    if entry is None:
      raise session_lib.UnknownSessionError(
          f"unknown fleet session {session_id}", session_id)
    if entry.displaced or entry.replica.state in (UNHEALTHY, CLOSED):
      return  # the inner slot died with (or will die with) its replica
    try:
      entry.replica.session_front.close_session(entry.inner_sid)
    except session_lib.SessionError:
      pass  # already evicted/closed inside the replica

  # -- warmup / rollout -----------------------------------------------------

  def warmup(self) -> "ServingFleet":
    """Warms every replica's rungs. Warm time occupies the device group:
    the ledger books it busy with zero requests, and
    `serve/fleet/warmup_ms` holds the fleet's total."""
    total_ms = 0.0
    for replica in self._replicas:
      warm = getattr(replica.engine, "warmup", None)
      if warm is None:
        continue
      warm()
      # `BucketedEngine.warmup_ms`: rung -> ms; a SessionEngine has none.
      warm_ms = float(sum(
          (getattr(replica.engine, "warmup_ms", None) or {}).values()))
      if warm_ms > 0.0:
        self._usage.record_busy(f"replica{replica.index}",
                                warm_ms / 1e3, 0)
      total_ms += warm_ms
    obs_metrics.gauge("serve/fleet/warmup_ms").set(total_ms)
    return self

  def _wait_drained(self, replica: _Replica, timeout_s: float) -> bool:
    """Waits out the replica's STATELESS outstanding work (the router
    stopped sending, so the batcher pipeline empties). Session ticks
    are deliberately excluded: they keep flowing through the swap —
    `restore()` hot-swaps params under live sessions (the
    SessionEngine contract: the bundle re-bind serializes against
    dispatches on the engine's own arena lock), and counting them here
    would hold the drain open for the full timeout under any
    continuous session traffic."""
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
      with self._lock:
        if replica.stateless_outstanding == 0:
          return True
      time.sleep(0.005)
    return False

  def _version_skew_locked(self) -> float:
    versions = [getattr(r.engine, "model_version", None)
                for r in self._replicas]
    versions = [v for v in versions if isinstance(v, (int, float))
                and v >= 0]
    return float(max(versions) - min(versions)) if versions else 0.0

  def rollout(self,
              probe_request: Optional[Mapping[str, Any]] = None,
              verify: Optional[Callable[[Mapping[str, Any]], bool]] = None,
              rtol: float = 1e-4,
              atol: float = 1e-6,
              drain_timeout_s: float = 30.0,
              ladder: Optional[Sequence[int]] = None) -> Dict[str, Any]:
    """Zero-downtime checkpoint rollout: canary first, then one replica
    at a time, with the router steering around whichever replica is
    mid-swap (module docstring). Returns the rollout report; never
    raises for verification failures — an aborted rollout leaves the
    unswapped replicas serving the old checkpoint and says so.

    `ladder`: move every replica onto a new bucket ladder (e.g. a
    traffic-derived one, `derived_ladder`) as part of the same
    canary-first swap. New rungs are warmed inside the replica's drained
    window, before its restore() and re-admission (`engine.reladder`),
    so a ladder change never puts a cold rung in front of live traffic;
    the report's `reladder` entry lists the rungs it warmed.
    """
    obs_metrics.counter("serve/fleet/rollouts").inc()
    report: Dict[str, Any] = {"swapped": 0, "fresh_warms": 0,
                              "fresh_compiles": 0,
                              "parity_ok": True, "aborted": None,
                              "replicas": []}
    canary_outputs: Optional[Dict[str, np.ndarray]] = None
    with self._lock:
      order = [r for r in self._replicas if r.state == SERVING]
    if not order:
      report["aborted"] = "no healthy replica"
      return report
    report["canary_index"] = order[0].index
    for position, replica in enumerate(order):
      entry: Dict[str, Any] = {"replica": replica.index}
      report["replicas"].append(entry)
      failed_verification = False
      with self._lock:
        if replica.state != SERVING:  # evicted while we were rolling
          entry["skipped"] = "not serving"
          continue
        replica.state = SWAPPING
        self._healthy_gauge_locked()
      try:
        entry["drained"] = self._wait_drained(replica, drain_timeout_s)
        warms_before = getattr(replica.engine, "warm_count", None)
        compiles_before = getattr(replica.engine, "compile_count", None)
        if ladder is not None:
          # Warm the new rungs while the router steers around this
          # replica; the ladder swap itself is atomic under the engine's
          # lock against the (drained) dispatch side.
          reladder = getattr(replica.engine, "reladder", None)
          if reladder is not None:
            rungs_before = set(getattr(replica.engine, "warmup_ms", {}))
            reladder(ladder)
            entry["reladder"] = sorted(
                set(getattr(replica.engine, "warmup_ms", {})) - rungs_before)
        ok = replica.engine.restore()
        entry["restored"] = bool(ok)
        if not ok:
          report["aborted"] = (f"replica {replica.index}: restore() "
                               "found no new checkpoint")
          break
        if probe_request is not None:
          start = time.perf_counter()
          outputs = {k: np.asarray(v) for k, v in
                     dict(replica.engine.predict(probe_request)).items()}
          entry["probe_ms"] = (time.perf_counter() - start) * 1e3
          if canary_outputs is None:
            canary_outputs = outputs
            if verify is not None and not verify(outputs):
              entry["verify_failed"] = True
              failed_verification = True
              report["aborted"] = (f"canary replica {replica.index} "
                                   "failed verification")
              break
          else:
            # Same checkpoint => same outputs: the canary IS the parity
            # reference for every later replica.
            parity = set(outputs) == set(canary_outputs) and all(
                np.allclose(outputs[k], canary_outputs[k],
                            rtol=rtol, atol=atol) for k in outputs)
            entry["parity_ok"] = parity
            if not parity:
              report["parity_ok"] = False
              failed_verification = True
              report["aborted"] = (f"replica {replica.index} disagrees "
                                   "with the canary on the probe request")
              break
        warms_after = getattr(replica.engine, "warm_count", None)
        if warms_before is not None and warms_after is not None:
          entry["fresh_warms"] = warms_after - warms_before
          report["fresh_warms"] += entry["fresh_warms"]
        compiles_after = getattr(replica.engine, "compile_count", None)
        if compiles_before is not None and compiles_after is not None:
          entry["fresh_compiles"] = compiles_after - compiles_before
          report["fresh_compiles"] += entry["fresh_compiles"]
        entry["model_version"] = getattr(replica.engine, "model_version",
                                         None)
        report["swapped"] += 1
        obs_metrics.counter("serve/fleet/rollout_swapped").inc()
      finally:
        if failed_verification:
          # A replica whose NEW checkpoint failed verification/parity
          # must NOT rejoin the routing set — its params are already
          # swapped, so re-admitting it would serve the exact
          # checkpoint the canary gate rejected. Full eviction
          # (sessions displaced, incident emitted); operators
          # re-restore + probe_replica to re-admit.
          self.mark_unhealthy(replica.index,
                              reason="rollout verification failed")
        with self._lock:
          if replica.state == SWAPPING:
            replica.state = SERVING
          self._healthy_gauge_locked()
          obs_metrics.gauge("serve/fleet/version_skew").set(
              self._version_skew_locked())
    return report

  # -- lifecycle ------------------------------------------------------------

  def restore(self) -> bool:
    """Bulk restore (NOT zero-downtime — use `rollout()` under load)."""
    ok = True
    for replica in self._replicas:
      ok = bool(replica.engine.restore()) and ok
    with self._lock:
      obs_metrics.gauge("serve/fleet/version_skew").set(
          self._version_skew_locked())
    return ok

  @property
  def global_step(self) -> int:
    steps = [getattr(r.engine, "global_step", -1) for r in self._replicas]
    return min(steps) if steps else -1

  @property
  def model_version(self) -> int:
    return self.global_step

  def drain(self, timeout_s: float = 30.0) -> bool:
    """Waits for every router-tracked request to finish (True on
    success) — the quiesce half of `close()` exposed for owners that
    hand replicas elsewhere afterwards."""
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
      if self.outstanding() == 0:
        return True
      time.sleep(0.005)
    return False

  def close(self) -> None:
    """Stops routing, then closes every replica front (each
    `MicroBatcher`/`SessionBatcher` close JOINS its worker — the
    clean-shutdown discipline) and every engine. Idempotent."""
    with self._lock:
      if self._closed:
        return
      self._closed = True
      for replica in self._replicas:
        replica.state = CLOSED
      self._sessions.clear()
      self._probation.clear()
      probation_thread = self._probation_thread
      self._probation_thread = None
      self._healthy_gauge_locked()
    if probation_thread is not None:
      self._probation_wake.set()  # unblock the idle wait promptly
      probation_thread.join(timeout=5.0)
    for replica in self._replicas:
      if replica.front is not None:
        replica.front.close()
      if (replica.session_front is not None
          and replica.session_front is not replica.engine
          and hasattr(replica.session_front, "close")):
        replica.session_front.close()
      close = getattr(replica.engine, "close", None)
      if close is not None:
        try:
          close()
        except Exception:  # noqa: BLE001 - teardown must not mask errors
          pass
      # Freeze the ledger's wall window: idle stops accruing for a
      # replica the moment it stops existing.
      self._usage.close_group(f"replica{replica.index}")
    graftrace.flush()

  def __enter__(self) -> "ServingFleet":
    return self

  def __exit__(self, exc_type, exc_value, traceback) -> bool:
    self.close()
    return False
