"""Online anomaly detection over the graftscope step-stats stream.

The port's own copy of the JAX package's `obs.sentinel`, with the same
detectors, thresholds and incident schema. A run that went NaN or
starved its input pipeline is otherwise found by a person reading the
scalars after the fact; this detector runs in the train loop.

The Sentinel consumes telemetry that is ALREADY host-side — stepstats
window records, per-step scalars the loop has already fetched, the
parameter leaf `utils.backend.state_barrier` already copies back — so
detection costs no extra device synchronization. Detectors:

* **step-time spike** — EWMA center + MAD spread over a rolling window
  of `step_ms`; a window beyond `center + max(k·1.4826·MAD,
  min_rel·center)` is an incident — ONE per episode (latched), and a
  persistent shift is re-admitted into the baseline after
  `spike_adapt_after` windows so a degraded-for-good regime does not
  flood incidents forever. Records flagged `barrier_dominated` (the
  timing is a clamped upper bound) are excluded from BOTH detection and
  the running statistics.
* **data starvation** — `data_wait_ms/step_ms` above a fraction for N
  consecutive windows (latched: one incident per starvation episode).
* **non-finite divergence** — `nonfinite_params` piggybacked on the
  stepstats barrier fetch (fatal), plus any non-finite host-side metric
  scalar (fatal, latched per metric so an unrecovered NaN emits once).
* **HBM-watermark drift** — allocator `device_bytes_in_use` (fallback
  `live_bytes`, both from `backend.device_memory_stats()` via the
  stepstats record) growing past the last watermark by a relative AND
  absolute margin; the baseline ratchets only ON incident, so a
  gradual leak accumulates against it and still fires.

Incidents are schema-versioned `graftscope-incident-v1` records
(`obs.runlog.make_incident`) fanned out to sinks — the run's
`incidents.jsonl` appender and the flight recorder's ring buffer — and
counted in the metrics registry (`sentinel/incidents`,
`sentinel/<kind>`). Framework-free: importing and running this module
never touches torch.
"""

from __future__ import annotations

import collections
import dataclasses
import math
import sys
import time
from typing import Any, Callable, Deque, Dict, List, Mapping, Optional

import numpy as np

from tensor2robot_tpu_torch.obs import metrics as metrics_lib
from tensor2robot_tpu_torch.obs import runlog as runlog_lib

__all__ = ["SentinelConfig", "Sentinel", "observe_serving_latency"]

# MAD -> sigma for normally distributed data; the standard robust-scale
# constant (the spike threshold is expressed in sigma-equivalents).
_MAD_SIGMA = 1.4826

# Incident kinds (the postmortem CLI renders these names verbatim).
STEP_TIME_SPIKE = "step_time_spike"
DATA_STARVATION = "data_starvation"
NONFINITE_PARAMS = "nonfinite_params"
NONFINITE_METRIC = "nonfinite_metric"
HBM_DRIFT = "hbm_drift"
SLO_BREACH = "serving_slo_breach"
# Kinds emitted by the JAX package's serving fleet and actor/learner
# loop, which the port has not yet (ROADMAP.md): kept so that records of
# both packages share one vocabulary. `SLO_BURN` is the SLO engine's
# (`obs/slo.py`).
REPLICA_UNHEALTHY = "replica_unhealthy"
LOOP_WORKER_RESTART = "loop_worker_restart"
LOOP_WORKER_LOST = "loop_worker_lost"
LOOP_PUBLISH_REJECTED = "loop_publish_rejected"
SLO_BURN = "serving_slo_burn"


@dataclasses.dataclass(frozen=True)
class SentinelConfig:
  """Detector thresholds: the JAX package's defaults, unchanged (sized
  so the spike floor sits well above a host-load swing of ±20 %)."""

  # step-time spike: fire when step_ms > ewma + max(spike_sigma *
  # 1.4826 * MAD, spike_min_rel * ewma), after spike_min_points clean
  # windows of warmup, over a spike_window rolling history.
  spike_sigma: float = 6.0
  spike_min_rel: float = 0.5
  spike_min_points: int = 8
  spike_window: int = 64
  ewma_alpha: float = 0.2
  # One incident per spike EPISODE (latched like starvation); after
  # this many consecutive spiking windows the values are re-admitted
  # into the statistics — a persistent regime shift (the device or
  # host degrading for good) becomes the new baseline instead of an
  # incident-per-window flood that evicts the pre-shift timeline from
  # every ring buffer.
  spike_adapt_after: int = 3
  # data starvation: data_wait_ms/step_ms > starvation_frac for
  # starvation_consecutive windows in a row.
  starvation_frac: float = 0.6
  starvation_consecutive: int = 3
  # HBM drift: watermark grows by BOTH >drift_rel and >drift_min_bytes.
  drift_rel: float = 0.2
  drift_min_bytes: float = 64 * 2**20
  # Bounded incident memory (sinks see every incident regardless).
  max_incidents: int = 256


class Sentinel:
  """In-process anomaly detector; one per telemetry-enabled train run.

  Wiring (`train_eval.train_eval_model`): `observe_step_record` is
  registered as a `StepStatsRecorder` observer (fires at the stepstats
  barrier cadence), `observe_metrics` is fed host-side scalars by
  `hooks.SentinelHook` and the loop's log-cadence fetch. All inputs
  must already live on the host — `observe_metrics` silently skips
  anything that is not a plain number / numpy value rather than force
  a device fetch (the zero-extra-round-trips contract).
  """

  def __init__(self,
               config: Optional[SentinelConfig] = None,
               sinks: Optional[List[Callable[[Dict[str, Any]], Any]]] = None,
               registry: Optional[metrics_lib.Registry] = None,
               clock: Callable[[], float] = time.time):
    self._config = config or SentinelConfig()
    self._sinks = list(sinks or [])
    self._registry = registry or metrics_lib.get_registry()
    self._clock = clock
    cfg = self._config
    self._incidents: Deque[Dict[str, Any]] = collections.deque(
        maxlen=cfg.max_incidents)
    self._by_kind: Dict[str, int] = {}
    self._step_history: Deque[float] = collections.deque(
        maxlen=cfg.spike_window)
    self._ewma: Optional[float] = None
    self._spike_streak = 0
    self._starvation_streak = 0
    self._hbm_watermark: Optional[float] = None
    self._nonfinite_latched: set = set()
    self._params_latched = False

  def add_sink(self, sink: Callable[[Dict[str, Any]], Any]) -> None:
    self._sinks.append(sink)

  # -- observation entry points ---------------------------------------------

  def observe_step_record(self, step: int, record: Mapping[str, Any]
                          ) -> None:
    """Consumes one stepstats window record (the recorder-observer
    signature). Never raises — telemetry must not kill a train loop."""
    try:
      self._check_nonfinite_params(step, record)
      self._check_starvation(step, record)
      self._check_hbm(step, record)
      self._check_spike(step, record)
    except Exception as e:  # noqa: BLE001 - detector bugs stay telemetry
      print(f"sentinel: detector error at step {step}: "
            f"{type(e).__name__}: {e}", file=sys.stderr)

  def observe_metrics(self, step: int, metrics: Mapping[str, Any]) -> None:
    """Checks HOST-SIDE scalars for non-finites. Values that are not
    already host numbers/numpy (i.e. live device arrays) are skipped —
    reading them here would add a device synchronization per scalar per
    step."""
    for key, value in metrics.items():
      if isinstance(value, (int, float, np.floating, np.integer,
                            np.bool_)):
        scalar = float(value)
      elif isinstance(value, np.ndarray) and value.size == 1:
        scalar = float(value.reshape(())[()])
      else:
        continue
      if math.isfinite(scalar):
        self._nonfinite_latched.discard(key)
      elif key not in self._nonfinite_latched:
        self._nonfinite_latched.add(key)
        self._emit(NONFINITE_METRIC, step, severity="fatal", value=scalar,
                   detail={"metric": str(key)})

  def reset_nonfinite_latch(self) -> None:
    """Re-arms the non-finite detectors (metrics + params). The latch
    de-dupes one continuous NaN episode; the divergence-rewind path
    must call this after restoring, because a NaN that recurs on the
    first post-rewind observation — no finite value in between — is a
    NEW divergence that has to re-trigger (and eventually exhaust the
    rewind budget), not ride the old episode's latch to a silent
    'successful' run full of NaNs."""
    self._nonfinite_latched.clear()
    self._params_latched = False

  # -- detectors ------------------------------------------------------------

  def _check_spike(self, step: int, record: Mapping[str, Any]) -> None:
    cfg = self._config
    if record.get("barrier_dominated"):
      return  # a clamped upper bound, not a measurement — ignore fully
    step_ms = record.get("step_ms")
    if step_ms is None or not math.isfinite(float(step_ms)):
      return
    step_ms = float(step_ms)
    history = self._step_history
    if self._ewma is not None and len(history) >= cfg.spike_min_points:
      ordered = sorted(history)
      median = ordered[len(ordered) // 2]
      mad = sorted(abs(v - median) for v in history)[len(history) // 2]
      threshold = self._ewma + max(cfg.spike_sigma * _MAD_SIGMA * mad,
                                   cfg.spike_min_rel * self._ewma)
      if step_ms > threshold:
        self._spike_streak += 1
        if self._spike_streak == 1:
          # Latched per episode: ONE incident when the spike starts,
          # not one per window for the rest of the run.
          self._emit(STEP_TIME_SPIKE, step, value=step_ms,
                     threshold=threshold,
                     detail={"ewma_ms": self._ewma, "mad_ms": mad})
        if self._spike_streak <= cfg.spike_adapt_after:
          # A short spike must not drag the running statistics...
          return
        # ...but this is no longer a spike — it is the new regime
        # (a lasting slowdown): fall through and re-admit
        # the value so the baseline adapts and the episode can end.
      else:
        self._spike_streak = 0
    history.append(step_ms)
    self._ewma = (step_ms if self._ewma is None
                  else (1 - cfg.ewma_alpha) * self._ewma
                  + cfg.ewma_alpha * step_ms)

  def _check_starvation(self, step: int, record: Mapping[str, Any]) -> None:
    cfg = self._config
    step_ms = float(record.get("step_ms") or 0.0)
    wait_ms = float(record.get("data_wait_ms") or 0.0)
    if step_ms <= 0.0:
      return
    frac = wait_ms / step_ms
    if frac > cfg.starvation_frac:
      self._starvation_streak += 1
      if self._starvation_streak == cfg.starvation_consecutive:
        # Latched: one incident per starvation episode, at the moment
        # the streak condition is first met.
        self._emit(DATA_STARVATION, step, value=frac,
                   threshold=cfg.starvation_frac,
                   detail={"consecutive_windows": self._starvation_streak,
                           "data_wait_ms": wait_ms, "step_ms": step_ms})
    else:
      self._starvation_streak = 0

  def _check_nonfinite_params(self, step: int,
                              record: Mapping[str, Any]) -> None:
    flag = record.get("nonfinite_params")
    if flag:
      if not self._params_latched:
        self._params_latched = True
        self._emit(NONFINITE_PARAMS, step, severity="fatal", value=1.0,
                   detail={"source": "state_barrier leaf fetch"})
    elif flag is not None:
      self._params_latched = False

  def _check_hbm(self, step: int, record: Mapping[str, Any]) -> None:
    cfg = self._config
    value = record.get("device_bytes_in_use", record.get("live_bytes"))
    if value is None:
      return
    value = float(value)
    if not math.isfinite(value) or value <= 0.0:
      return
    if self._hbm_watermark is None:
      self._hbm_watermark = value
      return
    grew_rel = value > self._hbm_watermark * (1.0 + cfg.drift_rel)
    grew_abs = value - self._hbm_watermark > cfg.drift_min_bytes
    if grew_rel and grew_abs:
      self._emit(HBM_DRIFT, step, value=value,
                 threshold=self._hbm_watermark * (1.0 + cfg.drift_rel),
                 detail={"previous_watermark_bytes": self._hbm_watermark})
      # Ratchet ONLY on incident: the baseline stays put under
      # sub-threshold growth, so a gradual leak accumulates against it
      # and fires once the CUMULATIVE drift crosses the thresholds —
      # advancing on every small increase would let a +10%/window leak
      # run forever without an incident (the blind-OOM case).
      self._hbm_watermark = value

  # -- emission -------------------------------------------------------------

  def _emit(self, kind: str, step: int, severity: str = "warn",
            value: Optional[float] = None,
            threshold: Optional[float] = None,
            detail: Optional[Dict[str, Any]] = None) -> None:
    record = runlog_lib.make_incident(
        kind, step=step, severity=severity, value=value,
        threshold=threshold, detail=detail, unix_time=self._clock())
    self._incidents.append(record)
    self._by_kind[kind] = self._by_kind.get(kind, 0) + 1
    self._registry.counter("sentinel/incidents").inc()
    self._registry.counter(f"sentinel/{kind}").inc()
    for sink in self._sinks:
      try:
        sink(record)
      except Exception as e:  # noqa: BLE001 - a sink must not kill the run
        print(f"sentinel: incident sink failed ({type(e).__name__}: {e})",
              file=sys.stderr)

  def incidents(self) -> List[Dict[str, Any]]:
    """The (bounded) incident records emitted so far, oldest first."""
    return list(self._incidents)

  def summary(self) -> Dict[str, Any]:
    """JSON-safe run-record block: totals per kind + overall."""
    return {"incidents": sum(self._by_kind.values()),
            "by_kind": dict(self._by_kind)}


def observe_serving_latency(elapsed_ms: float,
                            slo_ms: Optional[float],
                            registry: Optional[metrics_lib.Registry] = None
                            ) -> bool:
  """Counts a serving-latency SLO breach; returns True when breached.

  The serving twin of the step-time detector: predictors record every
  predict's end-to-end latency (the `np.asarray` fetch inside their
  timed window IS the device barrier) and, when a latency SLO is
  configured, breaches land in `serve/slo_breaches` (+ the breach-ms
  histogram) so a latency regression is a counter, not a percentile
  archaeology session. `slo_ms` None/0 disables.
  """
  if not slo_ms or elapsed_ms <= slo_ms:
    return False
  reg = registry or metrics_lib.get_registry()
  reg.counter("serve/slo_breaches").inc()
  reg.histogram("serve/slo_breach_ms").record(float(elapsed_ms))
  return True
