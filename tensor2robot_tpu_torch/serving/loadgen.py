"""The serving load generator: closed-loop sweeps and arrival processes.

Counterpart of `tensor2robot_tpu.serving.loadgen` (`run_load`,
`arrival_gaps`, `latency_percentiles`; the open-loop session and
trace-driven loads come with the fleet, ROADMAP Queue A item 14):

* `run_load` — CLOSED loop: N client threads issue requests back to back
  against a predict callable (each thread's next request waits for its
  previous answer, the robot-fleet traffic shape); QPS plus the outcome
  counts, sheds included. Latency percentiles come from the
  `serve/request_ms` histogram the batcher records
  (`latency_percentiles`).
* `arrival_gaps` — inter-arrival gaps of an open-loop arrival process:
  Poisson, bursty (Markov-modulated Poisson) or diurnal, deterministic
  per seed.

Never imports torch: whether the predict callable touches a device is
the caller's business.
"""

from __future__ import annotations

import math
import threading
import time
from typing import Any, Callable, Dict, Mapping, Optional

import numpy as np

from tensor2robot_tpu_torch.obs import metrics as obs_metrics

__all__ = ["run_load", "arrival_gaps", "ARRIVAL_PROFILES",
           "latency_percentiles"]

ARRIVAL_PROFILES = ("poisson", "mmpp", "diurnal")


def arrival_gaps(num_arrivals: int,
                 rate_hz: float,
                 profile: str = "poisson",
                 seed: int = 0,
                 burst_factor: float = 3.0,
                 burst_fraction: float = 0.2,
                 switch_rate_hz: Optional[float] = None,
                 diurnal_amplitude: float = 0.8,
                 diurnal_period_s: Optional[float] = None) -> np.ndarray:
  """Inter-arrival gaps (seconds) for `num_arrivals` open-loop arrivals.

  Profiles (all deterministic per `seed`, all with LONG-RUN mean rate
  `rate_hz` so profiles are comparable at one target):

  * "poisson"  — exponential gaps (`RandomState(seed)
    .exponential(1/rate, size=n)`), the JAX package's stream.
  * "mmpp"     — two-state Markov-modulated Poisson: a burst state at
    `burst_factor * rate_hz` (default 3x) occupied `burst_fraction`
    (default 0.2) of the time and
    a base state carrying the remaining traffic, with exponential
    sojourns at `switch_rate_hz` (default `rate_hz / 20` — bursts span
    many arrivals). The base intensity is solved so the time-weighted
    mean stays `rate_hz`; if `burst_factor * burst_fraction >= 1` the
    base state would need a negative rate, which raises.
  * "diurnal"  — inhomogeneous Poisson with intensity
    `rate_hz * (1 + amplitude * sin(2*pi*t/period))` via Lewis
    thinning (period defaults to the whole trace span
    `num_arrivals / rate_hz`, i.e. one peak and one trough per run).
  """
  if num_arrivals < 1:
    raise ValueError("num_arrivals must be >= 1")
  if rate_hz <= 0:
    raise ValueError("rate_hz must be > 0")
  if profile not in ARRIVAL_PROFILES:
    raise ValueError(f"profile must be one of {ARRIVAL_PROFILES}, "
                     f"got {profile!r}")
  rng = np.random.RandomState(seed)
  if profile == "poisson":
    return rng.exponential(1.0 / rate_hz, size=num_arrivals)
  if profile == "mmpp":
    if not 0.0 < burst_fraction < 1.0:
      raise ValueError("burst_fraction must be in (0, 1)")
    if burst_factor * burst_fraction >= 1.0:
      raise ValueError(
          f"burst_factor*burst_fraction = {burst_factor * burst_fraction} "
          ">= 1: the base state cannot carry the residual rate")
    burst_rate = burst_factor * rate_hz
    base_rate = rate_hz * (1.0 - burst_factor * burst_fraction) \
        / (1.0 - burst_fraction)
    switch = switch_rate_hz if switch_rate_hz is not None else rate_hz / 20.0
    # Sojourns chosen so the stationary occupancy of the burst state is
    # burst_fraction: leave-rates inversely proportional to occupancy.
    leave_base = switch / (1.0 - burst_fraction)
    leave_burst = switch / burst_fraction
    gaps = np.empty(num_arrivals)
    in_burst = False
    state_left = float(rng.exponential(1.0 / leave_base))
    for i in range(num_arrivals):
      gap = 0.0
      while True:
        rate = burst_rate if in_burst else base_rate
        draw = float(rng.exponential(1.0 / rate))
        if draw <= state_left:
          state_left -= draw
          gap += draw
          break
        # The state flips before the next arrival lands: consume the
        # sojourn remainder and redraw in the new state (memoryless).
        gap += state_left
        in_burst = not in_burst
        state_left = float(rng.exponential(
            1.0 / (leave_burst if in_burst else leave_base)))
      gaps[i] = gap
    return gaps
  # diurnal: Lewis thinning against the peak intensity.
  if not 0.0 <= diurnal_amplitude < 1.0:
    raise ValueError("diurnal_amplitude must be in [0, 1)")
  period = (diurnal_period_s if diurnal_period_s is not None
            else num_arrivals / rate_hz)
  peak = rate_hz * (1.0 + diurnal_amplitude)
  gaps = np.empty(num_arrivals)
  t = 0.0
  last = 0.0
  for i in range(num_arrivals):
    while True:
      t += float(rng.exponential(1.0 / peak))
      intensity = rate_hz * (1.0 + diurnal_amplitude
                             * math.sin(2.0 * math.pi * t / period))
      if rng.random_sample() * peak <= intensity:
        break
    gaps[i] = t - last
    last = t
  return gaps


def run_load(predict: Callable[[Mapping[str, Any]], Any],
             make_request: Callable[[int], Mapping[str, Any]],
             concurrency: int,
             requests_per_thread: int,
             deadline_ms: Optional[float] = None) -> Dict[str, Any]:
  """Closed-loop load: `concurrency` threads x `requests_per_thread`.

  `make_request(i)` builds the i-th request's feature dict (i is unique
  across threads, so request content can vary). `deadline_ms` is passed
  through when `predict` accepts it (a `MicroBatcher`); errors —
  including deliberate sheds — are counted per type, never raised: a
  load test measures the system's behavior under pressure, shedding
  included.

  Returns {qps, wall_sec, ok, errors: {type: count}, concurrency}.
  """
  if concurrency < 1 or requests_per_thread < 1:
    raise ValueError("concurrency and requests_per_thread must be >= 1")
  errors: Dict[str, int] = {}
  ok = [0] * concurrency
  lock = threading.Lock()
  start_barrier = threading.Barrier(concurrency + 1)

  def client(tid: int) -> None:
    start_barrier.wait()
    for i in range(requests_per_thread):
      request = make_request(tid * requests_per_thread + i)
      try:
        if deadline_ms is not None:
          predict(request, deadline_ms=deadline_ms)
        else:
          predict(request)
        ok[tid] += 1
      except Exception as e:  # noqa: BLE001 - shed/deadline are outcomes
        with lock:
          key = type(e).__name__
          errors[key] = errors.get(key, 0) + 1

  threads = [threading.Thread(target=client, args=(tid,), daemon=True,
                              name=f"loadgen-{tid}")
             for tid in range(concurrency)]
  for thread in threads:
    thread.start()
  start_barrier.wait()
  t0 = time.perf_counter()
  for thread in threads:
    thread.join()
  wall = time.perf_counter() - t0
  total_ok = sum(ok)
  return {
      "concurrency": concurrency,
      "requests": concurrency * requests_per_thread,
      "ok": total_ok,
      "errors": errors,
      "wall_sec": wall,
      "qps": total_ok / wall if wall > 0 else 0.0,
  }


def latency_percentiles(histogram_name: str = "serve/request_ms"
                        ) -> Dict[str, float]:
  """p50/p95/p99 (+ mean/count) of a serve latency histogram, read from
  the process-wide registry the serving stack records into."""
  hist = obs_metrics.histogram(histogram_name)
  if not hist.count:
    return {}
  return {
      "p50": hist.percentile(50.0),
      "p95": hist.percentile(95.0),
      "p99": hist.percentile(99.0),
      "mean": hist.mean,
      "count": float(hist.count),
  }
