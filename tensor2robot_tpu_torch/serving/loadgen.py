"""The serving load generator: closed-loop sweeps and arrival processes.

Counterpart of `tensor2robot_tpu.serving.loadgen`:

* `run_load` — CLOSED loop: N client threads issue requests back to back
  against a predict callable (each thread's next request waits for its
  previous answer, the robot-fleet traffic shape); QPS plus the outcome
  counts, sheds included. Latency percentiles come from the
  `serve/request_ms` histogram the batcher records
  (`latency_percentiles`).
* `arrival_gaps` — inter-arrival gaps of an open-loop arrival process:
  Poisson, bursty (Markov-modulated Poisson) or diurnal, deterministic
  per seed.
* `run_session_load` — OPEN loop over sessions: episode starts on a
  Poisson schedule, each `episode_ticks` ticks against a session surface
  (`open` / `step` / `close_session`: a `SessionEngine`, a
  `SessionBatcher` or a `ServingFleet`); every outcome counted.
* `run_trace_load` — OPEN loop over a mix: arrivals on an
  `arrival_gaps` schedule, each a session episode (with probability
  `session_fraction`) or a stateless request, admitted at its scheduled
  time and served by a pool of client threads; `start_lag_ms_p95` says
  how far service lagged the schedule.

Never imports torch: whether the predict callable touches a device is
the caller's business.
"""

from __future__ import annotations

import math
import queue as queue_lib
import threading
import time
from typing import Any, Callable, Dict, List, Mapping, Optional

import numpy as np

from tensor2robot_tpu_torch.obs import metrics as obs_metrics

__all__ = ["run_load", "run_session_load", "run_trace_load",
           "arrival_gaps", "ARRIVAL_PROFILES", "latency_percentiles"]

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


def run_session_load(session_target,
                     make_obs: Callable[[int, int], Mapping[str, Any]],
                     num_sessions: int,
                     session_rate_hz: float,
                     episode_ticks: int,
                     think_time_ms: float = 0.0,
                     seed: int = 0) -> Dict[str, Any]:
  """Open-loop session-shaped load (module docstring).

  `session_target` is anything with the session surface (`open()` /
  `step(sid, obs)` / `close_session(sid)` — a `SessionEngine` or
  `SessionBatcher`). `make_obs(session_index, tick)` builds one tick's
  feature dict. `num_sessions` episode starts are scheduled by a
  Poisson process of rate `session_rate_hz` (exponential inter-arrival
  gaps, deterministic per `seed`) — arrivals do NOT wait for earlier
  episodes, so a saturated engine sees mounting slot pressure; each
  episode runs `episode_ticks` decode ticks with `think_time_ms`
  between them (the robot's control-loop cadence).

  Every outcome is counted, never raised: a shed `open()` abandons that
  episode (`errors['SessionShedError']`), an evicted session stops
  ticking (`errors['SessionEvictedError']`, `evicted_episodes`), any
  other per-tick error abandons the episode under its type name.

  Returns {sessions, completed_episodes, evicted_episodes, ok_ticks,
  errors, wall_sec, ticks_per_sec, achieved_session_rate_hz,
  target_session_rate_hz}.
  """
  if num_sessions < 1 or episode_ticks < 1:
    raise ValueError("num_sessions and episode_ticks must be >= 1")
  if session_rate_hz <= 0:
    raise ValueError("session_rate_hz must be > 0")
  # The shared arrival process; "poisson" is the JAX package's stream.
  gaps = arrival_gaps(num_sessions, session_rate_hz, "poisson", seed)
  errors: Dict[str, int] = {}
  lock = threading.Lock()
  ok_ticks = [0]
  completed = [0]
  evicted = [0]

  def count_error(e: BaseException) -> None:
    with lock:
      key = type(e).__name__
      errors[key] = errors.get(key, 0) + 1

  def episode(session_index: int) -> None:
    try:
      sid = session_target.open()
    except Exception as e:  # noqa: BLE001 - shed at admission is an outcome
      count_error(e)
      return
    try:
      for tick in range(episode_ticks):
        try:
          session_target.step(sid, make_obs(session_index, tick))
        except Exception as e:  # noqa: BLE001 - evict/shutdown are outcomes
          count_error(e)
          if type(e).__name__ == "SessionEvictedError":
            with lock:
              evicted[0] += 1
            return  # the slot is gone; close_session would be a no-op
          return
        with lock:
          ok_ticks[0] += 1
        if think_time_ms > 0 and tick + 1 < episode_ticks:
          time.sleep(think_time_ms / 1e3)
      with lock:
        completed[0] += 1
    finally:
      try:
        session_target.close_session(sid)
      except Exception:  # noqa: BLE001 - already evicted/closed
        pass

  threads: List[threading.Thread] = []
  t0 = time.perf_counter()
  for i in range(num_sessions):
    # Open loop: sleep the Poisson gap, then launch — regardless of how
    # many earlier episodes are still running.
    time.sleep(float(gaps[i]))
    thread = threading.Thread(target=episode, args=(i,), daemon=True,
                              name=f"session-loadgen-{i}")
    thread.start()
    threads.append(thread)
  arrival_wall = time.perf_counter() - t0
  for thread in threads:
    thread.join()
  wall = time.perf_counter() - t0
  return {
      "sessions": num_sessions,
      "completed_episodes": completed[0],
      "evicted_episodes": evicted[0],
      "ok_ticks": ok_ticks[0],
      "errors": errors,
      "wall_sec": wall,
      "ticks_per_sec": ok_ticks[0] / wall if wall > 0 else 0.0,
      "target_session_rate_hz": session_rate_hz,
      "achieved_session_rate_hz": (num_sessions / arrival_wall
                                   if arrival_wall > 0 else 0.0),
  }


def run_trace_load(predict: Optional[Callable] = None,
                   make_request: Optional[Callable[[int],
                                                   Mapping[str, Any]]] = None,
                   session_target=None,
                   make_obs: Optional[Callable[[int, int],
                                               Mapping[str, Any]]] = None,
                   num_arrivals: int = 100,
                   rate_hz: float = 50.0,
                   profile: str = "poisson",
                   seed: int = 0,
                   session_fraction: float = 0.0,
                   episode_ticks: int = 8,
                   think_time_ms: float = 0.0,
                   deadline_ms: Optional[float] = None,
                   max_client_threads: int = 64,
                   profile_kwargs: Optional[Dict[str, Any]] = None
                   ) -> Dict[str, Any]:
  """Trace-driven open-loop load: bursty/diurnal arrivals, mixed
  stateless/session traffic (module docstring).

  Each of `num_arrivals` arrivals (gaps from `arrival_gaps(profile)`)
  is either a SESSION EPISODE (with probability `session_fraction`,
  drawn deterministically from `seed`: open + `episode_ticks` ticks
  with `think_time_ms` between + close against `session_target` /
  `make_obs`, the `run_session_load` episode shape) or a STATELESS
  request (`predict(make_request(i))`, `deadline_ms` passed through
  when set). Errors — sheds, deadlines, evictions — are counted per
  type, never raised.

  Open-loop admission: a dispatcher thread enqueues each arrival AT its
  scheduled time regardless of completions; `max_client_threads`
  workers service the queue. Under saturation the queue (not the
  schedule) absorbs the backlog and `start_lag_ms_p95` reports how far
  service start lagged admission — the honest signal that the system
  under test, not the generator, is the bottleneck.

  Returns {arrivals, stateless_arrivals, session_arrivals, ok_requests,
  ok_ticks, completed_episodes, evicted_episodes, errors, wall_sec,
  qps, target_rate_hz, achieved_rate_hz, profile, start_lag_ms_p95}.
  """
  if num_arrivals < 1:
    raise ValueError("num_arrivals must be >= 1")
  if not 0.0 <= session_fraction <= 1.0:
    raise ValueError("session_fraction must be in [0, 1]")
  if session_fraction > 0.0 and (session_target is None or make_obs is None):
    raise ValueError("session_fraction > 0 requires session_target "
                     "and make_obs")
  if session_fraction < 1.0 and (predict is None or make_request is None):
    raise ValueError("session_fraction < 1 requires predict and "
                     "make_request")
  gaps = arrival_gaps(num_arrivals, rate_hz, profile, seed,
                      **(profile_kwargs or {}))
  # The mix stream is seeded independently of the gap stream so changing
  # the profile never reshuffles which arrivals are sessions.
  is_session = (np.random.RandomState(seed + 1)
                .random_sample(num_arrivals) < session_fraction)
  errors: Dict[str, int] = {}
  lock = threading.Lock()
  ok_requests = [0]
  ok_ticks = [0]
  completed = [0]
  evicted = [0]
  start_lags_ms: List[float] = []

  def count_error(e: BaseException) -> None:
    with lock:
      key = type(e).__name__
      errors[key] = errors.get(key, 0) + 1

  def stateless(index: int) -> None:
    request = make_request(index)
    try:
      if deadline_ms is not None:
        predict(request, deadline_ms=deadline_ms)
      else:
        predict(request)
      with lock:
        ok_requests[0] += 1
    except Exception as e:  # noqa: BLE001 - shed/deadline are outcomes
      count_error(e)

  def episode(index: int) -> None:
    try:
      sid = session_target.open()
    except Exception as e:  # noqa: BLE001 - shed at admission is an outcome
      count_error(e)
      return
    try:
      for tick in range(episode_ticks):
        try:
          session_target.step(sid, make_obs(index, tick))
        except Exception as e:  # noqa: BLE001 - evict/shutdown are outcomes
          count_error(e)
          if type(e).__name__ == "SessionEvictedError":
            with lock:
              evicted[0] += 1
          return
        with lock:
          ok_ticks[0] += 1
        if think_time_ms > 0 and tick + 1 < episode_ticks:
          time.sleep(think_time_ms / 1e3)
      with lock:
        completed[0] += 1
    finally:
      try:
        session_target.close_session(sid)
      except Exception:  # noqa: BLE001 - already evicted/closed
        pass

  work: "queue_lib.Queue" = queue_lib.Queue()
  done = object()

  def client() -> None:
    while True:
      item = work.get()
      if item is done:
        return
      index, due = item
      lag_ms = (time.perf_counter() - due) * 1e3
      with lock:
        start_lags_ms.append(lag_ms)
      if is_session[index]:
        episode(index)
      else:
        stateless(index)

  workers = [threading.Thread(target=client, daemon=True,
                              name=f"trace-loadgen-{i}")
             for i in range(max(1, int(max_client_threads)))]
  for worker in workers:
    worker.start()
  t0 = time.perf_counter()
  due = t0
  for i in range(num_arrivals):
    # Open loop: admit each arrival at its SCHEDULED time (sleep to the
    # absolute due time, so service latency never shifts the schedule).
    due += float(gaps[i])
    delay = due - time.perf_counter()
    if delay > 0:
      time.sleep(delay)
    work.put((i, due))
  arrival_wall = time.perf_counter() - t0
  for _ in workers:
    work.put(done)
  for worker in workers:
    worker.join()
  wall = time.perf_counter() - t0
  served = ok_requests[0] + ok_ticks[0]
  lag_p95 = (float(np.percentile(np.asarray(start_lags_ms), 95.0))
             if start_lags_ms else 0.0)
  return {
      "arrivals": num_arrivals,
      "stateless_arrivals": int(num_arrivals - int(is_session.sum())),
      "session_arrivals": int(is_session.sum()),
      "ok_requests": ok_requests[0],
      "ok_ticks": ok_ticks[0],
      "completed_episodes": completed[0],
      "evicted_episodes": evicted[0],
      "errors": errors,
      "wall_sec": wall,
      "qps": served / wall if wall > 0 else 0.0,
      "target_rate_hz": rate_hz,
      "achieved_rate_hz": (num_arrivals / arrival_wall
                           if arrival_wall > 0 else 0.0),
      "profile": profile,
      "start_lag_ms_p95": lag_p95,
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
