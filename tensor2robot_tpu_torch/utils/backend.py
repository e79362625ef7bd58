"""Device barrier, allocator accounting, the heartbeat monitor, the
timing probes and the card's peaks.

The port of the JAX package's `utils.backend`, for the step-stats
recorder, the flight recorder, the run record and the compile X-ray:

* `state_barrier(state)` waits for the train step just issued and
  returns its smallest parameter leaf on the host: a CUDA event recorded
  on the leaf's stream after the step and waited on, then the copy. The
  leaf depends on the whole forward, backward and update, so the wait
  covers the step, and the sentinel's non-finite-parameter check reads
  the copy at no extra cost. On the CPU it is a plain copy. `sync(x)` is
  the same barrier for any tensor or tree of tensors.
* `device_memory_stats(device)`: the caching allocator's counters for a
  CUDA device (`live_bytes` = `torch.cuda.memory_allocated`,
  `live_arrays` = the allocator's `active.all.current`,
  `device_bytes_in_use` / `device_peak_bytes_in_use` = its allocated
  bytes now and at peak, `device_bytes_limit` = the card's memory from
  `torch.cuda.mem_get_info`); {} for the CPU, so the recorder's device
  gauges latch off there (the JAX package counts live CPU arrays).
* `HeartbeatMonitor`, `record_heartbeat`, `tunnel_health`: the JAX
  package's health state machine with its record keys and knobs (a
  per-probe slow threshold, the inconclusive `ok=None`, the transition
  cap), so run records and postmortem bundles of both packages share one
  schema. On a local card the heartbeat is the health of the step-stats
  barrier: each barrier on the card stamps it.
* `time_op`, `time_train_steps`, `time_train_steps_halves`: the JAX
  package's timing probes, with its barrier discipline (warm up, barrier,
  timed loop, barrier; the barrier's own cost measured back to back and
  subtracted), the barrier being `sync` / `state_barrier`.
* `accelerator_healthy(timeout)`: whether a fresh interpreter sees a
  CUDA device, stamped into the heartbeat.
* `H100_PEAK_BF16_FLOPS` and `H100_PEAK_HBM_BW`: the published dense
  bf16 tensor-core rate and HBM rate of one H100 SXM, the figures of
  `PERF.md`'s bound column. The compile X-ray prices its roofline
  against them.

The JAX package's CPU pinning (`pin_cpu`, `assert_cpu_backend`) has no
torch subject: the port runs on the CPU when a caller passes
`device='cpu'`. Nothing here imports torch at module level: the flight
recorder reads `tunnel_health()` from a signal handler.
"""

from __future__ import annotations

import os
import subprocess
import sys
import threading
import time
from typing import Any, Dict, Optional

__all__ = ["state_barrier", "state_device", "device_memory_stats", "sync",
           "HeartbeatMonitor", "heartbeat_monitor", "record_heartbeat",
           "tunnel_health", "time_op", "time_train_steps",
           "time_train_steps_halves", "accelerator_healthy",
           "H100_PEAK_BF16_FLOPS", "H100_PEAK_HBM_BW"]

# One NVIDIA H100 SXM, dense, at its full 700 W limit (NVIDIA's data
# sheet): the rates of `PERF.md`'s bound column.
H100_PEAK_BF16_FLOPS = 989e12
H100_PEAK_HBM_BW = 3.35e12


def _smallest_leaf(state) -> Any:
  """The parameter tensor of `state` with the fewest elements (the first
  such one in the parameters' order)."""
  return min(state.params.values(), key=lambda leaf: leaf.numel())


def state_device(state) -> Optional[Any]:
  """The device of `state`'s parameters, or None when `state` carries no
  tensor parameters."""
  params = getattr(state, "params", None)
  if not params:
    return None
  return getattr(_smallest_leaf(state), "device", None)


def state_barrier(state):
  """Waits for the work that writes `state` and returns its smallest
  parameter leaf as a float32 numpy array on the host."""
  import torch

  leaf = _smallest_leaf(state).detach()
  if leaf.is_cuda:
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(leaf.device))
    event.synchronize()
  return leaf.to("cpu", torch.float32, copy=True).numpy()


def sync(x):
  """Waits for the device work that writes `x` (a tensor or nested dicts,
  lists and tuples of tensors) and returns `x`: a CUDA event recorded on
  each device's current stream after the work, and waited on. Tensors on
  the CPU are ready already."""
  import torch

  devices = set()

  def visit(tree):
    if isinstance(tree, torch.Tensor):
      if tree.is_cuda:
        devices.add(tree.device)
    elif isinstance(tree, dict):
      for value in tree.values():
        visit(value)
    elif isinstance(tree, (list, tuple)):
      for value in tree:
        visit(value)

  visit(x)
  for device in devices:
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(device))
    event.synchronize()
  return x


def device_memory_stats(device=None) -> Dict[str, float]:
  """Allocator accounting of a CUDA `device` (module docstring); {} for
  the CPU or None. Reads counters only: it launches nothing."""
  if device is None or getattr(device, "type", device) != "cuda":
    return {}
  import torch

  stats = torch.cuda.memory_stats(device)
  _, total = torch.cuda.mem_get_info(device)
  return {
      "live_arrays": float(stats.get("active.all.current", 0)),
      "live_bytes": float(torch.cuda.memory_allocated(device)),
      "device_bytes_in_use": float(stats.get("allocated_bytes.all.current",
                                             0)),
      "device_peak_bytes_in_use": float(
          stats.get("allocated_bytes.all.peak", 0)),
      "device_bytes_limit": float(total),
  }


# A barrier that succeeds but takes this long marks the device degraded
# (the monitor's default; a probe may pass its own).
DEGRADED_AFTER_S = 60.0
# The timeline keeps its first transition and the newest ones, this many
# in all (the monitor's default).
MAX_TRANSITIONS = 64


class HeartbeatMonitor:
  """Device-health state machine fed by timestamped barriers and probes.

  Each step-stats barrier on the card, and each `accelerator_healthy`
  probe, stamps its outcome here, and the monitor classifies the device
  as ``healthy`` / ``degraded`` / ``dead`` (``unknown`` before the first
  stamp), keeping the transition timeline. `obs.flightrec` snapshots
  `health_block()` into postmortem bundles and the run record carries it
  as `tunnel_health` (the JAX package's key). Pure host-side stdlib
  state: recording a heartbeat never touches a device, so it is safe from
  signal handlers and watchdog threads.

  Classification per stamp:

  * ``ok=True`` and faster than the slow threshold -> ``healthy``
  * ``ok=True`` but slower                         -> ``degraded``
  * ``ok=None`` (ran but inconclusive: the device answered, the probe's
    own workload failed)                           -> ``degraded``
  * ``ok=False`` (the barrier or probe failed)     -> ``dead``
  """

  HEALTHY = "healthy"
  DEGRADED = "degraded"
  DEAD = "dead"
  UNKNOWN = "unknown"

  def __init__(self, degraded_after_s: float = DEGRADED_AFTER_S,
               clock=None, max_transitions: int = MAX_TRANSITIONS):
    self._degraded_after_s = float(degraded_after_s)
    self._clock = clock or time.time
    self._max_transitions = int(max_transitions)
    self._lock = threading.Lock()
    self.reset()

  def reset(self) -> None:
    with self._lock:
      self._state = self.UNKNOWN
      self._cause = None
      self._transitions = []
      self._probes = 0
      self._last = None

  def record_probe(self, ok, elapsed_s: float = 0.0,
                   source: str = "probe",
                   cause: Optional[str] = None,
                   degraded_after_s: Optional[float] = None) -> str:
    """Stamps one outcome; returns the (possibly new) state.
    `degraded_after_s` overrides the monitor's slow threshold for this
    stamp only (a probe that pays a fresh interpreter and a first CUDA
    init passes a limit scaled to its own deadline)."""
    now = self._clock()
    slow_after = (self._degraded_after_s if degraded_after_s is None
                  else float(degraded_after_s))
    if ok is True:
      state = self.DEGRADED if elapsed_s >= slow_after else self.HEALTHY
      cause = cause or ("slow_probe" if state == self.DEGRADED else None)
    elif ok is None:
      state, cause = self.DEGRADED, (cause or "probe_inconclusive")
    else:
      state, cause = self.DEAD, (cause or "probe_failed")
    with self._lock:
      self._probes += 1
      self._last = {"ok": ok, "elapsed_s": float(elapsed_s),
                    "unix_time": now, "source": source, "cause": cause}
      if state != self._state:
        self._transitions.append(
            {"state": state, "unix_time": now, "source": source,
             "cause": cause, "elapsed_s": float(elapsed_s)})
        if len(self._transitions) > self._max_transitions:
          # Keep the first transition (when the run's health history
          # started) and the most recent tail.
          self._transitions = (
              [self._transitions[0]]
              + self._transitions[-(self._max_transitions - 1):])
        self._state = state
        self._cause = cause
      return self._state

  @property
  def state(self) -> str:
    return self._state

  def transitions(self) -> list:
    with self._lock:
      return [dict(t) for t in self._transitions]

  def health_block(self) -> dict:
    """JSON-safe summary: current state, cause, transition timeline."""
    with self._lock:
      return {
          "state": self._state,
          "cause": self._cause,
          "probes": self._probes,
          "last_probe": dict(self._last) if self._last else None,
          "transitions": [dict(t) for t in self._transitions],
      }


_HEARTBEAT = HeartbeatMonitor()


def heartbeat_monitor() -> HeartbeatMonitor:
  """The process-wide monitor every barrier on the card stamps into."""
  return _HEARTBEAT


def record_heartbeat(ok, elapsed_s: float = 0.0, source: str = "probe",
                     cause: Optional[str] = None,
                     degraded_after_s: Optional[float] = None) -> str:
  return _HEARTBEAT.record_probe(ok, elapsed_s=elapsed_s, source=source,
                                 cause=cause,
                                 degraded_after_s=degraded_after_s)


def tunnel_health() -> dict:
  """The monitor's JSON-safe health block (state + cause + timeline)."""
  return _HEARTBEAT.health_block()


def time_op(fn, *args, iters: int = 30) -> float:
  """Seconds per call of `fn(*args)` with the barrier's cost cancelled:
  (iters calls + barrier) minus (1 call + barrier, the median of 3), over
  iters - 1. Clamped at 0: a zero says the call is below what the
  barrier's noise lets this method see."""
  if iters < 2:
    raise ValueError("iters must be >= 2 (the barrier-cancelling difference "
                     "needs two run lengths)")
  sync(fn(*args))  # warm up (and compile)

  def run(n):
    start = time.perf_counter()
    out = None
    for _ in range(n):
      out = fn(*args)
    sync(out)
    return time.perf_counter() - start

  t1 = sorted(run(1) for _ in range(3))[1]
  tn = run(iters)
  return max(tn - t1, 0.0) / (iters - 1)


def time_train_steps(step, state, features, labels, iters: int,
                     warmup: int = 3):
  """Times `step(state, features, labels)` (warm up, barrier, timed loop,
  barrier); returns (seconds per step, final state): the mean over both
  halves of `time_train_steps_halves`."""
  h1, h2, state = time_train_steps_halves(step, state, features, labels,
                                          iters, warmup=warmup)
  n1 = iters - iters // 2
  return (h1 * n1 + h2 * (iters - n1)) / iters, state


def time_train_steps_halves(step, state, features, labels, iters: int,
                            warmup: int = 3,
                            out_flags: Optional[dict] = None):
  """`time_train_steps` with the timed loop split into two halves, each
  closed by a `state_barrier`; returns (seconds per step of the first
  half, of the second, final state). The barrier's own cost, measured by
  a second barrier right after the first half's, is subtracted from both
  halves. Where it swallows nearly all of a half (the residual is below
  a fifth of the window), the half is clamped to a fifth of the window
  and `out_flags["barrier_dominated"]` is set: the number is an
  estimate, not a measurement (the sentinel ignores such records)."""
  for _ in range(warmup):
    state, _ = step(state, features, labels)
  state_barrier(state)
  n1 = iters - iters // 2
  n2 = iters - n1
  start = time.perf_counter()
  for _ in range(n1):
    state, _ = step(state, features, labels)
  state_barrier(state)
  mid = time.perf_counter()
  state_barrier(state)
  barrier_cost = time.perf_counter() - mid

  def pure(window, n):
    residual = window - barrier_cost
    if residual < 0.2 * window:
      if out_flags is not None:
        out_flags["barrier_dominated"] = True
      return max(residual, 0.2 * window) / n
    return residual / n

  sec_h1 = pure(mid - start, n1)
  if n2 == 0:
    return sec_h1, sec_h1, state
  mid2 = time.perf_counter()
  for _ in range(n2):
    state, _ = step(state, features, labels)
  state_barrier(state)
  return sec_h1, pure(time.perf_counter() - mid2, n2), state


def accelerator_healthy(timeout: float = 120.0) -> bool:
  """True when a fresh interpreter finds a CUDA device within `timeout`
  seconds. Every outcome is stamped into the heartbeat monitor
  (`tunnel_health()`). A probe that outlives its timeout gets SIGTERM,
  then SIGKILL after 10 s more: the card's own process is never
  touched."""
  proc = subprocess.Popen(
      [sys.executable, "-c",
       "import torch; torch.zeros(1, device='cuda'); "
       "torch.cuda.synchronize()"],
      stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
      env=dict(os.environ))
  start = time.monotonic()
  try:
    ok = proc.wait(timeout=timeout) == 0
  except subprocess.TimeoutExpired:
    proc.terminate()
    try:
      proc.wait(timeout=10)
    except subprocess.TimeoutExpired:
      proc.kill()
      proc.wait()
    record_heartbeat(False, elapsed_s=time.monotonic() - start,
                     source="accelerator_healthy", cause="probe_timeout",
                     degraded_after_s=timeout)
    return False
  record_heartbeat(ok, elapsed_s=time.monotonic() - start,
                   source="accelerator_healthy",
                   cause=None if ok else f"probe_failed(rc={proc.returncode})",
                   degraded_after_s=timeout)
  return ok
