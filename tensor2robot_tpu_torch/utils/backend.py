"""Device barrier, allocator accounting and the heartbeat monitor.

The port's subset of the JAX package's `utils.backend`, for the
step-stats recorder, the flight recorder and the run record:

* `state_barrier(state)` waits for the train step just issued and
  returns its smallest parameter leaf on the host: a CUDA event recorded
  on the leaf's stream after the step and waited on, then the copy. The
  leaf depends on the whole forward, backward and update, so the wait
  covers the step, and the sentinel's non-finite-parameter check reads
  the copy at no extra cost. On the CPU it is a plain copy.
* `device_memory_stats(device)`: the caching allocator's counters for a
  CUDA device (`live_bytes` = `torch.cuda.memory_allocated`,
  `live_arrays` = the allocator's `active.all.current`,
  `device_bytes_in_use` / `device_peak_bytes_in_use` = its allocated
  bytes now and at peak, `device_bytes_limit` = the card's memory from
  `torch.cuda.mem_get_info`); {} for the CPU, so the recorder's device
  gauges latch off there (the JAX package counts live CPU arrays).
* `HeartbeatMonitor`, `record_heartbeat`, `tunnel_health`: the JAX
  package's health state machine with its record keys, so run records
  and postmortem bundles of both packages share one schema. On a local
  card the heartbeat is the health of the step-stats barrier: each
  barrier on the card stamps it.

The JAX package's timing probes and the rest of its backend helpers
wait for the port of its compiler tooling (ROADMAP.md, Queue A item
15). Nothing here imports torch at module level: the flight recorder
reads `tunnel_health()` from a signal handler.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, Optional

__all__ = ["state_barrier", "state_device", "device_memory_stats",
           "HeartbeatMonitor", "heartbeat_monitor", "record_heartbeat",
           "tunnel_health"]


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


# A barrier that succeeds but takes this long marks the device degraded.
DEGRADED_AFTER_S = 60.0
# The timeline keeps its first transition and the newest ones, this many
# in all.
MAX_TRANSITIONS = 64


class HeartbeatMonitor:
  """Device-health state machine fed by timestamped barriers.

  Each step-stats barrier on the card stamps its outcome here, and the
  monitor classifies the device as ``healthy`` / ``degraded`` / ``dead``
  (``unknown`` before the first stamp), keeping the transition timeline.
  `obs.flightrec` snapshots `health_block()` into postmortem bundles and
  the run record carries it as `tunnel_health` (the JAX package's key).
  Pure host-side stdlib state: recording a heartbeat never touches a
  device, so it is safe from signal handlers and watchdog threads.

  Classification per stamp:

  * ``ok=True`` and faster than `DEGRADED_AFTER_S` -> ``healthy``
  * ``ok=True`` but slower                         -> ``degraded``
  * ``ok=False`` (the barrier failed)              -> ``dead``
  """

  HEALTHY = "healthy"
  DEGRADED = "degraded"
  DEAD = "dead"
  UNKNOWN = "unknown"

  def __init__(self):
    self._lock = threading.Lock()
    self.reset()

  def reset(self) -> None:
    with self._lock:
      self._state = self.UNKNOWN
      self._cause = None
      self._transitions = []
      self._probes = 0
      self._last = None

  def record_probe(self, ok: bool, elapsed_s: float = 0.0,
                   source: str = "probe",
                   cause: Optional[str] = None) -> str:
    """Stamps one outcome; returns the (possibly new) state."""
    now = time.time()
    if ok:
      state = (self.DEGRADED if elapsed_s >= DEGRADED_AFTER_S
               else self.HEALTHY)
      cause = cause or ("slow_probe" if state == self.DEGRADED else None)
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
        if len(self._transitions) > MAX_TRANSITIONS:
          # Keep the first transition (when the run's health history
          # started) and the most recent tail.
          self._transitions = ([self._transitions[0]]
                               + self._transitions[-(MAX_TRANSITIONS - 1):])
        self._state = state
        self._cause = cause
      return self._state

  @property
  def state(self) -> str:
    return self._state

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


def record_heartbeat(ok: bool, elapsed_s: float = 0.0,
                     source: str = "probe",
                     cause: Optional[str] = None) -> str:
  return _HEARTBEAT.record_probe(ok, elapsed_s=elapsed_s, source=source,
                                 cause=cause)


def tunnel_health() -> dict:
  """The monitor's JSON-safe health block (state + cause + timeline)."""
  return _HEARTBEAT.health_block()
