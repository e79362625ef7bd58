"""Device-time ledger: busy-vs-idle accounting per device group,
utilization, and cost-per-request.

The port's own copy of the JAX package's `obs.usage`, with the same
arithmetic, registry names and summary block. It derives utilization
from dispatch windows the serving path ALREADY times:

* BUSY time per group = the batcher dispatch windows
  (`MicroBatcher._serve_batch` / `SessionBatcher._serve_batch` stamp
  `dispatch_ns -> end_ns` around every backend call and hand the
  ledger each window through the `usage=` hook). A dispatch occupies
  the group's WHOLE device set, so device-seconds scale by the group's
  device count.
* IDLE time = wall time x devices - busy. Nothing is instrumented for
  idleness — it is the complement, which is what makes busy+idle
  reconcile with wall-clock by construction.
* WINDOWED utilization — a bounded sample ring of (t, cum_busy) per
  group answers "how busy over the last W seconds" (the input of a
  scale-in gate: a trough must be backed by SUSTAINED idle
  device-seconds, not one quiet sample).

Every `record_busy` also mirrors into the active metrics registry
(`<name>/busy_ms/<group>` + `<name>/busy_requests/<group>` counters), so
`metrics.isolated()` windows and graftrace metrics shards carry
per-group busy time for `graftscope watch` without touching the ledger
object. `summary()` exports the `<name>/device_seconds_{busy,idle}` /
`<name>/utilization` / `<name>/cost_per_request_usd` gauges and returns
the JSON block.

Framework-free; thread-safe (one lock, O(1) per record).
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Any, Dict, Optional

from tensor2robot_tpu_torch.obs import metrics as obs_metrics
from tensor2robot_tpu_torch.utils import config

__all__ = ["UsageLedger", "COST_PER_DEVICE_HOUR_USD"]

# The JAX package's placeholder economics anchor, kept so that both
# packages price a ledger alike: not a billing integration (and not a
# GPU price) — cost_per_request only needs to be proportional to
# device-seconds to rank configurations; override per deployment.
COST_PER_DEVICE_HOUR_USD = 1.20


class _Group:
  """One accounted device group (a fleet replica, usually)."""

  __slots__ = ("devices", "opened_s", "closed_s", "busy_s", "requests",
               "samples")

  def __init__(self, devices: int, opened_s: float, sample_cap: int):
    self.devices = max(int(devices), 1)
    self.opened_s = opened_s
    self.closed_s: Optional[float] = None
    self.busy_s = 0.0
    self.requests = 0
    # (t, cum_busy_s) ring for windowed utilization; bounded so a
    # long-lived fleet cannot grow the ledger.
    self.samples: "collections.deque" = collections.deque(
        maxlen=sample_cap)


@config.configurable
class UsageLedger:
  """Per-group busy/idle device-time accounting (module docstring).

  `clock` is injectable (monotonic seconds) so the reconciliation
  arithmetic is testable without sleeping; production callers leave the
  default. `name` prefixes the mirrored registry counters/gauges, so
  two ledgers in one process stay distinguishable.
  """

  def __init__(self, name: str = "serve/fleet",
               cost_per_device_hour_usd: float = COST_PER_DEVICE_HOUR_USD,
               sample_window_s: float = 60.0,
               sample_interval_s: float = 0.25,
               clock=time.monotonic):
    self._name = name
    self._cost_per_device_hour = float(cost_per_device_hour_usd)
    self._sample_interval_s = max(float(sample_interval_s), 0.0)
    cap = int(sample_window_s / max(sample_interval_s, 1e-3)) + 2
    self._sample_cap = max(cap, 8)
    self._clock = clock
    self._lock = threading.Lock()
    self._groups: Dict[str, _Group] = {}

  # -- recording ------------------------------------------------------------

  def open_group(self, group: str, devices: int = 1) -> None:
    """Starts the wall-clock window for a group (idempotent)."""
    now = self._clock()
    with self._lock:
      if group not in self._groups:
        self._groups[group] = _Group(devices, now, self._sample_cap)

  def close_group(self, group: str) -> None:
    """Freezes a group's wall-clock window (replica closed)."""
    now = self._clock()
    with self._lock:
      entry = self._groups.get(group)
      if entry is not None and entry.closed_s is None:
        entry.closed_s = now

  def record_busy(self, group: str, busy_s: float,
                  requests: int = 0) -> None:
    """One dispatch (or warmup) window: `busy_s` seconds during which
    the group's devices were occupied, serving `requests` requests.
    Auto-opens unknown groups (1 device) so bare batchers can feed a
    ledger without opening their group first."""
    if busy_s < 0.0:
      raise ValueError(f"busy_s must be >= 0, got {busy_s}")
    now = self._clock()
    with self._lock:
      entry = self._groups.get(group)
      if entry is None:
        entry = _Group(1, now, self._sample_cap)
        self._groups[group] = entry
      entry.busy_s += float(busy_s)
      entry.requests += int(requests)
      if (not entry.samples
          or now - entry.samples[-1][0] >= self._sample_interval_s):
        entry.samples.append((now, entry.busy_s))
    # Registry mirror (counters live in whatever registry is active —
    # `metrics.isolated()` windows and graftrace shards see per-group
    # busy without holding the ledger).
    obs_metrics.counter(f"{self._name}/busy_ms/{group}").inc(
        float(busy_s) * 1e3)
    if requests:
      obs_metrics.counter(f"{self._name}/busy_requests/{group}").inc(
          int(requests))

  def recorder(self, group: str):
    """A `(busy_s, requests) -> None` bound recorder — the shape the
    batcher `usage=` hook takes."""

    def record(busy_s: float, requests: int = 0) -> None:
      self.record_busy(group, busy_s, requests)

    return record

  # -- reading --------------------------------------------------------------

  def window_utilization(self, window_s: float,
                         now: Optional[float] = None) -> tuple:
    """(utilization, coverage_s) over the trailing window, across open
    groups: busy device-seconds in the window over wall device-seconds
    in it. `coverage_s` is how much of the window the ledger actually
    observed (bounded by the youngest group's age) — the scale-in gate
    treats coverage < window as "not sustained yet"."""
    at = self._clock() if now is None else now
    busy = 0.0
    wall = 0.0
    coverage = float(window_s)
    with self._lock:
      open_groups = [g for g in self._groups.values()
                     if g.closed_s is None]
      if not open_groups:
        return 0.0, 0.0
      for entry in open_groups:
        span = min(float(window_s), max(at - entry.opened_s, 0.0))
        coverage = min(coverage, span)
        wall += span * entry.devices
        cutoff = at - window_s
        baseline = 0.0 if entry.opened_s >= cutoff else None
        for t, cum in entry.samples:
          if t <= cutoff:
            baseline = cum
          else:
            break
        if baseline is None:
          # No sample at-or-before the window edge: the oldest retained
          # sample is the closest honest baseline (underestimates busy,
          # which biases the gate AGAINST scale-in — the safe side).
          baseline = entry.samples[0][1] if entry.samples else 0.0
        busy += (entry.busy_s - baseline) * entry.devices
    if wall <= 0.0:
      return 0.0, coverage
    return min(busy / wall, 1.0), coverage

  def summary(self, now: Optional[float] = None) -> Dict[str, Any]:
    """The JSON utilization block (runs.jsonl), and the gauge export. busy + idle == wall x devices by construction."""
    at = self._clock() if now is None else now
    groups_out: Dict[str, Any] = {}
    busy_total = 0.0
    wall_total = 0.0
    requests_total = 0
    devices_total = 0
    with self._lock:
      items = sorted(self._groups.items())
    for group, entry in items:
      end = entry.closed_s if entry.closed_s is not None else at
      wall_s = max(end - entry.opened_s, 0.0)
      busy_dev_s = entry.busy_s * entry.devices
      wall_dev_s = wall_s * entry.devices
      idle_dev_s = max(wall_dev_s - busy_dev_s, 0.0)
      groups_out[group] = {
          "devices": entry.devices,
          "wall_s": round(wall_s, 4),
          "device_seconds_busy": round(busy_dev_s, 4),
          "device_seconds_idle": round(idle_dev_s, 4),
          "utilization": round(busy_dev_s / wall_dev_s, 4)
                         if wall_dev_s > 0 else 0.0,
          "requests": entry.requests,
      }
      busy_total += busy_dev_s
      wall_total += wall_dev_s
      requests_total += entry.requests
      devices_total += entry.devices
    idle_total = max(wall_total - busy_total, 0.0)
    utilization = busy_total / wall_total if wall_total > 0 else 0.0
    # Cost prices WALL device-seconds (busy AND idle): idle capacity is
    # paid for — that is the whole point of the trough signal.
    cost_total = wall_total / 3600.0 * self._cost_per_device_hour
    cost_per_request = (cost_total / requests_total
                        if requests_total else None)
    out = {
        "devices": devices_total,
        "device_seconds_busy": round(busy_total, 4),
        "device_seconds_idle": round(idle_total, 4),
        "utilization": round(utilization, 4),
        "requests": requests_total,
        "cost_per_device_hour_usd": self._cost_per_device_hour,
        "cost_usd": round(cost_total, 6),
        "cost_per_request_usd": (round(cost_per_request, 8)
                                 if cost_per_request is not None
                                 else None),
        "groups": groups_out,
    }
    obs_metrics.gauge(f"{self._name}/device_seconds_busy").set(
        round(busy_total, 4))
    obs_metrics.gauge(f"{self._name}/device_seconds_idle").set(
        round(idle_total, 4))
    obs_metrics.gauge(f"{self._name}/utilization").set(
        round(utilization, 4))
    if cost_per_request is not None:
      obs_metrics.gauge(f"{self._name}/cost_per_request_usd").set(
          round(cost_per_request, 8))
    return out
