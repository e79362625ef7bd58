"""A device trace of a short window, kept in memory, and what the layer
metrics read from it.

`trace_window(fn)` runs `fn` (which enqueues work) under `torch.profiler`,
ends it with a synchronize, and keeps every device event (kernels,
copies, memsets; not the harness's own annotations) and, when asked,
every host op, as (name, start, end) in the profiler's own clock. Busy
time is the union of the device intervals inside the window, so
overlapping streams count once.
"""

from __future__ import annotations

import bisect
import collections
import dataclasses
import re
from typing import Callable, List, Optional, Sequence, Tuple

Interval = Tuple[str, int, int]  # name, start ns, end ns

WINDOW = "portbench/window"


def _merge(intervals: Sequence[Tuple[int, int]]) -> List[Tuple[int, int]]:
  merged: List[List[int]] = []
  for start, end in sorted(intervals):
    if merged and start <= merged[-1][1]:
      merged[-1][1] = max(merged[-1][1], end)
    else:
      merged.append([start, end])
  return [(s, e) for s, e in merged]


@dataclasses.dataclass
class Trace:
  """Device and host events of one traced window."""

  start_ns: int
  end_ns: int
  device: List[Interval]
  host: List[Interval]

  @property
  def window_s(self) -> float:
    return (self.end_ns - self.start_ns) / 1e9

  def _busy(self) -> List[Tuple[int, int]]:
    return _merge([(max(s, self.start_ns), min(e, self.end_ns))
                   for _, s, e in self.device
                   if e > self.start_ns and s < self.end_ns])

  @property
  def busy_s(self) -> float:
    return sum(e - s for s, e in self._busy()) / 1e9

  def kernels(self, pattern: str) -> List[Interval]:
    """The device events whose name matches the regular expression."""
    regex = re.compile(pattern)
    return [ev for ev in self.device if regex.search(ev[0])]

  def top_ops(self, count: int = 10) -> List[list]:
    """[[name, seconds], ...] of the device ops that took most time."""
    total = collections.Counter()
    for name, s, e in self.device:
      total[name] += (e - s) / 1e9
    return [[name[:160], seconds]
            for name, seconds in total.most_common(count)]

  def idle_gaps(self, count: int = 10) -> List[list]:
    """[[what the host was doing, seconds], ...] of the longest gaps with
    no device op: the innermost host op (other than a CUDA runtime call)
    that spans the gap's start."""
    busy = self._busy()
    edges = [self.start_ns] + [x for iv in busy for x in iv] + [self.end_ns]
    gaps = sorted(((edges[i + 1] - edges[i], edges[i])
                   for i in range(0, len(edges), 2)
                   if edges[i + 1] > edges[i]), reverse=True)[:count]
    host = sorted((s, e, name) for name, s, e in self.host
                  if not name.startswith("cuda") and name != WINDOW)
    starts = [s for s, _, _ in host]
    out = []
    for length, at in gaps:
      label = "no host op"
      for i in range(bisect.bisect_right(starts, at) - 1,
                     max(-1, bisect.bisect_right(starts, at) - 20000), -1):
        s, e, name = host[i]
        if e >= at:
          label = name
          break
      out.append([label[:160], length / 1e9])
    return out


def trace_window(fn: Callable[[], None], host: bool = False) -> Trace:
  """Runs `fn` under the profiler and returns its `Trace` (needs CUDA).

  Without `host` only the device's activity is traced, which adds little
  to the host's work, so the window's pace is the untraced one's; the
  window is then the host's clock from the call to the synchronize,
  starting at the first device event. With `host` the host's ops are
  traced too (to name what the host did in each idle gap), and they slow
  the host: its busy and idle numbers are not the window's."""
  import time

  import torch
  from torch.autograd import DeviceType
  from torch.profiler import ProfilerActivity, profile, record_function

  activities = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU]
                                          if host else [])
  torch.cuda.synchronize()
  with profile(activities=activities) as prof:
    began = time.perf_counter()
    with record_function(WINDOW):
      fn()
      torch.cuda.synchronize()
    wall = time.perf_counter() - began
  device, hosted = [], []
  window: Optional[Tuple[int, int]] = None
  for ev in prof.profiler.kineto_results.events():
    start = ev.start_ns()
    item = (ev.name(), start, start + ev.duration_ns())
    if item[0].startswith("portbench/") or ev.is_user_annotation():
      if item[0] == WINDOW and ev.device_type() != DeviceType.CUDA:
        window = item[1:]
      continue
    (device if ev.device_type() == DeviceType.CUDA else hosted).append(item)
  device.sort(key=lambda ev: ev[1])
  if window is None:
    first = device[0][1] if device else 0
    window = (first, first + int(wall * 1e9))
  return Trace(window[0], window[1], device, hosted)
