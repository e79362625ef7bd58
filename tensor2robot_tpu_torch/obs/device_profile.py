"""Device-time windows with `torch.profiler`, for the profile scripts.

`profile_window(fn, count)` times `count` calls of `fn` with the host
clock (no profiler, ends in a synchronize), then runs them again under
`torch.profiler` (CPU + CUDA activity) and sums the device-side events:
kernels and copies, one stream, so they do not overlap. Host-side ops are
left out, as they carry their kernels' time too. Needs a CUDA device.
Torch is imported inside the functions, so `obs/` imports without it.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Tuple

__all__ = ["device_events", "profile_window"]


def device_events(prof) -> List[Tuple[str, float]]:
  """(name, device ms) of every device-side event, largest first."""
  from torch.autograd import DeviceType

  out = []
  for event in prof.key_averages():
    if event.device_type != DeviceType.CUDA:
      continue
    ms = event.self_device_time_total / 1e3
    if ms > 0:
      out.append((event.key, ms))
  return sorted(out, key=lambda kv: -kv[1])


def profile_window(fn: Callable[[], object], count: int,
                   top: int = 12) -> Dict[str, object]:
  """Wall ms per call, device-busy ms per call, the device's idle share
  and the `top` device events by time per call; `events` keeps every
  (name, ms per call)."""
  import torch
  from torch.profiler import ProfilerActivity, profile

  torch.cuda.synchronize()
  start = time.perf_counter()
  for _ in range(count):
    fn()
  torch.cuda.synchronize()
  wall_ms = (time.perf_counter() - start) * 1e3
  with profile(activities=[ProfilerActivity.CPU,
                           ProfilerActivity.CUDA]) as prof:
    for _ in range(count):
      fn()
    torch.cuda.synchronize()
  events = [(name, ms / count) for name, ms in device_events(prof)]
  busy_ms = sum(ms for _, ms in events)
  return {"wall_ms_per_call": wall_ms / count,
          "device_busy_ms_per_call": busy_ms,
          "device_idle_share": 1.0 - busy_ms / (wall_ms / count),
          "top_device": [(name[:80], ms) for name, ms in events[:top]],
          "events": events}
