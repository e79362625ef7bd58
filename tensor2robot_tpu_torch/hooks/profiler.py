"""Profiling hook: a `torch.profiler` trace of a window of training steps.

Counterpart of `tensor2robot_tpu.hooks.profiler`. `ProfilerHook` starts
a `torch.profiler.profile` (CPU activity, and CUDA activity when the
process sees a card) after step `start_step` and stops it after step
`start_step + num_steps`, then writes the window as a Chrome trace,
`<model_dir>/<subdir>/steps_<start>-<end>.chrome.json` (Perfetto or
chrome://tracing open it). `python -m tensor2robot_tpu_torch.bin.graftscope
report <model_dir>` lists the directory.

A profiler that cannot start must not end a training run: the failure
is logged once, counted (`counter/profiler/start_failures`) and the hook
disarms. The end of the run sets `gauge/profiler/trace_captured` to 1 or
0 and logs where the trace is.
"""

from __future__ import annotations

import logging
import os
from typing import Optional

import torch

from tensor2robot_tpu_torch.hooks import core as hooks_lib
from tensor2robot_tpu_torch.obs import metrics as obs_metrics
from tensor2robot_tpu_torch.utils import config

__all__ = ["ProfilerHook", "ProfilerHookBuilder"]

_log = logging.getLogger(__name__)


@config.configurable
class ProfilerHook(hooks_lib.Hook):
  """Traces steps [start_step, start_step + num_steps)."""

  def __init__(self, start_step: int = 10, num_steps: int = 5,
               subdir: str = "profile"):
    self._start_step = start_step
    self._end_step = start_step + num_steps
    self._subdir = subdir
    self._profile = None
    self._failed = False
    self._trace_dir: Optional[str] = None
    self._trace_path: Optional[str] = None

  @property
  def trace_path(self) -> Optional[str]:
    """The Chrome trace written at the end of the window (None before)."""
    return self._trace_path

  def _stop_trace(self) -> None:
    profile, self._profile = self._profile, None
    try:
      profile.stop()
      path = os.path.join(
          self._trace_dir,
          f"steps_{self._start_step}-{self._end_step}.chrome.json")
      profile.export_chrome_trace(path)
      self._trace_path = path
    except Exception as e:  # noqa: BLE001 - a half-started trace must
      # not kill the run at the stop edge either.
      _log.warning("ProfilerHook: stopping the trace failed (%s: %s)",
                   type(e).__name__, e)
      self._trace_dir = None

  def after_step(self, ctx, step, metrics) -> None:
    if (step == self._start_step and self._profile is None
        and not self._failed):
      log_dir = os.path.join(ctx.model_dir, self._subdir)
      os.makedirs(log_dir, exist_ok=True)
      activities = [torch.profiler.ProfilerActivity.CPU]
      if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
      try:
        profile = torch.profiler.profile(activities=activities)
        profile.start()
      except Exception as e:  # noqa: BLE001 - no profiler: log once,
        # count it, keep training.
        self._failed = True
        obs_metrics.counter("profiler/start_failures").inc()
        _log.warning(
            "ProfilerHook: torch.profiler failed to start (%s: %s); "
            "continuing WITHOUT a profiler trace", type(e).__name__, e)
        return
      self._profile = profile
      self._trace_dir = log_dir
    elif self._profile is not None and step >= self._end_step:
      self._stop_trace()

  def end(self, ctx) -> None:
    if self._profile is not None:
      self._stop_trace()
    obs_metrics.gauge("profiler/trace_captured").set(
        1.0 if self._trace_path else 0.0)
    if self._trace_path:
      _log.info("ProfilerHook: profiler trace in %s (open in Perfetto; "
                "`python -m tensor2robot_tpu_torch.bin.graftscope report "
                "%s` lists it)", self._trace_path, ctx.model_dir)
    elif self._failed:
      _log.info("ProfilerHook: no trace captured (the profiler did not "
                "start this run)")


@config.configurable
class ProfilerHookBuilder(hooks_lib.HookBuilder):
  def __init__(self, start_step: int = 10, num_steps: int = 5):
    self._start_step = start_step
    self._num_steps = num_steps

  def create_hooks(self, model, model_dir):
    return [ProfilerHook(start_step=self._start_step,
                         num_steps=self._num_steps)]
