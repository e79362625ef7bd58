"""Training hooks: callbacks the train loop drives.

Counterpart of `tensor2robot_tpu.hooks.core`. A `Hook` is a plain object
with lifecycle callbacks; `train_eval_model` calls them in the JAX
package's order: `begin` once, `after_step` for every step (after its
group of `iterations_per_loop` steps ran), `after_checkpoint` after each
save, `after_eval` after each eval, `end` once on success. `HookBuilder`s
are configurables that make hooks.

`after_step` receives the step's metrics as 0-dim tensors on the device:
reading one waits for the device, so a hook reads them only at its own
cadence and the loop adds no sync per step. `after_rewind` follows a
divergence rewind to a verified checkpoint.

`ExportHook` exports a serving bundle after each checkpoint, keeps the
newest `num_versions`, and can keep a one-version-lagged directory (the
TD3 and QT-Opt target networks read it). Its asynchronous mode never
blocks `after_checkpoint` behind an export: the trainer's thread copies
the eval-time state to the host (`state.to("cpu")` semantics: the export
holds the weights of its own step, and its `global_step` says which)
into a latest-wins pending slot, and one worker drains it. A failed
export is logged and counted (`export/failures`), and `end` raises it.

`StepStatsHook` writes the step-stats windows into the run's
`metrics.jsonl`, the registry snapshot and the Chrome trace at the end;
`SentinelHook` feeds host-side scalars to the sentinel and writes its
incident totals at the end. `train_eval_model` appends both when step
telemetry is on.
"""

from __future__ import annotations

import abc
import json
import logging
import math
import os
import shutil
import threading
import time
from typing import Any, Callable, Dict, List, Mapping, Optional

import numpy as np
import torch

from tensor2robot_tpu_torch import checkpoints as checkpoints_lib
from tensor2robot_tpu_torch.export import export_generator as export_lib
from tensor2robot_tpu_torch.obs import metrics as metrics_lib
from tensor2robot_tpu_torch.parallel import train_step as ts
from tensor2robot_tpu_torch.utils import config

__all__ = ["TrainContext", "Hook", "HookBuilder", "ConfigSaverHook",
           "GoldenValuesHook", "VariableLoggerHook", "ExportHook",
           "DefaultHookBuilder", "AsyncExportHookBuilder", "BestExportHook",
           "StepStatsHook", "SentinelHook", "add_golden_outputs"]

_log = logging.getLogger(__name__)


class TrainContext:
  """What hooks see: the model, the model_dir, the live state through
  `get_state()`, and the run's summary writer (or None).

  `step_stats` is the loop's live `obs.stepstats.StepStatsRecorder`,
  `sentinel` the run's `obs.sentinel.Sentinel`, `flight_recorder` its
  `obs.flightrec.FlightRecorder` (each None when disabled)."""

  def __init__(self, model, model_dir: str,
               get_state: Callable[[], Optional[ts.TrainState]],
               summary_writer=None, step_stats=None, sentinel=None,
               flight_recorder=None):
    self.model = model
    self.model_dir = model_dir
    self.get_state = get_state
    self.summary_writer = summary_writer
    self.step_stats = step_stats
    self.sentinel = sentinel
    self.flight_recorder = flight_recorder


class Hook:
  def begin(self, ctx: TrainContext) -> None:
    pass

  def after_step(self, ctx: TrainContext, step: int,
                 metrics: Mapping[str, Any]) -> None:
    pass

  def after_checkpoint(self, ctx: TrainContext, step: int) -> Optional[str]:
    pass

  def after_rewind(self, ctx: TrainContext, step: int) -> None:
    """Called after a divergence rewind restored a verified checkpoint
    (`step` = the step now resumed from): a hook holding work above it
    (a pending publish) drops it, since those steps are re-trained."""

  def after_eval(self, ctx: TrainContext, step: int,
                 metrics: Mapping[str, Any]) -> None:
    pass

  def end(self, ctx: TrainContext) -> None:
    pass


class HookBuilder(abc.ABC):
  """A configurable factory of hooks."""

  @abc.abstractmethod
  def create_hooks(self, model, model_dir: str) -> List[Hook]:
    ...


@config.configurable
class ConfigSaverHook(Hook):
  """Writes the operative config to model_dir when training begins."""

  def __init__(self, filename: str = "operative_config-0.gin"):
    self._filename = filename

  def begin(self, ctx: TrainContext) -> None:
    os.makedirs(ctx.model_dir, exist_ok=True)
    with open(os.path.join(ctx.model_dir, self._filename), "w") as f:
      f.write(config.operative_config_str())


_GOLDEN_REGISTRY: Dict[str, Callable] = {}


def add_golden_outputs(name: str, fn: Callable) -> None:
  """Registers a golden-value producer: fn(state) -> dict of arrays."""
  _GOLDEN_REGISTRY[name] = fn


@config.configurable
class GoldenValuesHook(Hook):
  """Saves the registered golden values, and the predict outputs on a
  fixed batch (`batch_fn()` -> model-layout features on the state's
  device), to `golden_values.npy` when training ends."""

  def __init__(self, batch_fn: Optional[Callable] = None,
               filename: str = "golden_values.npy"):
    self._batch_fn = batch_fn
    self._filename = filename

  def end(self, ctx: TrainContext) -> None:
    values: Dict[str, np.ndarray] = {}
    state = ctx.get_state()
    for name, fn in _GOLDEN_REGISTRY.items():
      for key, value in fn(state).items():
        values[f"{name}/{key}"] = _numpy(value)
    if self._batch_fn is not None:
      outputs = ts.make_predict_fn(ctx.model)(state, self._batch_fn())
      for key, value in outputs.items():
        values[f"predict/{key}"] = _numpy(value)
    os.makedirs(ctx.model_dir, exist_ok=True)
    np.save(os.path.join(ctx.model_dir, self._filename), values,
            allow_pickle=True)


def _numpy(value) -> np.ndarray:
  if isinstance(value, torch.Tensor):
    return value.detach().float().cpu().numpy()
  return np.asarray(value)


@config.configurable
class VariableLoggerHook(Hook):
  """Logs the parameter count and per-leaf norms every `every_n_steps`
  (the only steps at which it reads the device)."""

  def __init__(self, every_n_steps: int = 100, max_num_variables: int = 50):
    self._every_n_steps = every_n_steps
    self._max = max_num_variables

  def after_step(self, ctx, step, metrics) -> None:
    if step % self._every_n_steps:
      return
    params = ctx.get_state().params
    total = sum(v.numel() for v in params.values())
    _log.info("step %d: %d params in %d tensors", step, total, len(params))
    for name, leaf in list(params.items())[:self._max]:
      _log.info("  %s %s |x|=%.4f", name, tuple(leaf.shape),
                float(torch.linalg.vector_norm(leaf.float())))


@config.configurable
class StepStatsHook(Hook):
  """Writes graftscope step records through the run's `SummaryWriter`.

  The loop-side measurement lives in `obs.stepstats.StepStatsRecorder`
  (`TrainContext.step_stats`); this hook is the write path: each
  window's record into `metrics.jsonl` (its own row, beside the loss
  rows), a final metrics-registry snapshot, and the Chrome trace JSON
  next to them (`trace.graftscope.json` — open in Perfetto)."""

  def __init__(self, trace_filename: str = "trace.graftscope.json"):
    self._trace_filename = trace_filename

  def _flush(self, ctx: TrainContext) -> None:
    if ctx.step_stats is None or ctx.summary_writer is None:
      return
    for step, record in ctx.step_stats.drain():
      ctx.summary_writer.write_scalars(step, record)

  def after_step(self, ctx: TrainContext, step: int, metrics) -> None:
    self._flush(ctx)

  def end(self, ctx: TrainContext) -> None:
    from tensor2robot_tpu_torch.obs import trace as trace_lib

    self._flush(ctx)
    if ctx.summary_writer is None:
      return
    snapshot = metrics_lib.snapshot()
    if snapshot:
      ctx.summary_writer.write_scalars(int(ctx.get_state().step), snapshot)
    tracer = trace_lib.get_tracer()
    if tracer.events():
      log_dir = os.path.dirname(ctx.summary_writer.path)
      tracer.save(os.path.join(log_dir, self._trace_filename))


@config.configurable
class SentinelHook(Hook):
  """Feeds per-step HOST-side scalars to the run's `obs.sentinel` and
  writes its incident totals when training ends.

  Per-step metrics are 0-dim tensors on the device; reading them here
  would wait for the device every step, so `Sentinel.observe_metrics`
  inspects only values already on the host (numbers, numpy) and skips
  tensors; the loop feeds it the log-cadence scalars once they are read
  for logging anyway."""

  def after_step(self, ctx: TrainContext, step: int, metrics) -> None:
    if ctx.sentinel is not None:
      ctx.sentinel.observe_metrics(step, metrics)

  def end(self, ctx: TrainContext) -> None:
    if ctx.sentinel is None or ctx.summary_writer is None:
      return
    summary = ctx.sentinel.summary()
    if summary["incidents"]:
      ctx.summary_writer.write_scalars(
          int(ctx.get_state().step),
          {"sentinel/incidents": float(summary["incidents"]),
           **{f"sentinel/{kind}": float(count)
              for kind, count in summary["by_kind"].items()}})


def _serving_snapshot(state: ts.TrainState) -> ts.TrainState:
  """The state an export writes, copied to the host now: its step, the
  eval-time parameters and the mutable state."""
  return ts.TrainState(
      step=int(state.step),
      params=checkpoints_lib.host_copy(state.eval_params(use_ema=True)),
      mutable_state=checkpoints_lib.host_copy(state.mutable_state))


def _numeric_subdirs(base: str) -> List[str]:
  if not os.path.isdir(base):
    return []
  dirs = [os.path.join(base, d) for d in os.listdir(base)
          if d.isdigit() and os.path.isdir(os.path.join(base, d))]
  return sorted(dirs, key=lambda p: int(os.path.basename(p)))


@config.configurable
class ExportHook(Hook):
  """Exports a bundle after each checkpoint into
  `<model_dir>/<export_dir_name>`, keeps the newest `num_versions`, and
  with `lagged_export_dir_name` copies the version before the newest
  into that directory (kept to `num_versions` too). With `async_export`
  one worker thread writes the bundles; `after_checkpoint` only copies
  the state to the host (module docstring).

  `exports` records each bundle written: its step, path, bytes, and the
  wall clock (`time.time()`) at the snapshot and just after the rename.
  `failures` records each failed export."""

  def __init__(self,
               export_generator=None,
               export_dir_name: str = "export",
               num_versions: int = 3,
               lagged_export_dir_name: Optional[str] = None,
               async_export: bool = False):
    self._export_generator = export_generator
    self._export_dir_name = export_dir_name
    self._num_versions = num_versions
    self._lagged_dir_name = lagged_export_dir_name
    self._async = async_export
    self._worker: Optional[threading.Thread] = None
    self._lock = threading.Lock()
    self._pending = None
    self._worker_running = False
    self.exports: List[dict] = []
    self.failures: List[dict] = []

  def begin(self, ctx: TrainContext) -> None:
    if self._export_generator is not None:
      self._export_generator.set_specification_from_model(ctx.model)

  def after_checkpoint(self, ctx: TrainContext, step: int) -> Optional[str]:
    if self._export_generator is None:
      return None
    state = ctx.get_state()
    if not self._async:
      return self._do_export(ctx, step, state, time.time())
    self._export_generator.prepare(state)
    item = (ctx, step, _serving_snapshot(state), time.time())
    with self._lock:
      # Latest wins: a snapshot still queued behind an export in flight
      # is replaced, never waited for.
      self._pending = item
      if not self._worker_running:
        self._worker_running = True
        # A daemon, as in the JAX package: `close`/`end` join it on every
        # train-loop exit, and a bundle is renamed into place only whole.
        # Backstop exemption (the JAX package's): the drain worker
        # self-terminates as soon as the latest-wins pending slot empties
        # (there is no stop event for a finalizer to set).
        self._worker = threading.Thread(
            target=self._drain, name="export-worker",
            daemon=True)  # graftlint: disable=thread-stage-missing-backstop
        try:
          self._worker.start()
        except BaseException:
          self._worker_running = False
          raise
    return None

  def _drain(self) -> None:
    try:
      while True:
        with self._lock:
          item, self._pending = self._pending, None
          if item is None:
            # The empty slot is seen and the flag cleared under one lock:
            # a concurrent after_checkpoint either hands this worker its
            # snapshot or starts a new worker.
            self._worker_running = False
            return
        ctx, step, state, snapshot_at = item
        try:
          self._do_export(ctx, step, state, snapshot_at)
        except Exception as e:  # noqa: BLE001 - recorded; end() raises it
          _log.exception("ExportHook: async export at step %d failed", step)
          metrics_lib.counter("export/failures").inc()
          self.failures.append({"step": step,
                                "error": f"{type(e).__name__}: {e}"})
    finally:
      # A BaseException leaves the loop with the flag set: clear it, so a
      # later checkpoint starts a new worker (never a successor's flag).
      with self._lock:
        if self._worker is threading.current_thread():
          self._worker_running = False

  def _do_export(self, ctx: TrainContext, step: int, state,
                 snapshot_at: float) -> str:
    base = os.path.join(ctx.model_dir, self._export_dir_name)
    previous = _numeric_subdirs(base)
    path = self._export_generator.export(state, base, global_step=step)
    exported_at = time.time()
    self.exports.append({"step": int(step), "path": path,
                         "bytes": export_lib.directory_bytes(path),
                         "snapshot_at": snapshot_at,
                         "exported_at": exported_at})
    metrics_lib.counter("export/exports").inc()
    if self._lagged_dir_name and previous:
      lagged_base = os.path.join(ctx.model_dir, self._lagged_dir_name)
      name = os.path.basename(previous[-1])
      target = os.path.join(lagged_base, name)
      if not os.path.isdir(target):
        # Copied aside and renamed, so the lagged directory too only ever
        # shows complete bundles.
        tmp = os.path.join(lagged_base, f".{name}.tmp-{os.getpid()}")
        shutil.rmtree(tmp, ignore_errors=True)
        shutil.copytree(previous[-1], tmp)
        os.replace(tmp, target)
        for old in _numeric_subdirs(lagged_base)[:-self._num_versions]:
          shutil.rmtree(old, ignore_errors=True)
    for old in _numeric_subdirs(base)[:-self._num_versions]:
      shutil.rmtree(old, ignore_errors=True)
    return path

  def close(self) -> None:
    """Joins the export worker (it stops once the pending slot is
    empty, so the wait is at most two exports)."""
    worker = self._worker
    if worker is not None and worker.is_alive():
      worker.join()

  def end(self, ctx: TrainContext) -> None:
    self.close()
    if self.failures:
      raise RuntimeError(f"ExportHook: {len(self.failures)} export(s) "
                         f"failed: {self.failures}")


@config.configurable
class DefaultHookBuilder(HookBuilder):
  """The config saver and the variable logger."""

  def create_hooks(self, model, model_dir):
    return [ConfigSaverHook(), VariableLoggerHook()]


@config.configurable
class AsyncExportHookBuilder(HookBuilder):
  """A checkpoint-triggered `ExportHook`, asynchronous by default, with
  `num_versions` kept and, with `lagged`, the `lagged_export` directory."""

  def __init__(self, export_generator=None, num_versions: int = 3,
               lagged: bool = False, async_export: bool = True):
    self._export_generator = export_generator
    self._num_versions = num_versions
    self._lagged = lagged
    self._async_export = async_export

  def create_hooks(self, model, model_dir):
    return [ExportHook(
        export_generator=self._export_generator,
        num_versions=self._num_versions,
        lagged_export_dir_name="lagged_export" if self._lagged else None,
        async_export=self._async_export)]


@config.configurable
class BestExportHook(Hook):
  """Exports only when the eval metric `metric_key` improves, into
  `<model_dir>/<export_dir_name>` (the one best bundle), with the winning
  value in `best_metric.json` there, from which a restarted run resumes
  its comparison."""

  def __init__(self,
               export_generator=None,
               metric_key: str = "loss",
               higher_is_better: bool = False,
               export_dir_name: str = "best_export"):
    self._export_generator = export_generator
    self._metric_key = metric_key
    self._higher = higher_is_better
    self._export_dir_name = export_dir_name
    self._best: Optional[float] = None

  def begin(self, ctx: TrainContext) -> None:
    if self._export_generator is not None:
      self._export_generator.set_specification_from_model(ctx.model)
    record = os.path.join(ctx.model_dir, self._export_dir_name,
                          "best_metric.json")
    if os.path.isfile(record):
      with open(record) as f:
        self._best = json.load(f).get("value")

  def after_eval(self, ctx: TrainContext, step: int, metrics) -> None:
    if self._export_generator is None or self._metric_key not in metrics:
      return
    value = float(metrics[self._metric_key])
    if not math.isfinite(value):
      return  # a NaN baseline would lock out every later export
    improved = (self._best is None or not math.isfinite(self._best)
                or (value > self._best if self._higher
                    else value < self._best))
    if not improved:
      return
    self._best = value
    base = os.path.join(ctx.model_dir, self._export_dir_name)
    self._export_generator.export(ctx.get_state(), base, global_step=step)
    for old in _numeric_subdirs(base)[:-1]:
      shutil.rmtree(old, ignore_errors=True)
    with open(os.path.join(base, "best_metric.json"), "w") as f:
      json.dump({"metric": self._metric_key, "value": value,
                 "step": step}, f)
