"""Training orchestration: `train_eval_model`, the entry point of a
training or evaluation run, and `predict_from_model`, batch inference
from a checkpoint.

Counterpart of `tensor2robot_tpu.train_eval` on one device, in modes
'train', 'evaluate', 'train_and_evaluate' and 'continuous_eval': input
generator -> train step -> JSONL scalars -> checkpoints -> hooks and
exports, resuming from the newest verified checkpoint in `model_dir`,
with evals in between. Semantics kept from the JAX package:

* the first batch of the stream feeds the first step;
* with `iterations_per_loop` K > 1, a dispatch takes K batches and runs
  K train steps while at least K remain, single steps after that (the
  steps run eagerly one after another either way: K sets only where the
  cadences below fire);
* logging, checkpoint and eval cadences fire when a dispatch *crosses* a
  multiple of their interval (`_crossed`); the last step is always
  logged and evaluated, and a checkpoint is forced at the end;
* an eval runs `eval_steps` batches of a fresh eval stream through the
  eval step (EMA parameters with the live batch-norm statistics unless
  `use_ema_for_eval=False`), sums the metric scalars on the device and
  reads them once, as their mean; in 'train_and_evaluate' they are
  logged beside the train scalars as `eval/<name>`, in 'evaluate' to
  `<model_dir>/eval/metrics.jsonl`;
* a resumed run restores the newest verified checkpoint (a corrupt one
  is quarantined and the next newest serves) and restarts the input
  stream from its seed;
* batches reach the device through `parallel.mesh.DevicePrefetcher`,
  `device_prefetch_depth` of them placed ahead (from page-locked
  buffers on a side stream on the card; 0 places each batch inline),
  and `host_overlap_workers` / `host_overlap_queue_mb` tune the record
  pipelines' parse threads and output queue;
* every stream is closed when its loop ends, however it ends: an eval
  round's stream and the train stream, with the loader threads behind
  them;
* hooks (`hook_builders`, and an `ExportHook` per `export_generators`
  entry keeping `export_num_versions`) are called in the JAX package's
  order: `begin`; per step `after_step` (after the step's group ran);
  `after_checkpoint` after each save that wrote a step; `after_eval`;
  `end` on success. Their export workers are joined however the run
  ends;
* a step-triggered eval within `eval_throttle_secs` (wall clock) of the
  previous one is skipped; the last step's eval never is;
* 'continuous_eval' follows the trainer's checkpoints
  (`checkpoints_iterator`: a step only once its manifest is written),
  copies each out of the trainer's pruning reach (`backup_checkpoint`),
  restores and verifies the copy, evaluates it, writes the scalars to
  `<model_dir>/eval/metrics.jsonl`, calls `after_eval`, removes the
  copy, and stops after `max_train_steps` or once
  `continuous_eval_timeout_secs` pass without a new checkpoint;
* a fresh run (no checkpoint in `model_dir`) of a model with an
  `init_checkpoint` is warm-started from it: only the parameters are
  replaced, so the EMA shadow stays the copy of the fresh init and the
  optimizer and mutable state stay fresh, as in the JAX package;
* checkpoints are saved asynchronously; the save in flight is drained
  before the run returns, however it ends.

Telemetry and recovery, on by default for a training run as in the JAX
package:

* step stats (`obs.stepstats`, every `step_stats_every_n_steps`; None =
  per step on the CPU, the log cadence on CUDA, 0 = off): each window's
  `step_ms`, `device_ms`, `data_wait_ms`, `host_ms`, `examples_per_sec`
  row in `metrics.jsonl` (beside the loss rows), a Chrome trace
  `trace.graftscope.json` and a final registry snapshot there, and one
  schema-versioned record per run in `<model_dir>/runs.jsonl`
  (`obs.runlog`; `python -m tensor2robot_tpu_torch.bin.graftscope`
  renders and diffs them). A window ends in a barrier
  (`utils.backend.state_barrier`) after the next batch is dequeued, so
  the prefetch still overlaps the device. The process-global registry
  and trace buffer are reset when the run starts, before its data
  pipeline does (`reset_run_telemetry=False` keeps them for an owner
  that outlives the run, as a served model in the same process);
* with `enable_sentinel`, the sentinel (`obs.sentinel`: step-time
  spikes, data starvation, non-finite parameters at the barrier and
  non-finite log scalars, allocator drift) writes incidents to
  `<model_dir>/incidents.jsonl`, and the flight recorder
  (`obs.flightrec`) dumps a postmortem bundle under
  `<model_dir>/flightrec/` on a crash, a SIGTERM (main thread only), a
  hang past `watchdog_timeout_secs` (None: no watchdog) or a fatal
  incident;
* divergence rewind: with `rewind_on_divergence`, a fatal non-finite
  incident restores the newest VERIFIED checkpoint (after the save in
  flight lands; a corrupt step is quarantined and the next newest
  serves), calls `after_rewind`, restarts the input stream from its
  seed (so a rewound run equals a clean resume from that checkpoint)
  and continues; a quarantined step is saved again when the replay
  crosses it. Past `max_rewinds`, or with no verified checkpoint, it
  dumps a bundle and raises `RuntimeError`. The run record counts the
  rewinds and their targets (`extra.graftguard`) beside the active
  `obs.faultlab` plan's injections (`extra.faultlab`).

On a mesh (`mesh`, or `mesh_shape` / `mesh_axis_names`, or any world
of more than one rank; `parallel.mesh`: one process per rank), every
rank runs this function: the model gets `set_mesh(mesh)`, the state is
cut into each rank's blocks by `partition_rules` (`train_step`'s ZeRO-3
step), and every rank reads the same global batches and keeps its block
by the model's `batch_partition_spec` (('data',) by default). Rank 0
alone writes summaries, run records, checkpoints (gathered full),
incidents, the flight recorder's bundles and exports (the hooks and
export generators run there, on the gathered state); every rank runs
the sentinel's checks, and the ranks agree on a rewind and on a
preemption by one host all-reduce a step (`Mesh.agree`: CPU tensors over
gloo, no device sync), so each happens on all of them or on none. 'continuous_eval'
runs on one process.

Preemption, as in the JAX package: during the train loop a SIGTERM sets
a flag (`checkpoints.preemption_signal`; the flight recorder dumps its
bundle first), the ranks agree on it at the step's end, and the run
saves that step's checkpoint, waits for it and raises `SystemExit(42)`;
the next run resumes from it.

The compiled step (the JAX package's `executable_cache_dir`): with
`executable_cache_dir` set ("auto" is `<model_dir>/excache`, or a path),
the train step runs through `obs.xray.XrayedFunction`: its forward, loss
and backward compiled by `torch.compile` (Inductor on the card), X-rayed
into the run record's `compile` block, its compiler artifacts stored in
and loaded from `obs.excache` under that directory, and Inductor's own
on-disk cache pointed at `<dir>/inductor`. The default, None, runs the
eager step, where the JAX package's default is "auto" (ROADMAP.md,
"Restrictions that raise by design"). A step on a mesh of more than one
rank is not compiled (`cache/skipped_mesh`). The run record carries the
`cache/*` counters either way.
"""

from __future__ import annotations

import contextlib
import itertools
import logging
import math
import os
import sys
import time
from typing import Iterator, List, Optional, Sequence

import torch
import torch.distributed as dist

from tensor2robot_tpu_torch import checkpoints as checkpoints_lib
from tensor2robot_tpu_torch import modes as modes_lib
from tensor2robot_tpu_torch.hooks import core as hooks_lib
from tensor2robot_tpu_torch.obs import excache as excache_lib
from tensor2robot_tpu_torch.obs import faultlab as faultlab_lib
from tensor2robot_tpu_torch.obs import flightrec as flightrec_lib
from tensor2robot_tpu_torch.obs import metrics as metrics_lib
from tensor2robot_tpu_torch.obs import runlog as runlog_lib
from tensor2robot_tpu_torch.obs import sentinel as sentinel_lib
from tensor2robot_tpu_torch.obs import stepstats as stepstats_lib
from tensor2robot_tpu_torch.obs import trace as trace_lib
from tensor2robot_tpu_torch.obs import xray as xray_lib
from tensor2robot_tpu_torch.parallel import collectives
from tensor2robot_tpu_torch.parallel import mesh as mesh_lib
from tensor2robot_tpu_torch.parallel import train_step as ts
from tensor2robot_tpu_torch.utils import backend
from tensor2robot_tpu_torch.utils import config
from tensor2robot_tpu_torch.utils import device as device_lib
from tensor2robot_tpu_torch.utils import summaries as summaries_lib

__all__ = ["train_eval_model", "predict_from_model"]

_log = logging.getLogger(__name__)

_MODES = ("train", "evaluate", "train_and_evaluate", "continuous_eval")
# The continuous evaluator's checkpoint poll (jittered by a quarter), the
# JAX package's.
CONTINUOUS_EVAL_POLL_SECS = 5.0


def _crossed(interval: int, prev: int, cur: int) -> bool:
  """True when (prev, cur] contains a multiple of `interval`: for a single
  step exactly `cur % interval == 0`; for a K-step dispatch the event
  fires at the first dispatch boundary past the multiple."""
  return interval > 0 and (cur // interval) > (prev // interval)


def _take(stream: Iterator, k: int) -> List:
  """Up to k batches; fewer only when the stream ends."""
  return list(itertools.islice(stream, k))


def _close_dataset(dataset) -> None:
  """Closes a closable batch source (an `OverlappedLoader`'s stage
  threads, a generator's frame); never raises."""
  if dataset is not None and hasattr(dataset, "close"):
    try:
      dataset.close()
    except Exception:  # noqa: BLE001 - teardown must not mask errors
      _log.exception("train_eval: closing a data source failed")


def _device_batches(dataset: Iterator, device, depth: int, max_batches: int,
                    source=None, batch_spec=None) -> Iterator:
  """(features, labels) on `device` (given a mesh: this rank's block by
  `batch_spec`, on the mesh's device) for up to `max_batches` batches of
  `dataset`: through a `DevicePrefetcher` `depth` ahead, or placed
  inline when `depth` is 0. The caller closes it and `source`."""
  if depth:
    return mesh_lib.DevicePrefetcher(dataset, device, depth=depth,
                                     max_batches=max_batches,
                                     close_source=True, source=source,
                                     batch_spec=batch_spec)
  return (mesh_lib.place_batch(device, batch, batch_spec=batch_spec)
          for batch in itertools.islice(dataset, max_batches))


class _NullWriter:
  """The summary writer of a rank that writes no files."""

  path = None

  def write_scalars(self, step, scalars) -> None:
    del step, scalars

  def close(self) -> None:
    pass


def _run_eval(eval_step, state: ts.TrainState, dataset: Iterator,
              eval_steps: int, device, prefetch_depth: int,
              batch_spec=None) -> dict:
  """The mean of each eval metric over `eval_steps` batches (fewer if
  the stream ends first). The sums stay on the device; the only read is
  the final one. Closes `dataset` however the round ends."""
  totals: dict = {}
  count = 0
  batches = None
  try:
    batches = _device_batches(dataset, device, prefetch_depth, eval_steps,
                              batch_spec=batch_spec)
    for features, labels in batches:
      metrics = eval_step(state, features, labels)
      for key, value in metrics.items():
        totals[key] = totals[key] + value if key in totals else value
      count += 1
  finally:
    if batches is not None:
      batches.close()
    _close_dataset(dataset)
  if not totals:
    return {}
  means = (torch.stack([v.float() for v in totals.values()])
           / max(count, 1)).tolist()
  return dict(zip(totals, means))


@config.configurable
def train_eval_model(
    model=config.REQUIRED,
    model_dir: str = config.REQUIRED,
    mode: str = "train_and_evaluate",
    max_train_steps: int = 1000,
    eval_steps: int = 100,
    eval_every_n_steps: int = 500,
    eval_throttle_secs: float = 0.0,
    checkpoint_every_n_steps: int = 500,
    keep_checkpoints: int = 5,
    input_generator_train=None,
    input_generator_eval=None,
    hook_builders: Optional[Sequence[hooks_lib.HookBuilder]] = None,
    export_generators: Optional[Sequence] = None,
    export_num_versions: int = 3,
    seed: int = 0,
    continuous_eval_timeout_secs: Optional[float] = None,
    log_every_n_steps: int = 100,
    iterations_per_loop: int = 1,
    use_ema_for_eval: bool = True,
    device_prefetch_depth: int = 2,
    host_overlap_workers: Optional[int] = None,
    host_overlap_queue_mb: Optional[float] = None,
    step_stats_every_n_steps: Optional[int] = None,
    enable_sentinel: bool = True,
    watchdog_timeout_secs: Optional[float] = None,
    rewind_on_divergence: bool = True,
    max_rewinds: int = 2,
    reset_run_telemetry: bool = True,
    device=None,
    mesh=None,
    mesh_shape: Optional[Sequence[int]] = None,
    mesh_axis_names: Optional[Sequence[str]] = None,
    partition_rules=None,
    executable_cache_dir: Optional[str] = None,
) -> dict:
  """Trains `model` to `max_train_steps` (with evals in
  'train_and_evaluate'), evaluates the newest checkpoint ('evaluate'),
  or follows the trainer's checkpoints ('continuous_eval'). Returns the
  scalars of the last logged step updated with the last eval's as
  `eval/<name>` ({} when a resumed run had nothing left to do); the eval
  modes return the last eval's scalars.

  Runs on CUDA unless `device` names another (tests pass 'cpu'). Fresh
  parameters come from `torch.Generator().manual_seed(seed)`: flax's
  initialisers, not JAX's numbers. `device_prefetch_depth` batches are
  kept placed ahead on the device (0: each placed inline);
  `host_overlap_workers` parse threads and a `host_overlap_queue_mb`
  output queue are handed to record-backed generators (None keeps
  theirs).

  Telemetry and divergence rewind: the JAX package's parameters and
  defaults (module docstring). `step_stats_every_n_steps` None picks
  per-step on the CPU and `log_every_n_steps` on CUDA, 0 turns step
  telemetry off (and with it the sentinel, the flight recorder and the
  rewind); `enable_sentinel`, `watchdog_timeout_secs` (None: no hang
  watchdog), `rewind_on_divergence` and `max_rewinds` as named;
  `reset_run_telemetry=False` keeps the process-global registry and
  trace buffer for an owner that outlives this run.

  `mesh` (or one built by `parallel.mesh.create_mesh(mesh_shape,
  mesh_axis_names)`; every rank when the world has several) and
  `partition_rules` (e.g. `train_step.fsdp_rules()`) train over a mesh
  (module docstring); the mesh's device is the run's.

  `executable_cache_dir` ("auto" or a directory; None, the default,
  keeps the eager step) compiles, X-rays and caches the train step
  (module docstring)."""
  if mode not in _MODES:
    raise ValueError(f"Unknown train_eval mode {mode!r}")
  needs_train = mode in ("train", "train_and_evaluate")
  needs_eval = mode != "train"
  if needs_train and input_generator_train is None:
    raise ValueError("input_generator_train is required for training.")
  if needs_eval and input_generator_eval is None:
    raise ValueError("input_generator_eval is required for evaluation.")
  device = device_lib.resolve_device(device)
  if mesh is None and (mesh_shape is not None or mesh_axis_names is not None
                       or (dist.is_initialized()
                           and dist.get_world_size() > 1)):
    kwargs = ({"axis_names": tuple(mesh_axis_names)} if mesh_axis_names
              else {})
    mesh = mesh_lib.create_mesh(mesh_shape=mesh_shape, device=device,
                                **kwargs)
  batch_spec = None
  if mesh is not None:
    device = mesh.device
    if hasattr(model, "set_mesh"):
      model.set_mesh(mesh)
    batch_spec = getattr(model, "batch_partition_spec", None)
    if mode == "continuous_eval":
      if mesh.size > 1:
        raise ValueError("continuous_eval runs on one process, not on a "
                         f"mesh of {mesh.size} ranks")
      mesh = batch_spec = None  # one rank: the single-device path
  # Rank 0 of a mesh writes every file of the run.
  primary = mesh is None or mesh.is_primary
  placement = mesh if mesh is not None else device
  for generator in (input_generator_train, input_generator_eval):
    if generator is not None and hasattr(generator, "set_overlap_options"):
      generator.set_overlap_options(
          num_parallel_parses=host_overlap_workers,
          overlap_queue_mb=host_overlap_queue_mb)
  os.makedirs(model_dir, exist_ok=True)
  hooks: List[hooks_lib.Hook] = []
  for builder in (hook_builders or []) if primary else []:
    hooks.extend(builder.create_hooks(model, model_dir))
  for export_generator in (export_generators or []) if primary else []:
    hooks.append(hooks_lib.ExportHook(export_generator=export_generator,
                                      num_versions=export_num_versions))
  manager = checkpoints_lib.CheckpointManager(
      os.path.join(model_dir, checkpoints_lib.CHECKPOINT_DIRNAME),
      max_to_keep=keep_checkpoints, mesh=mesh)

  if step_stats_every_n_steps is None:
    # One barrier per window serializes the launch queue on the card:
    # per step on the CPU, the log cadence on CUDA.
    step_stats_every_n_steps = (1 if device.type == "cpu"
                                else max(int(log_every_n_steps), 1))
  step_stats = stepstats_lib.StepStatsRecorder(
      batch_size=(input_generator_train.batch_size if needs_train else 0),
      every_n_steps=step_stats_every_n_steps if needs_train else 0)
  if step_stats.enabled and reset_run_telemetry:
    # Per-run telemetry: the saved trace, the final snapshot and the run
    # record cover exactly this run. Before any data pipeline starts: a
    # loader caches its registry objects when it is made, and a later
    # reset would orphan them.
    trace_lib.clear()
    metrics_lib.reset()
    xray_lib.clear_records()

  eval_step = None
  shardings = None
  if needs_eval:
    input_generator_eval.set_specification_from_model(model, modes_lib.EVAL)
    if mesh is None:
      eval_step = ts.make_eval_step(model, use_ema=use_ema_for_eval)

  def evaluate(state: ts.TrainState) -> dict:
    return _run_eval(eval_step, state,
                     input_generator_eval.create_dataset(modes_lib.EVAL),
                     eval_steps, placement, device_prefetch_depth,
                     batch_spec=batch_spec)

  dataset = None
  if needs_train:
    input_generator_train.set_specification_from_model(model,
                                                       modes_lib.TRAIN)
    dataset = input_generator_train.create_dataset(modes_lib.TRAIN)
  batches = None
  writer = (summaries_lib.SummaryWriter(
      os.path.join(model_dir, "train" if needs_train else "eval"))
            if primary else _NullWriter())
  state = None
  sentinel = flight_recorder = None
  # Divergence-rewind latch: set by a sentinel sink on a fatal
  # non-finite incident, consumed once per loop iteration.
  rewind_state = {"pending": False, "count": 0, "targets": []}
  run_memory: dict = {}
  tracer_preenabled = trace_lib.get_tracer().enabled
  try:
    if dataset is not None:
      first_batch = next(dataset)
    if mode != "continuous_eval":
      state, shardings = _initial_state(model, manager, seed, device, mesh,
                                        partition_rules)
      if needs_eval and mesh is not None:
        eval_step = ts.make_eval_step(model, use_ema=use_ema_for_eval,
                                      mesh=mesh, shardings=shardings,
                                      batch_spec=batch_spec)
    if step_stats.enabled:
      hooks.append(hooks_lib.StepStatsHook())
      if enable_sentinel:
        sentinel, flight_recorder = _watch(model_dir, step_stats, hooks,
                                           rewind_state, rewind_on_divergence,
                                           watchdog_timeout_secs, primary)
      try:
        run_memory = xray_lib.memory_accounting(state, batch=first_batch)
      except Exception:  # noqa: BLE001 - telemetry never kills a run
        _log.exception("graftscope-xray: memory accounting failed")
    # The hooks see the gathered full state while a checkpoint's
    # after_checkpoint calls run (a mesh state holds blocks).
    hook_state: dict = {"full": None}
    ctx = hooks_lib.TrainContext(
        model, model_dir,
        get_state=lambda: (hook_state["full"] if hook_state["full"]
                           is not None else state),
        summary_writer=writer if primary else None,
        step_stats=step_stats if step_stats.enabled else None,
        sentinel=sentinel, flight_recorder=flight_recorder)
    for hook in hooks:
      hook.begin(ctx)

    if mode == "evaluate":
      eval_metrics = evaluate(state)
      writer.write_scalars(state.step, eval_metrics)
      _log.info("eval @%d: %s", state.step, eval_metrics)
      for hook in hooks:
        hook.after_eval(ctx, state.step, eval_metrics)
        hook.end(ctx)
      return eval_metrics

    if mode == "continuous_eval":
      eval_metrics = {}
      for step in checkpoints_lib.checkpoints_iterator(
          manager.directory, timeout_secs=CONTINUOUS_EVAL_POLL_SECS,
          total_timeout_secs=continuous_eval_timeout_secs):
        state, eval_metrics = _evaluate_checkpoint(manager, step, device,
                                                   evaluate)
        writer.write_scalars(step, eval_metrics)
        for hook in hooks:
          hook.after_eval(ctx, step, eval_metrics)
        _log.info("continuous eval @%d: %s", step, eval_metrics)
        if step >= max_train_steps:
          break
      for hook in hooks:
        hook.end(ctx)
      return eval_metrics

    train_step = ts.make_train_step(model, mesh=mesh, shardings=shardings,
                                    batch_spec=batch_spec)
    if executable_cache_dir:
      cache_dir = (os.path.join(model_dir, "excache")
                   if executable_cache_dir == "auto" else executable_cache_dir)
      excache_lib.enable_inductor_cache(cache_dir)
      train_step = xray_lib.XrayedFunction(
          "train_step", train_step,
          cache=excache_lib.ExecutableCache(cache_dir), model=model,
          donate_argnums=(0,) if mesh is not None else (), mesh=mesh)
    loop_k = max(1, int(iterations_per_loop))

    def group_size(step: int) -> int:
      return loop_k if (max_train_steps - step) >= loop_k else 1

    def checkpoint(step: int) -> None:
      # A step already on disk is not written again (`save` returns
      # False), so a step a rewind's restore walk quarantined is saved
      # anew when the replay crosses it. On a mesh every rank gathers
      # the full state and rank 0 writes it.
      full = state if shardings is None else ts.gather_state(state,
                                                             shardings)
      if manager.save(step, full):
        _log.info("Saved checkpoint step %d", step)
        hook_state["full"] = full
        try:
          for hook in hooks:
            hook.after_checkpoint(ctx, step)
        finally:
          hook_state["full"] = None

    def rewind(diverged_at: int) -> None:
      """Restores the newest verified checkpoint after a divergence at
      `diverged_at` and restarts the input stream from its seed, so a
      rewound run and a clean resume from that checkpoint consume the
      same batches. Past the `max_rewinds` budget, or with no verified
      checkpoint, dumps a flight-recorder bundle and raises
      `RuntimeError`."""
      nonlocal state, batches, dataset
      rewind_state["pending"] = False
      rewind_state["count"] += 1
      started = time.perf_counter()
      # A save in flight is not yet a step on disk: commit it first, or
      # the walk below may miss the newest checkpoint.
      manager.wait_until_finished()
      target = manager.latest_verified_step()
      if rewind_state["count"] > max(int(max_rewinds), 0) or target is None:
        reason = ("rewind budget exhausted" if target is not None
                  else "no verified checkpoint to rewind to")
        if flight_recorder is not None:
          flight_recorder.dump(f"rewind-escalation:{reason}")
        raise RuntimeError(
            f"graftguard: divergence at step {diverged_at} not recoverable "
            f"({reason}; rewinds={rewind_state['count'] - 1}, "
            f"max_rewinds={max_rewinds})")
      _log.warning("graftguard: divergence at step %d — rewinding to "
                   "verified checkpoint step %d (rewind %d/%d)", diverged_at,
                   target, rewind_state["count"], max_rewinds)
      batches.close()
      _close_dataset(dataset)
      # The verified walk: a step that fails its manifest is quarantined
      # and the next newest serves.
      state = _placed_state(manager.restore(device="cpu"), shardings, device)
      rewind_state["targets"].append(state.step)
      metrics_lib.counter("train/rewinds").inc()
      for hook in hooks:
        hook.after_rewind(ctx, state.step)
      dataset = input_generator_train.create_dataset(modes_lib.TRAIN)
      batches = _device_batches(dataset, placement, device_prefetch_depth,
                                max(max_train_steps - state.step, 0),
                                source=dataset, batch_spec=batch_spec)
      metrics_lib.histogram("train/rewind_ms").record(
          (time.perf_counter() - started) * 1e3)
      if sentinel is not None:
        # A NaN that recurs on the first observation after the restore is
        # a new divergence: it must trigger again (and spend the budget).
        sentinel.reset_nonfinite_latch()
      if flight_recorder is not None:
        flight_recorder.touch()  # a restore is legitimate non-train time

    final_metrics: dict = {}
    step = state.step
    batches = _device_batches(itertools.chain([first_batch], dataset),
                              placement, device_prefetch_depth,
                              max(max_train_steps - step, 0), source=dataset,
                              batch_spec=batch_spec)
    last_log, last_log_step = time.time(), step
    last_eval_time = 0.0
    signals = contextlib.ExitStack()
    try:
      # Before the flight recorder's handler, which chains to it.
      signals.enter_context(checkpoints_lib.preemption_signal())
      if step_stats.enabled:
        trace_lib.enable()
      if flight_recorder is not None:
        # The SIGTERM handler (main thread only) and the hang watchdog,
        # for exactly the loop's lifetime.
        flight_recorder.install()
      group = []
      if step < max_train_steps:
        step_stats.start()
        with step_stats.data_wait():
          group = _take(batches, group_size(step))
      while step < max_train_steps:
        if flight_recorder is not None:
          flight_recorder.touch()
        if not group:
          raise StopIteration(f"finite train stream exhausted after step "
                              f"{step}")
        k = group_size(step)
        # A finite stream that ended mid-group still trains the batches
        # it gave.
        stream_exhausted = len(group) < k
        prev_step = step
        per_step = []
        step_stats.before_dispatch()
        for features, labels in group:
          state, metrics = train_step(state, features, labels)
          per_step.append(metrics)
        step_stats.after_dispatch()
        step = state.step
        # The next group is dequeued while the device runs the steps just
        # launched; the window's barrier comes after it.
        group = []
        if step < max_train_steps and not stream_exhausted:
          with step_stats.data_wait():
            group = _take(batches, group_size(step))
        step_stats.end_step(step, state, num_steps=step - prev_step)
        for i, step_metrics in enumerate(per_step):
          for hook in hooks:
            hook.after_step(ctx, prev_step + i + 1, step_metrics)
        if _crossed(log_every_n_steps, prev_step, step) \
            or step == max_train_steps:
          scalars = {key: float(value) for key, value in metrics.items()}
          if faultlab_lib.maybe_fire(faultlab_lib.TRAIN_NONFINITE) is not None:
            # Chaos seam: a non-finite loss exactly where a real
            # divergence surfaces, at the host read of the log scalars.
            scalars["loss"] = float("nan")
          if sentinel is not None:
            sentinel.observe_metrics(step, scalars)
          writer.write_scalars(step, scalars)
          now = time.time()
          _log.info("step %d: loss=%.5f (%.1f steps/s)", step,
                    scalars.get("loss", float("nan")),
                    (step - last_log_step) / max(now - last_log, 1e-6))
          last_log, last_log_step = now, step
          final_metrics = scalars
        preempted = manager.reached_preemption(step)
        if mesh is not None:
          # Both flags in one host all-reduce: a rewind and a preemption
          # happen on every rank or on none.
          rewind_state["pending"], preempted = mesh.agree(
              rewind_state["pending"], preempted)
        if rewind_state["pending"]:
          # Before the checkpoint cadence: a diverged state is never
          # saved. The incident's postmortem bundle is already on disk
          # (the flight recorder's sink runs first).
          rewind(step)
          step = state.step
          with step_stats.data_wait():
            group = (_take(batches, group_size(step))
                     if step < max_train_steps else [])
          continue
        if _crossed(checkpoint_every_n_steps, prev_step, step):
          checkpoint(step)
        if preempted:
          _log.warning("Preemption signal at step %d: checkpoint + exit.",
                       step)
          checkpoint(step)
          manager.wait_until_finished()
          if mesh is not None:
            # Every rank leaves once rank 0's save is on disk.
            collectives.barrier(mesh.group(mesh.axis_names))
          raise SystemExit(42)
        if eval_step is not None and (
            _crossed(eval_every_n_steps, prev_step, step)
            or step == max_train_steps):
          now = time.time()
          throttled = (eval_throttle_secs and step != max_train_steps
                       and now - last_eval_time < eval_throttle_secs)
          if not throttled:
            last_eval_time = now
            eval_metrics = evaluate(state)
            writer.write_scalars(step, {f"eval/{key}": value
                                        for key, value in eval_metrics.items()})
            for hook in hooks:
              hook.after_eval(ctx, step, eval_metrics)
            _log.info("eval @%d: %s", step, eval_metrics)
            final_metrics.update({f"eval/{key}": value
                                  for key, value in eval_metrics.items()})
            if flight_recorder is not None:
              flight_recorder.touch()  # an eval is legitimate non-train time
        if stream_exhausted:
          # The documented finite-stream exit, as in the JAX package: no
          # save here, and the raise skips the forced save after the loop.
          raise StopIteration(f"finite train stream exhausted after step "
                              f"{step}")
    except Exception as e:
      # An unhandled crash dumps the flight-recorder bundle before
      # unwinding. A finite train stream ending is the documented exit,
      # not a crash.
      if flight_recorder is not None and not isinstance(e, StopIteration):
        flight_recorder.dump("exception", exc=e)
      raise
    finally:
      if flight_recorder is not None:
        flight_recorder.close()  # disarm the watchdog, restore SIGTERM
      signals.close()
      if step_stats.enabled and not tracer_preenabled:
        # Only a tracer this run enabled: an owner that enabled it before
        # keeps tracing after this run returns.
        trace_lib.disable()
    checkpoint(step)
    for hook in hooks:
      hook.end(ctx)
    if step_stats.enabled and primary:
      _append_run_record(model_dir, run_memory, final_metrics, step, device,
                         sentinel=sentinel, rewinds=rewind_state["count"],
                         rewind_steps=rewind_state["targets"],
                         num_devices=1 if mesh is None else mesh.size)
    return final_metrics
  finally:
    if batches is not None:
      batches.close()
    _close_dataset(dataset)
    _drain(hooks, manager, writer)


def _watch(model_dir: str, step_stats, hooks, rewind_state: dict,
           rewind_on_divergence: bool, watchdog_timeout_secs,
           primary: bool = True):
  """(sentinel, flight recorder) of a run, wired as in the JAX package:
  incidents go to `<model_dir>/incidents.jsonl`, then to the flight
  recorder (which dumps a bundle on the first fatal one of each kind),
  then to the rewind latch; the recorder rings each step window before
  the sentinel sees it, so a bundle holds the window that triggered
  it. Appends a `SentinelHook`. A rank other than a mesh's rank 0
  (`primary` False) keeps the sentinel and its rewind latch, and writes
  no incident and has no flight recorder (None)."""
  flight_recorder = (flightrec_lib.FlightRecorder(
      os.path.join(model_dir, flightrec_lib.FLIGHTREC_DIRNAME),
      hang_timeout_secs=watchdog_timeout_secs) if primary else None)
  incidents_path = os.path.join(model_dir, runlog_lib.INCIDENTS_FILENAME)

  def rewind_sink(record):
    if (rewind_on_divergence and record.get("severity") == "fatal"
        and record.get("kind") in (sentinel_lib.NONFINITE_METRIC,
                                   sentinel_lib.NONFINITE_PARAMS)):
      rewind_state["pending"] = True

  sinks = [rewind_sink]
  if primary:
    sinks = [lambda record: runlog_lib.append_record(incidents_path, record),
             flight_recorder.record_incident, rewind_sink]
    step_stats.add_observer(flight_recorder.record_step)
  sentinel = sentinel_lib.Sentinel(sinks=sinks)
  step_stats.add_observer(sentinel.observe_step_record)
  hooks.append(hooks_lib.SentinelHook())
  return sentinel, flight_recorder


def _append_run_record(model_dir: str, run_memory: dict,
                       final_metrics: dict, final_step: int, device,
                       sentinel=None, rewinds: int = 0,
                       rewind_steps: Optional[List[int]] = None,
                       num_devices: int = 1) -> None:
  """Appends this run's schema-versioned record to
  `<model_dir>/runs.jsonl` (`obs.runlog`): the step-stat summary from
  the registry, the compile records of a compiled step (`obs.xray`), the
  memory accounting with the allocator's counters and the watermark
  estimate (fed the compile records' `temp_bytes`), the finite final
  metrics, the heartbeat block, the `cache/*` counters, the sentinel's
  totals, the rewinds and the active fault plan's injections.
  Best-effort: the run's result never depends on its telemetry."""
  try:
    memory = dict(run_memory)
    memory.update(backend.device_memory_stats(device))
    memory["hbm_watermark_bytes"] = xray_lib.hbm_watermark_estimate(
        memory, xray_lib.records())
    stamped = metrics_lib.get_registry().stamped_snapshot()
    summary = runlog_lib.step_stats_summary(stamped["snapshot"])
    # runs.jsonl is strict JSON: a NaN loss costs that one scalar.
    finite_metrics = {}
    for key, value in final_metrics.items():
      try:
        value = float(value)
      except (TypeError, ValueError):
        continue
      if math.isfinite(value):
        finite_metrics[key] = value
    extra = {"model_dir": model_dir, "final_step": int(final_step),
             "final_metrics": finite_metrics,
             "clock": stamped["clock"],
             "tunnel_health": backend.tunnel_health(),
             "cache": excache_lib.cache_stats()}
    if sentinel is not None:
      extra["sentinel"] = sentinel.summary()
    extra["graftguard"] = {"rewinds": int(rewinds),
                           "rewind_steps": [int(s) for s in
                                            (rewind_steps or [])]}
    plan = faultlab_lib.active()
    if plan is not None:
      extra["faultlab"] = plan.summary()
    on_card = device.type == "cuda"
    record = runlog_lib.make_record(
        "train",
        platform="gpu" if on_card else device.type,
        device_kind=(torch.cuda.get_device_name(device) if on_card
                     else device.type),
        num_devices=int(num_devices),
        step_stats=summary,
        compile_records=xray_lib.records(),
        memory=memory,
        extra=extra)
    runlog_lib.append_record(
        os.path.join(model_dir, runlog_lib.RUNS_FILENAME), record)
  except Exception:  # noqa: BLE001 - telemetry never kills a run
    _log.exception("graftscope: run-record append failed")


def _placed_state(state: ts.TrainState, shardings, device) -> ts.TrainState:
  """A full state on the CPU as this rank's blocks (`shardings`; the
  whole state without) on `device`."""
  if shardings is not None:
    state = ts.shard_state(state, shardings)
  return state.to(device)


def _initial_state(model, manager, seed: int, device, mesh=None,
                   rules=None):
  """(state, shardings): the newest verified checkpoint's state; on a
  fresh run, parameters from `seed`, warm-started from
  `model.init_checkpoint` when it has one. On a mesh the full state is
  built (or restored) on the CPU and cut into this rank's blocks by
  `state_shardings(state, mesh, rules)`; without one, shardings are
  None."""
  if manager.latest_step() is not None:
    state = manager.restore(device=device if mesh is None else "cpu")
    _log.info("Resumed from checkpoint step %d", manager.last_restored_step)
  else:
    state = ts.create_train_state(model, torch.Generator().manual_seed(seed),
                                  device if mesh is None else
                                  torch.device("cpu"))
    init_checkpoint = getattr(model, "init_checkpoint", None)
    if init_checkpoint:
      params, names = checkpoints_lib.warm_start_params(
          state.params, init_checkpoint,
          filter_fn=getattr(model, "init_checkpoint_filter", None))
      state = state.replace(params=params)
      _log.info("Warm-started %d parameter tensors from %s", len(names),
                init_checkpoint)
  if mesh is None:
    return state, None
  shardings = ts.state_shardings(state, mesh, rules)
  return _placed_state(state, shardings, device), shardings


def _evaluate_checkpoint(manager, step: int, device, evaluate):
  """(state, eval scalars) of checkpoint `step`, restored (and verified)
  from a backup copy that the trainer's pruning cannot take away, or from
  the step itself when no backup could be made; the copy is removed."""
  backup = checkpoints_lib.backup_checkpoint(manager.directory, step)
  try:
    if backup is not None:
      state = checkpoints_lib.CheckpointManager(
          os.path.dirname(backup), max_to_keep=0,
          async_checkpointing=False).restore(step, device=device)
    else:
      state = manager.restore(step, device=device)
    return state, evaluate(state)
  finally:
    if backup is not None:
      checkpoints_lib.remove_backup(backup)


def _drain(hooks, manager, writer) -> None:
  """Joins the hooks' export workers, closes the writer and waits for the
  checkpoint save in flight. While another error propagates, a failure
  here is logged rather than raised over it."""
  propagating = sys.exc_info()[0] is not None
  for close in [getattr(hook, "close", None) for hook in hooks] + [
      writer.close, manager.wait_until_finished]:
    if close is None:
      continue
    try:
      close()
    except Exception:  # noqa: BLE001 - raised unless another error is
      if not propagating:
        raise
      _log.exception("train_eval: draining %s failed", close)


@config.configurable
def predict_from_model(
    model=config.REQUIRED,
    model_dir: str = config.REQUIRED,
    input_generator=None,
    num_batches: int = 1,
    checkpoint_step: Optional[int] = None,
    use_ema: bool = True,
    device=None) -> List[dict]:
  """Batch offline inference: the predict outputs (numpy, on the host)
  of `num_batches` batches of `input_generator`'s PREDICT stream (fewer
  when it ends), from checkpoint `checkpoint_step` (default: the newest
  verified) of `model_dir`. Runs on CUDA unless `device` names another."""
  if input_generator is None:
    raise ValueError("input_generator is required.")
  device = device_lib.resolve_device(device)
  input_generator.set_specification_from_model(model, modes_lib.PREDICT)
  manager = checkpoints_lib.CheckpointManager(
      os.path.join(model_dir, checkpoints_lib.CHECKPOINT_DIRNAME))
  state = manager.restore(checkpoint_step, device=device)
  predict = ts.make_predict_fn(model, use_ema=use_ema)
  dataset = input_generator.create_dataset(modes_lib.PREDICT)
  outputs = []
  try:
    for batch in itertools.islice(dataset, num_batches):
      features, _ = mesh_lib.place_batch(device, batch)
      outputs.append({k: v.cpu().numpy()
                      for k, v in predict(state, features).items()})
  finally:
    _close_dataset(dataset)
  return outputs
