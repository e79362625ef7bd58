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

Telemetry (step stats, sentinel, flight recorder), the executable cache
and divergence rewind are not ported yet (ROADMAP.md, Queue A).
"""

from __future__ import annotations

import itertools
import logging
import os
import sys
import time
from typing import Iterator, List, Optional, Sequence

import torch

from tensor2robot_tpu_torch import checkpoints as checkpoints_lib
from tensor2robot_tpu_torch import modes as modes_lib
from tensor2robot_tpu_torch.hooks import core as hooks_lib
from tensor2robot_tpu_torch.parallel import mesh as mesh_lib
from tensor2robot_tpu_torch.parallel import train_step as ts
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
                    source=None) -> Iterator:
  """(features, labels) on `device` for up to `max_batches` batches of
  `dataset`: through a `DevicePrefetcher` `depth` ahead, or placed
  inline when `depth` is 0. The caller closes it and `source`."""
  if depth:
    return mesh_lib.DevicePrefetcher(dataset, device, depth=depth,
                                     max_batches=max_batches,
                                     close_source=True, source=source)
  return (mesh_lib.place_batch(device, batch)
          for batch in itertools.islice(dataset, max_batches))


def _run_eval(eval_step, state: ts.TrainState, dataset: Iterator,
              eval_steps: int, device, prefetch_depth: int) -> dict:
  """The mean of each eval metric over `eval_steps` batches (fewer if
  the stream ends first). The sums stay on the device; the only read is
  the final one. Closes `dataset` however the round ends."""
  totals: dict = {}
  count = 0
  batches = None
  try:
    batches = _device_batches(dataset, device, prefetch_depth, eval_steps)
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
    device=None,
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
  theirs)."""
  if mode not in _MODES:
    raise ValueError(f"Unknown train_eval mode {mode!r}")
  needs_train = mode in ("train", "train_and_evaluate")
  needs_eval = mode != "train"
  if needs_train and input_generator_train is None:
    raise ValueError("input_generator_train is required for training.")
  if needs_eval and input_generator_eval is None:
    raise ValueError("input_generator_eval is required for evaluation.")
  device = device_lib.resolve_device(device)
  for generator in (input_generator_train, input_generator_eval):
    if generator is not None and hasattr(generator, "set_overlap_options"):
      generator.set_overlap_options(
          num_parallel_parses=host_overlap_workers,
          overlap_queue_mb=host_overlap_queue_mb)
  os.makedirs(model_dir, exist_ok=True)
  hooks: List[hooks_lib.Hook] = []
  for builder in hook_builders or []:
    hooks.extend(builder.create_hooks(model, model_dir))
  for export_generator in export_generators or []:
    hooks.append(hooks_lib.ExportHook(export_generator=export_generator,
                                      num_versions=export_num_versions))
  manager = checkpoints_lib.CheckpointManager(
      os.path.join(model_dir, checkpoints_lib.CHECKPOINT_DIRNAME),
      max_to_keep=keep_checkpoints)

  eval_step = None
  if needs_eval:
    input_generator_eval.set_specification_from_model(model, modes_lib.EVAL)
    eval_step = ts.make_eval_step(model, use_ema=use_ema_for_eval)

  def evaluate(state: ts.TrainState) -> dict:
    return _run_eval(eval_step, state,
                     input_generator_eval.create_dataset(modes_lib.EVAL),
                     eval_steps, device, device_prefetch_depth)

  dataset = None
  if needs_train:
    input_generator_train.set_specification_from_model(model,
                                                       modes_lib.TRAIN)
    dataset = input_generator_train.create_dataset(modes_lib.TRAIN)
  batches = None
  writer = summaries_lib.SummaryWriter(
      os.path.join(model_dir, "train" if needs_train else "eval"))
  state = None
  ctx = hooks_lib.TrainContext(model, model_dir, get_state=lambda: state,
                               summary_writer=writer)
  try:
    if dataset is not None:
      first_batch = next(dataset)
    if mode != "continuous_eval":
      state = _initial_state(model, manager, seed, device)
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

    train_step = ts.make_train_step(model)
    loop_k = max(1, int(iterations_per_loop))

    def checkpoint(step: int) -> None:
      if manager.save(step, state):
        _log.info("Saved checkpoint step %d", step)
        for hook in hooks:
          hook.after_checkpoint(ctx, step)

    final_metrics: dict = {}
    step = state.step
    batches = _device_batches(itertools.chain([first_batch], dataset),
                              device, device_prefetch_depth,
                              max(max_train_steps - step, 0), source=dataset)
    last_log, last_log_step = time.time(), step
    last_eval_time = 0.0
    while step < max_train_steps:
      k = loop_k if (max_train_steps - step) >= loop_k else 1
      group = _take(batches, k)
      if not group:
        raise StopIteration(f"finite train stream exhausted after step "
                            f"{step}")
      prev_step = step
      # A finite stream that ended mid-group still trains the batches it
      # gave.
      per_step = []
      for features, labels in group:
        state, metrics = train_step(state, features, labels)
        per_step.append(metrics)
      step = state.step
      for i, step_metrics in enumerate(per_step):
        for hook in hooks:
          hook.after_step(ctx, prev_step + i + 1, step_metrics)
      if _crossed(log_every_n_steps, prev_step, step) \
          or step == max_train_steps:
        scalars = {key: float(value) for key, value in metrics.items()}
        writer.write_scalars(step, scalars)
        now = time.time()
        _log.info("step %d: loss=%.5f (%.1f steps/s)", step,
                  scalars.get("loss", float("nan")),
                  (step - last_log_step) / max(now - last_log, 1e-6))
        last_log, last_log_step = now, step
        final_metrics = scalars
      if _crossed(checkpoint_every_n_steps, prev_step, step):
        checkpoint(step)
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
      if len(group) < k:
        checkpoint(step)
        raise StopIteration(f"finite train stream exhausted after step "
                            f"{step}")
    checkpoint(step)
    for hook in hooks:
      hook.end(ctx)
    return final_metrics
  finally:
    if batches is not None:
      batches.close()
    _close_dataset(dataset)
    _drain(hooks, manager, writer)


def _initial_state(model, manager, seed: int, device) -> ts.TrainState:
  """The newest verified checkpoint's state; on a fresh run, parameters
  from `seed`, warm-started from `model.init_checkpoint` when it has
  one."""
  if manager.latest_step() is not None:
    state = manager.restore(device=device)
    _log.info("Resumed from checkpoint step %d", manager.last_restored_step)
    return state
  state = ts.create_train_state(model, torch.Generator().manual_seed(seed),
                                device)
  init_checkpoint = getattr(model, "init_checkpoint", None)
  if init_checkpoint:
    params, names = checkpoints_lib.warm_start_params(
        state.params, init_checkpoint,
        filter_fn=getattr(model, "init_checkpoint_filter", None))
    state = state.replace(params=params)
    _log.info("Warm-started %d parameter tensors from %s", len(names),
              init_checkpoint)
  return state


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
