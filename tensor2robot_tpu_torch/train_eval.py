"""Training orchestration: `train_eval_model`, the entry point of a
training or evaluation run.

Counterpart of `tensor2robot_tpu.train_eval.train_eval_model` on one
device, in modes 'train', 'evaluate' and 'train_and_evaluate': input
generator -> train step -> JSONL scalars -> checkpoints, resuming from the
newest verified checkpoint in `model_dir`, with evals in between.
Semantics kept from the JAX package:

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
  stream from its seed.

`continuous_eval`, the eval throttle, hooks, exporters, telemetry (step
stats, sentinel, flight recorder), warm starts, the executable cache and
divergence rewind are not ported yet (ROADMAP.md, Queue A).
"""

from __future__ import annotations

import itertools
import logging
import os
import time
from typing import Iterator, List, Optional

import torch

from tensor2robot_tpu_torch import checkpoints as checkpoints_lib
from tensor2robot_tpu_torch import modes as modes_lib
from tensor2robot_tpu_torch.parallel import train_step as ts
from tensor2robot_tpu_torch.utils import config
from tensor2robot_tpu_torch.utils import device as device_lib
from tensor2robot_tpu_torch.utils import summaries as summaries_lib

__all__ = ["train_eval_model"]

_log = logging.getLogger(__name__)

_MODES = ("train", "evaluate", "train_and_evaluate", "continuous_eval")


def _crossed(interval: int, prev: int, cur: int) -> bool:
  """True when (prev, cur] contains a multiple of `interval`: for a single
  step exactly `cur % interval == 0`; for a K-step dispatch the event
  fires at the first dispatch boundary past the multiple."""
  return interval > 0 and (cur // interval) > (prev // interval)


def _take(stream: Iterator, k: int) -> List:
  """Up to k batches; fewer only when the stream ends."""
  return list(itertools.islice(stream, k))


def _to_device(batch, device) -> dict:
  return {k: v.to(device, non_blocking=True) for k, v in batch.items()}


def _run_eval(eval_step, state: ts.TrainState, dataset: Iterator,
              eval_steps: int, device) -> dict:
  """The mean of each eval metric over `eval_steps` batches (fewer if
  the stream ends first). The sums stay on the device; the only read is
  the final one."""
  totals: dict = {}
  count = 0
  for batch in itertools.islice(dataset, eval_steps):
    metrics = eval_step(state, _to_device(batch["features"], device),
                        _to_device(batch["labels"], device))
    for key, value in metrics.items():
      totals[key] = totals[key] + value if key in totals else value
    count += 1
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
    checkpoint_every_n_steps: int = 500,
    keep_checkpoints: int = 5,
    input_generator_train=None,
    input_generator_eval=None,
    seed: int = 0,
    log_every_n_steps: int = 100,
    iterations_per_loop: int = 1,
    use_ema_for_eval: bool = True,
    device=None,
) -> dict:
  """Trains `model` to `max_train_steps` (with evals in
  'train_and_evaluate'), or evaluates the newest checkpoint
  ('evaluate'). Returns the scalars of the last logged step updated with
  the last eval's as `eval/<name>` ({} when a resumed run had nothing
  left to do); 'evaluate' returns the eval scalars.

  Runs on CUDA unless `device` names another (tests pass 'cpu'). Fresh
  parameters come from `torch.Generator().manual_seed(seed)`: flax's
  initialisers, not JAX's numbers."""
  if mode not in _MODES:
    raise ValueError(f"Unknown train_eval mode {mode!r}")
  if mode == "continuous_eval":
    raise NotImplementedError(
        "train_eval_model mode 'continuous_eval' is not ported yet "
        "(ROADMAP.md, Queue A: continuous_eval)")
  needs_train = mode != "evaluate"
  needs_eval = mode != "train"
  if needs_train and input_generator_train is None:
    raise ValueError("input_generator_train is required for training.")
  if needs_eval and input_generator_eval is None:
    raise ValueError("input_generator_eval is required for evaluation.")
  device = device_lib.resolve_device(device)
  os.makedirs(model_dir, exist_ok=True)
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
                     eval_steps, device)

  if needs_train:
    input_generator_train.set_specification_from_model(model,
                                                       modes_lib.TRAIN)
    dataset = input_generator_train.create_dataset(modes_lib.TRAIN)
    first_batch = next(dataset)
  if manager.latest_step() is not None:
    state = manager.restore(device=device)
    _log.info("Resumed from checkpoint step %d", manager.last_restored_step)
  else:
    state = ts.create_train_state(
        model, torch.Generator().manual_seed(seed), device)

  if not needs_train:
    eval_metrics = evaluate(state)
    with summaries_lib.SummaryWriter(os.path.join(model_dir, "eval")) \
        as writer:
      writer.write_scalars(state.step, eval_metrics)
    _log.info("eval @%d: %s", state.step, eval_metrics)
    return eval_metrics

  train_step = ts.make_train_step(model)
  loop_k = max(1, int(iterations_per_loop))

  def checkpoint(step: int) -> None:
    if manager.save(step, state):
      _log.info("Saved checkpoint step %d", step)

  final_metrics: dict = {}
  stream = itertools.chain([first_batch], dataset)
  step = state.step
  last_log, last_log_step = time.time(), step
  with summaries_lib.SummaryWriter(os.path.join(model_dir, "train")) as writer:
    while step < max_train_steps:
      k = loop_k if (max_train_steps - step) >= loop_k else 1
      batches = _take(stream, k)
      if not batches:
        raise StopIteration(f"finite train stream exhausted after step "
                            f"{step}")
      prev_step = step
      # A finite stream that ended mid-group still trains the batches it
      # gave.
      for batch in batches:
        state, metrics = train_step(state,
                                    _to_device(batch["features"], device),
                                    _to_device(batch["labels"], device))
      step = state.step
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
        eval_metrics = {f"eval/{key}": value
                        for key, value in evaluate(state).items()}
        writer.write_scalars(step, eval_metrics)
        _log.info("eval @%d: %s", step, eval_metrics)
        final_metrics.update(eval_metrics)
      if len(batches) < k:
        checkpoint(step)
        raise StopIteration(f"finite train stream exhausted after step "
                            f"{step}")
    checkpoint(step)
  return final_metrics
