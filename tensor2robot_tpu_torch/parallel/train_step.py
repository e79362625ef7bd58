"""Train state, the train step, the K-step train loop, the eval step and
loop, and the predict function.

Counterpart of `tensor2robot_tpu.parallel.train_step` on one device.
`TrainState` holds the step, the parameters as a flat `state_dict`, the
optimizer state (`models.optimizers` layout), the EMA shadow parameters
(or None) and the mutable state (batch-norm running statistics, flax's
`batch_stats`; {} for a model without). The JAX package jits a pure step
over a mesh; here the step runs eagerly on the parameters' device and
returns a new state: the state it was given is left as it was.

The step's new mutable state comes from the forward on the pre-update
parameters; the EMA covers parameters only, and eval and predict run the
EMA parameters (when kept) with the live mutable state.

The step follows the model's knobs as the JAX package's does:

* `remat`: the forward runs under `torch.utils.checkpoint` (non-reentrant)
  and is recomputed in the backward. The forward draws no randomness and
  writes no buffer (batch norm returns its new statistics), so the
  recompute reproduces it and updates nothing twice;
* `gradient_accumulation_steps > 1`: the optimizer is `multi_steps`, and
  the EMA moves only on a step whose update was applied;
* `use_pcgrad` (with `model_task_losses_fn`): one forward, one gradient
  per task loss in sorted name order, combined by `ops.pcgrad`; the loss
  is the sum of the task losses and the scalars are `task_loss/<name>`.

Meshes, sharding rules and donation are not ported yet (ROADMAP.md,
Queue A item 14).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import torch
import torch.utils.checkpoint

from tensor2robot_tpu_torch import modes as modes_lib
from tensor2robot_tpu_torch.models import optimizers as optimizers_lib
from tensor2robot_tpu_torch.ops import pcgrad as pcgrad_lib

__all__ = ["TrainState", "init_train_state", "create_train_state",
           "loss_and_grads", "task_losses_and_grads", "make_train_step",
           "make_train_loop", "make_eval_step", "make_eval_loop",
           "make_predict_fn", "eval_outputs", "map_tensors"]

Params = Dict[str, torch.Tensor]


def map_tensors(fn: Callable[[torch.Tensor], torch.Tensor], tree: Any) -> Any:
  """Applies `fn` to every tensor of a tree of dicts, tuples and lists;
  other leaves (counts, None) are kept."""
  if isinstance(tree, torch.Tensor):
    return fn(tree)
  if isinstance(tree, dict):
    return {k: map_tensors(fn, v) for k, v in tree.items()}
  if isinstance(tree, (tuple, list)):
    return type(tree)(map_tensors(fn, v) for v in tree)
  return tree


@dataclasses.dataclass(frozen=True)
class TrainState:
  """Model state: step, parameters, EMA shadow parameters (or None),
  optimizer state (or None for a serving-only state) and mutable state
  (the module's buffers by name; {} for a module without)."""

  step: int
  params: Params
  ema_params: Optional[Params] = None
  opt_state: Any = None
  mutable_state: Params = dataclasses.field(default_factory=dict)

  def eval_params(self, use_ema: bool = True) -> Params:
    """Params for eval/serving: the EMA shadow when present."""
    if use_ema and self.ema_params is not None:
      return self.ema_params
    return self.params

  def replace(self, **changes) -> "TrainState":
    return dataclasses.replace(self, **changes)

  def to(self, device) -> "TrainState":
    """The same state with every tensor on `device`."""
    move = lambda x: x.to(device)
    return self.replace(params=map_tensors(move, self.params),
                        ema_params=map_tensors(move, self.ema_params),
                        opt_state=map_tensors(move, self.opt_state),
                        mutable_state=map_tensors(move, self.mutable_state))


def init_train_state(model, params: Params, step: int = 0) -> TrainState:
  """The state a run starts from on `params`: the model's optimizer
  state, the EMA shadow as a copy of the parameters when the model uses
  EMA (a copy, not an alias: the step replaces params, never the
  shadow's storage), and the model's initial mutable state on the
  parameters' device."""
  ema = ({k: v.clone() for k, v in params.items()} if model.use_ema
         else None)
  device = next(iter(params.values())).device
  mutable_state = {k: v.to(device)
                   for k, v in model.init_mutable_state().items()}
  return TrainState(step=int(step), params=params, ema_params=ema,
                    opt_state=model.build_optimizer().init(params),
                    mutable_state=mutable_state)


def create_train_state(model, generator: torch.Generator,
                       device: torch.device) -> TrainState:
  """Fresh parameters from `generator` (drawn on the CPU, then moved),
  step 0, fresh optimizer state, EMA as a copy when the model uses it, the
  initial mutable state."""
  params = {k: v.to(device) for k, v in model.init_params(generator).items()}
  return init_train_state(model, params)


def _float32_outputs(outputs) -> Dict[str, torch.Tensor]:
  return {k: v.float() if v.dtype == torch.bfloat16 else v
          for k, v in outputs.items()}


def _train_forward(model, leaves: Params, features, mutable_state):
  """Train-mode outputs (bfloat16 cast to float32) and the new mutable
  state of the forward on `leaves`; under `model.remat` its activations
  are recomputed in the backward instead of kept."""
  compute_features = model.cast_features_for_compute(features)

  def forward(leaves):
    outputs, new_mutable = model.inference_network_fn(
        leaves, mutable_state or {}, compute_features, modes_lib.TRAIN,
        train=True)
    return _float32_outputs(outputs), new_mutable

  if getattr(model, "remat", False):
    return torch.utils.checkpoint.checkpoint(forward, leaves,
                                             use_reentrant=False)
  return forward(leaves)


def _leaves(params: Params) -> Params:
  return {k: v.detach().requires_grad_(True) for k, v in params.items()}


def loss_and_grads(model, params: Params, features, labels,
                   mutable_state: Optional[Params] = None):
  """(loss, scalars, grads, new mutable state) of `model.model_train_fn`
  on one batch, the forward in train mode on `params` and
  `mutable_state` (default {}), the gradients taken with respect to
  `params` (f32 masters: under the bfloat16 policy the forward casts them
  to bf16 and the gradients flow back through the cast). loss and scalars
  are detached; the new mutable state is {} for a model without one. A
  parameter the loss does not reach (the domain-adaptive model's learned
  loss outside MAML) gets a zero gradient, as `jax.grad` gives it."""
  names = list(params)
  leaves = _leaves(params)
  outputs, new_mutable = _train_forward(model, leaves, features,
                                        mutable_state)
  loss, scalars = model.model_train_fn(features, labels, outputs,
                                       modes_lib.TRAIN)
  grads = dict(zip(names, torch.autograd.grad(
      loss, [leaves[k] for k in names], allow_unused=True,
      materialize_grads=True)))
  return (loss.detach(), {k: v.detach() for k, v in scalars.items()},
          grads, new_mutable)


def task_losses_and_grads(model, params: Params, features, labels,
                          mutable_state: Optional[Params] = None):
  """({task: loss}, [grads per task in sorted task order], new mutable
  state) of `model.model_task_losses_fn` on one forward: one
  `torch.autograd.grad` per task loss, the graph kept for all but the
  last (the JAX package's `jax.jacrev` over the stacked task losses)."""
  names = list(params)
  leaves = _leaves(params)
  outputs, new_mutable = _train_forward(model, leaves, features,
                                        mutable_state)
  losses = model.model_task_losses_fn(features, labels, outputs,
                                      modes_lib.TRAIN)
  tasks = sorted(losses)
  task_grads = []
  for i, task in enumerate(tasks):
    grads = torch.autograd.grad(losses[task], [leaves[k] for k in names],
                                retain_graph=i < len(tasks) - 1)
    task_grads.append(dict(zip(names, grads)))
  return ({k: v.detach() for k, v in losses.items()}, task_grads,
          new_mutable)


def _uses_pcgrad(model) -> bool:
  return bool(getattr(model, "use_pcgrad", False)) and (
      getattr(model, "model_task_losses_fn", None) is not None)


def make_train_step(model) -> Callable:
  """The train step: (state, features, labels) -> (new_state, metrics).

  `loss_and_grads` (or, under PCGrad, `task_losses_and_grads` and
  `pcgrad_combine`; its forward also gives the new mutable state, from
  the pre-update parameters), then the optimizer update, then the EMA
  `e * d + (1 - d) * p` on the new parameters when the update was
  applied. Metrics: `loss`, `global_gradient_norm` of the gradients the
  optimizer gets (the micro-batch's under accumulation, the combined ones
  under PCGrad), and the model's scalars, as 0-dim tensors on the device
  (reading them syncs)."""
  optimizer = model.build_optimizer()
  ema_decay = model.ema_decay
  use_pcgrad = _uses_pcgrad(model)

  def step_fn(state: TrainState, features, labels):
    if use_pcgrad:
      task_losses, task_grads, new_mutable = task_losses_and_grads(
          model, state.params, features, labels, state.mutable_state)
      grads = pcgrad_lib.pcgrad_combine(
          task_grads,
          use_flat_projection=getattr(model, "pcgrad_flat_projection",
                                      False),
          allowlist=getattr(model, "pcgrad_allowlist", None),
          denylist=getattr(model, "pcgrad_denylist", None))
      loss = sum(task_losses.values())
      scalars = {f"task_loss/{k}": v for k, v in task_losses.items()}
    else:
      loss, scalars, grads, new_mutable = loss_and_grads(
          model, state.params, features, labels, state.mutable_state)
    with torch.no_grad():
      updates, opt_state = optimizer.update(grads, state.opt_state,
                                            state.params)
      applied = optimizers_lib.has_updated(opt_state)
      params = (optimizers_lib.apply_updates(state.params, updates)
                if applied else state.params)
      ema = state.ema_params
      if ema is not None and applied:
        ema = {k: e * ema_decay + (1.0 - ema_decay) * params[k]
               for k, e in ema.items()}
      metrics = {"loss": loss,
                 "global_gradient_norm": optimizers_lib.global_norm(grads),
                 **scalars}
    return state.replace(step=state.step + 1, params=params,
                         opt_state=opt_state, ema_params=ema,
                         mutable_state=new_mutable or state.mutable_state
                         ), metrics

  return step_fn


def make_train_loop(model, num_steps: int) -> Callable:
  """K train steps per call: (state, features, labels) -> (state, stacked
  metrics), with features and labels carrying a leading `num_steps` axis
  of batches. The same math as K calls of `make_train_step`; each metric
  comes back stacked on a leading axis."""
  if num_steps < 1:
    raise ValueError(f"num_steps must be >= 1, got {num_steps}")
  step_fn = make_train_step(model)

  def loop_fn(state: TrainState, features, labels):
    history = []
    for i in range(num_steps):
      state, metrics = step_fn(state, {k: v[i] for k, v in features.items()},
                               {k: v[i] for k, v in labels.items()})
      history.append(metrics)
    return state, {k: torch.stack([m[k] for m in history])
                   for k in history[0]}

  return loop_fn


def eval_outputs(model, state: TrainState, features, mode: str,
                  use_ema: bool):
  """Eval-mode outputs (running statistics, no update) of the EMA
  parameters when kept, with the live mutable state; bfloat16 outputs
  cast to float32."""
  outputs, _ = model.inference_network_fn(
      state.eval_params(use_ema=use_ema), state.mutable_state,
      model.cast_features_for_compute(features), mode, train=False)
  return _float32_outputs(outputs)


def make_eval_step(model, use_ema: bool = True) -> Callable:
  """(state, features, labels) -> the model's eval metric scalars, as
  0-dim tensors on the device."""

  @torch.no_grad()
  def eval_fn(state: TrainState, features, labels):
    outputs = eval_outputs(model, state, features, modes_lib.EVAL, use_ema)
    return model.model_eval_fn(features, labels, outputs)

  return eval_fn


def make_eval_loop(model, num_steps: int, use_ema: bool = True) -> Callable:
  """K eval batches per call: (state, features, labels) -> metric scalars
  SUMMED over the K batches (divide by K for the mean), with features and
  labels carrying a leading `num_steps` axis of batches."""
  if num_steps < 1:
    raise ValueError(f"num_steps must be >= 1, got {num_steps}")
  eval_fn = make_eval_step(model, use_ema=use_ema)

  def loop_fn(state: TrainState, features, labels):
    totals: Dict[str, torch.Tensor] = {}
    for i in range(num_steps):
      metrics = eval_fn(state, {k: v[i] for k, v in features.items()},
                        {k: v[i] for k, v in labels.items()})
      for key, value in metrics.items():
        totals[key] = totals[key] + value if key in totals else value
    return totals

  return loop_fn


def make_predict_fn(model, use_ema: bool = True) -> Callable:
  """(state, features) -> export outputs of the eval-mode forward, with
  bfloat16 outputs cast to float32."""

  @torch.no_grad()
  def predict_fn(state: TrainState, features):
    outputs = eval_outputs(model, state, features, modes_lib.PREDICT,
                            use_ema)
    return model.create_export_outputs_fn(features, outputs)

  return predict_fn
