"""Train state, the train step, the K-step train loop and the predict
function.

Counterpart of `tensor2robot_tpu.parallel.train_step` on one device.
`TrainState` holds the step, the parameters as a flat `state_dict`, the
optimizer state (`models.optimizers` layout) and the EMA shadow
parameters (or None). The JAX package jits a pure step over a mesh; here
the step runs eagerly on the parameters' device and returns a new state:
the state it was given is left as it was.

Meshes, sharding rules, donation, remat, gradient accumulation, PCGrad
and the eval step are not ported yet (ROADMAP.md, Queue A).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import torch

from tensor2robot_tpu_torch import modes as modes_lib
from tensor2robot_tpu_torch.models import optimizers as optimizers_lib

__all__ = ["TrainState", "init_train_state", "create_train_state",
           "loss_and_grads", "make_train_step", "make_train_loop",
           "make_predict_fn", "map_tensors"]

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
  """Model state: step, parameters, EMA shadow parameters (or None) and
  optimizer state (or None for a serving-only state)."""

  step: int
  params: Params
  ema_params: Optional[Params] = None
  opt_state: Any = None

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
                        opt_state=map_tensors(move, self.opt_state))


def init_train_state(model, params: Params, step: int = 0) -> TrainState:
  """The state a run starts from on `params`: the model's optimizer
  state, and the EMA shadow as a copy of the parameters when the model
  uses EMA (a copy, not an alias: the step replaces params, never the
  shadow's storage)."""
  ema = ({k: v.clone() for k, v in params.items()} if model.use_ema
         else None)
  return TrainState(step=int(step), params=params, ema_params=ema,
                    opt_state=model.build_optimizer().init(params))


def create_train_state(model, generator: torch.Generator,
                       device: torch.device) -> TrainState:
  """Fresh parameters from `generator` (drawn on the CPU, then moved),
  step 0, fresh optimizer state, EMA as a copy when the model uses it."""
  params = {k: v.to(device) for k, v in model.init_params(generator).items()}
  return init_train_state(model, params)


def _float32_outputs(outputs) -> Dict[str, torch.Tensor]:
  return {k: v.float() if v.dtype == torch.bfloat16 else v
          for k, v in outputs.items()}


def loss_and_grads(model, params: Params, features, labels):
  """(loss, scalars, grads) of `model.model_train_fn` on one batch, the
  gradients taken with respect to `params` (f32 masters: under the
  bfloat16 policy the forward casts them to bf16 and the gradients flow
  back through the cast). loss and scalars are detached."""
  names = list(params)
  leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
  compute_features = model.cast_features_for_compute(features)
  outputs = _float32_outputs(model.inference_network_fn(
      leaves, compute_features, modes_lib.TRAIN))
  loss, scalars = model.model_train_fn(features, labels, outputs,
                                       modes_lib.TRAIN)
  grads = dict(zip(names, torch.autograd.grad(
      loss, [leaves[k] for k in names])))
  return (loss.detach(), {k: v.detach() for k, v in scalars.items()},
          grads)


def make_train_step(model) -> Callable:
  """The train step: (state, features, labels) -> (new_state, metrics).

  `loss_and_grads`, then the optimizer update, then
  the EMA `e * d + (1 - d) * p` on the new parameters. Metrics: `loss`,
  `global_gradient_norm` of the raw gradients, and the model's scalars,
  as 0-dim tensors on the device (reading them syncs)."""
  optimizer = model.build_optimizer()
  ema_decay = model.ema_decay

  def step_fn(state: TrainState, features, labels):
    loss, scalars, grads = loss_and_grads(model, state.params, features,
                                          labels)
    with torch.no_grad():
      updates, opt_state = optimizer.update(grads, state.opt_state,
                                            state.params)
      params = optimizers_lib.apply_updates(state.params, updates)
      ema = state.ema_params
      if ema is not None:
        ema = {k: e * ema_decay + (1.0 - ema_decay) * params[k]
               for k, e in ema.items()}
      metrics = {"loss": loss,
                 "global_gradient_norm": optimizers_lib.global_norm(grads),
                 **scalars}
    return state.replace(step=state.step + 1, params=params,
                         opt_state=opt_state, ema_params=ema), metrics

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


def make_predict_fn(model, use_ema: bool = True) -> Callable:
  """(state, features) -> export outputs, with bfloat16 outputs cast to
  float32."""

  @torch.no_grad()
  def predict_fn(state: TrainState, features):
    params = state.eval_params(use_ema=use_ema)
    compute_features = model.cast_features_for_compute(features)
    outputs = model.inference_network_fn(params, compute_features,
                                         modes_lib.PREDICT)
    return model.create_export_outputs_fn(features, _float32_outputs(outputs))

  return predict_fn
