"""Optimizer and learning-rate-schedule factories.

Counterpart of `tensor2robot_tpu.models.optimizers`, which builds optax
chains. optax is not used here: each transformation is written out as a
functional `init(params) -> state` / `update(grads, state, params) ->
(updates, state)` pair over the flat parameter dict, in optax's order and
with its numerics:

* a schedule is read at the transformation's count *before* that count
  is incremented (`scale_by_schedule`);
* Adam's bias correction uses count + 1, and eps sits outside the sqrt;
* momentum is `t = g + mu * t`, Nesterov returns `g + mu * t_new`;
* rmsprop puts eps *inside* the sqrt (`rsqrt(nu + eps)`), unlike
  `torch.optim.RMSprop`, and applies momentum after the learning rate;
* `clip_by_global_norm` goes first in the chain when asked for;
* `add_decayed_weights` adds `weight_decay * p` to the gradient of each
  leaf its mask selects, and goes before the optimizer in a chain.

States mirror optax's: a chain's state is a tuple of its members' states,
each a dict named after the optax NamedTuple's fields (`count`, `mu`,
`nu`, `trace`, and `inner_state` for a masked transformation), or `{}`
for optax's EmptyState. `multi_steps` (optax.MultiSteps, gradient
accumulation) holds `mini_step`, `gradient_step`, `inner_opt_state` (the
wrapped optimizer's state), `acc_grads` (the running mean of the
micro-batch gradients since the last applied update) and `skip_state`
(`{}`: no skip function). Counts are Python ints; moments are
param-shaped dicts of tensors. `bridge.py` maps an optax state onto this
layout.

The EMA shadow parameters (the reference's MovingAverageOptimizer) are a
field of `parallel.train_step.TrainState`, not a transformation.

Within `in_place()` (the train step's donation) every moment is written
into the state's own tensor and `apply_updates` adds into the
parameters', leaf by leaf, so the update holds one optimizer state and
one set of parameters. The ops and their order are the functional
update's, so the values are bitwise the same.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from tensor2robot_tpu_torch.utils import config

__all__ = [
    "GradientTransformation", "chain", "apply_updates", "global_norm",
    "sharded_norms", "in_place",
    "add_decayed_weights", "multi_steps", "has_updated",
    "create_constant_learning_rate", "create_exponential_decay_learning_rate",
    "create_piecewise_linear_learning_rate",
    "create_adam_optimizer", "create_sgd_optimizer",
    "create_momentum_optimizer", "create_rms_prop_optimizer",
    "DEFAULT_QTOPT_HPARAMS", "create_optimizer_from_hparams",
]

Params = Dict[str, torch.Tensor]
Schedule = Callable[[int], float]


class GradientTransformation(NamedTuple):
  """optax's pair: `init(params) -> state`,
  `update(grads, state, params) -> (updates, new_state)`."""

  init: Callable[[Params], Any]
  update: Callable[..., Tuple[Params, Any]]


def _map(fn, *trees: Params) -> Params:
  return {k: fn(*(t[k] for t in trees)) for k in trees[0]}


def _zeros_like(params: Params) -> Params:
  return {k: torch.zeros_like(v) for k, v in params.items()}


_norm_state = threading.local()
_update_state = threading.local()


@contextlib.contextmanager
def in_place(enabled: bool = True):
  """Within the block (when `enabled`), the transformations write their
  new moments into the state's tensors and `apply_updates` into the
  parameters' (module docstring): the state and parameters given to the
  update are the ones it returns."""
  previous = getattr(_update_state, "in_place", False)
  _update_state.in_place = bool(enabled)
  try:
    yield
  finally:
    _update_state.in_place = previous


def _writes_in_place() -> bool:
  return getattr(_update_state, "in_place", False)


def _moment(decay: float, old: Params, addend: Callable[..., torch.Tensor],
            *trees: Params) -> Params:
  """optax's moment update `addend(leaves) + decay * old`, leaf by leaf;
  within `in_place()` written into `old`'s tensors (`decay * old` first,
  then the addend: IEEE addition commutes, so the bits are the same)."""
  if _writes_in_place():
    for k, t in old.items():
      t.mul_(decay).add_(addend(*(tree[k] for tree in trees)))
    return old
  return {k: addend(*(tree[k] for tree in trees)) + decay * t
          for k, t in old.items()}


@contextlib.contextmanager
def sharded_norms(sum_of_squares: Callable[[Params], torch.Tensor]):
  """Within the block, `global_norm` takes its sum of squares from
  `sum_of_squares(tree)`: the train step on a mesh, whose leaves are
  blocks of the parameters, passes one that adds up the blocks over
  their ranks."""
  previous = getattr(_norm_state, "sum_of_squares", None)
  _norm_state.sum_of_squares = sum_of_squares
  try:
    yield
  finally:
    _norm_state.sum_of_squares = previous


def global_norm(tree: Params) -> torch.Tensor:
  """sqrt of the sum of squares over every leaf (optax.global_norm)."""
  reduce = getattr(_norm_state, "sum_of_squares", None)
  if reduce is not None:
    return torch.sqrt(reduce(tree))
  return torch.sqrt(sum(torch.sum(v * v) for v in tree.values()))


def apply_updates(params: Params, updates: Params) -> Params:
  """params + updates, in the params' dtype (optax.apply_updates); within
  `in_place()` added into the params' tensors."""
  if _writes_in_place():
    for k, p in params.items():
      p.add_(updates[k])
    return params
  return {k: (p + updates[k]).to(p.dtype) for k, p in params.items()}


def chain(*transforms: GradientTransformation) -> GradientTransformation:
  """Applies `transforms` in order; the state is the tuple of theirs."""

  def init(params):
    return tuple(t.init(params) for t in transforms)

  def update(updates, state, params=None):
    new_state = []
    for t, s in zip(transforms, state):
      updates, s = t.update(updates, s, params)
      new_state.append(s)
    return updates, tuple(new_state)

  return GradientTransformation(init, update)


def _identity() -> GradientTransformation:
  return GradientTransformation(lambda params: {},
                                lambda updates, state, params=None:
                                (updates, state))


def _scale(step_size: float) -> GradientTransformation:
  return GradientTransformation(
      lambda params: {},
      lambda updates, state, params=None:
      (_map(lambda g: g * step_size, updates), state))


def _scale_by_schedule(schedule: Schedule) -> GradientTransformation:
  """Multiplies by schedule(count), then increments count."""

  def update(updates, state, params=None):
    step_size = schedule(state["count"])
    return (_map(lambda g: g * step_size, updates),
            {"count": state["count"] + 1})

  return GradientTransformation(lambda params: {"count": 0}, update)


def _scale_by_learning_rate(learning_rate) -> GradientTransformation:
  if callable(learning_rate):
    return _scale_by_schedule(lambda count: -learning_rate(count))
  return _scale(-learning_rate)


def _bias_correction(decay: float, count: int) -> float:
  """1 - decay**count in f32, as optax computes it."""
  return float(np.float32(1) - np.float32(decay) ** np.float32(count))


def _scale_by_adam(b1: float, b2: float, eps: float,
                   eps_root: float = 0.0) -> GradientTransformation:
  def init(params):
    return {"count": 0, "mu": _zeros_like(params), "nu": _zeros_like(params)}

  def update(updates, state, params=None):
    mu = _moment(b1, state["mu"], lambda g: (1 - b1) * g, updates)
    nu = _moment(b2, state["nu"], lambda g: (1 - b2) * (g * g), updates)
    count = state["count"] + 1
    bc1, bc2 = _bias_correction(b1, count), _bias_correction(b2, count)
    out = _map(lambda m, n: (m / bc1) / (torch.sqrt(n / bc2 + eps_root) + eps),
               mu, nu)
    return out, {"count": count, "mu": mu, "nu": nu}

  return GradientTransformation(init, update)


def _trace(decay: float, nesterov: bool) -> GradientTransformation:
  def update(updates, state, params=None):
    new_trace = _moment(decay, state["trace"], lambda g: g, updates)
    out = (_map(lambda g, t: g + decay * t, updates, new_trace)
           if nesterov else new_trace)
    return out, {"trace": new_trace}

  return GradientTransformation(lambda params: {"trace": _zeros_like(params)},
                                update)


def _scale_by_rms(decay: float, eps: float) -> GradientTransformation:
  def update(updates, state, params=None):
    nu = _moment(decay, state["nu"], lambda g: (1 - decay) * (g * g),
                 updates)
    return _map(lambda g, n: g * torch.rsqrt(n + eps), updates, nu), {"nu": nu}

  return GradientTransformation(lambda params: {"nu": _zeros_like(params)},
                                update)


def _clip_by_global_norm(max_norm: float) -> GradientTransformation:
  def update(updates, state, params=None):
    # As optax: the grads as they are below the limit, (g / norm) *
    # max_norm above it; a select on the device, no host sync.
    norm = global_norm(updates)
    below = norm < max_norm
    return _map(lambda g: torch.where(below, g,
                                      (g / norm.to(g.dtype)) * max_norm),
                updates), state

  return GradientTransformation(lambda params: {}, update)


def add_decayed_weights(
    weight_decay: float,
    mask: Optional[Callable[[Params], Dict[str, bool]]] = None
) -> GradientTransformation:
  """optax.add_decayed_weights: `g + weight_decay * p` on every leaf, or
  with `mask` (params -> {name: bool}) on the leaves it selects, the
  others passed through. The state mirrors optax's: `{}`, or with a mask
  `{"inner_state": {}}` (optax.masked's MaskedState around EmptyState)."""

  def update(updates, state, params=None):
    if params is None:
      raise ValueError("add_decayed_weights needs the params.")
    selected = mask(params) if mask is not None else None
    return {k: g + weight_decay * params[k]
            if selected is None or selected[k] else g
            for k, g in updates.items()}, state

  return GradientTransformation(
      lambda params: {} if mask is None else {"inner_state": {}}, update)


def multi_steps(inner: GradientTransformation,
                every_k: int) -> GradientTransformation:
  """optax.MultiSteps(inner, every_k_schedule=every_k) with the gradient
  mean: each update folds the gradients into `acc_grads` as optax's
  running mean, `acc + (g - acc) / (n + 1)` with n = `mini_step`; on
  every k-th update `inner` runs once on that mean, its updates are
  returned, `gradient_step` advances and `acc_grads` restart at zeros.
  The other updates are zeros and leave `inner`'s state as it was, so a
  schedule or a weight decay inside `inner` counts applied updates
  only."""
  every_k = int(every_k)
  if every_k < 1:
    raise ValueError(f"every_k must be >= 1, got {every_k}")

  def init(params):
    return {"mini_step": 0, "gradient_step": 0,
            "inner_opt_state": inner.init(params),
            "acc_grads": _zeros_like(params), "skip_state": {}}

  def update(updates, state, params=None):
    n = state["mini_step"]
    acc = state["acc_grads"]
    if _writes_in_place():
      for k, a in acc.items():
        a.add_((updates[k] - a) / (n + 1))
    else:
      acc = _map(lambda g, a: a + (g - a) / (n + 1), updates, acc)
    if n < every_k - 1:
      return _zeros_like(updates), {**state, "mini_step": n + 1,
                                    "acc_grads": acc}
    out, inner_state = inner.update(acc, state["inner_opt_state"], params)
    if _writes_in_place():
      # An inner chain that passes its input through hands back `acc`'s
      # own tensors, which the restart zeroes.
      out = {k: u.clone() if u is acc[k] else u for k, u in out.items()}
      for a in acc.values():
        a.zero_()
    else:
      acc = _zeros_like(acc)
    return out, {"mini_step": 0,
                 "gradient_step": state["gradient_step"] + 1,
                 "inner_opt_state": inner_state,
                 "acc_grads": acc, "skip_state": {}}

  return GradientTransformation(init, update)


def has_updated(state: Any) -> bool:
  """True when the update that produced `state` was applied: always for
  a state not made by `multi_steps`; for one that is, when its
  micro-step count has wrapped to 0 (optax.MultiSteps.has_updated)."""
  if isinstance(state, dict) and "mini_step" in state:
    return state["mini_step"] == 0 and state["gradient_step"] > 0
  return True


# -- learning-rate schedules -------------------------------------------------


@config.configurable
def create_constant_learning_rate(learning_rate: float = 1e-4) -> Schedule:
  return lambda count: learning_rate


def _exponential_decay(init_value: float, transition_steps: int,
                       decay_rate: float, staircase: bool) -> Schedule:
  """optax.exponential_decay (transition_begin 0, no end value), in f32."""

  def schedule(count):
    if count <= 0:
      return init_value
    p = np.float32(count) / np.float32(transition_steps)
    if staircase:
      p = np.floor(p)
    return float(np.float32(init_value)
                 * np.power(np.float32(decay_rate), np.float32(p)))

  return schedule


@config.configurable
def create_exponential_decay_learning_rate(
    initial_learning_rate: float = 1e-4,
    decay_steps: int = 10000,
    decay_rate: float = 0.9,
    staircase: bool = True) -> Schedule:
  return _exponential_decay(initial_learning_rate, decay_steps, decay_rate,
                            staircase)


@config.configurable
def create_piecewise_linear_learning_rate(
    boundaries: Any = (0, 10000),
    values: Any = (1e-3, 1e-4)) -> Schedule:
  """Piecewise-linear global-step schedule, in f32."""
  boundaries = [float(b) for b in boundaries]
  values = [float(v) for v in values]
  if len(boundaries) != len(values):
    raise ValueError("boundaries and values must have the same length.")

  def schedule(count):
    step = np.float32(count)
    out = np.float32(values[0])
    for (b0, v0), (b1, v1) in zip(zip(boundaries[:-1], values[:-1]),
                                  zip(boundaries[1:], values[1:])):
      frac = np.clip((step - np.float32(b0))
                     / np.float32(max(b1 - b0, 1e-8)), 0.0, 1.0)
      if step >= b0:
        out = np.float32(v0) + np.float32(frac) * np.float32(v1 - v0)
    if step >= boundaries[-1]:
      out = np.float32(values[-1])
    return float(out)

  return schedule


def _resolve_lr(learning_rate) -> Any:
  if callable(learning_rate) or isinstance(learning_rate, (int, float)):
    return learning_rate
  raise ValueError(f"Bad learning_rate {learning_rate!r}")


# -- optimizers --------------------------------------------------------------


def _adam(learning_rate, b1, b2, eps) -> GradientTransformation:
  return chain(_scale_by_adam(b1, b2, eps),
               _scale_by_learning_rate(learning_rate))


def _sgd(learning_rate, momentum: Optional[float] = None,
         nesterov: bool = False) -> GradientTransformation:
  return chain(_trace(momentum, nesterov) if momentum is not None
               else _identity(), _scale_by_learning_rate(learning_rate))


def _rmsprop(learning_rate, decay, eps, momentum) -> GradientTransformation:
  return chain(_scale_by_rms(decay, eps),
               _scale_by_learning_rate(learning_rate),
               _trace(momentum, False) if momentum is not None
               else _identity())


def _finish(tx: GradientTransformation,
            gradient_clip_norm: Optional[float]) -> GradientTransformation:
  if gradient_clip_norm:
    return chain(_clip_by_global_norm(gradient_clip_norm), tx)
  return tx


@config.configurable
def create_adam_optimizer(learning_rate: Any = 1e-4,
                          b1: float = 0.9,
                          b2: float = 0.999,
                          eps: float = 1e-8,
                          gradient_clip_norm: Optional[float] = None
                          ) -> GradientTransformation:
  return _finish(_adam(_resolve_lr(learning_rate), b1, b2, eps),
                 gradient_clip_norm)


@config.configurable
def create_sgd_optimizer(learning_rate: Any = 1e-4,
                         gradient_clip_norm: Optional[float] = None
                         ) -> GradientTransformation:
  return _finish(_sgd(_resolve_lr(learning_rate)), gradient_clip_norm)


@config.configurable
def create_momentum_optimizer(learning_rate: Any = 1e-4,
                              momentum: float = 0.9,
                              use_nesterov: bool = False,
                              gradient_clip_norm: Optional[float] = None
                              ) -> GradientTransformation:
  return _finish(_sgd(_resolve_lr(learning_rate), momentum, use_nesterov),
                 gradient_clip_norm)


@config.configurable
def create_rms_prop_optimizer(learning_rate: Any = 1e-4,
                              decay: float = 0.9,
                              momentum: float = 0.9,
                              eps: float = 1.0,
                              gradient_clip_norm: Optional[float] = None
                              ) -> GradientTransformation:
  return _finish(_rmsprop(_resolve_lr(learning_rate), decay, eps, momentum),
                 gradient_clip_norm)


# -- QT-Opt HParams surface --------------------------------------------------

DEFAULT_QTOPT_HPARAMS = {
    "batch_size": 32,
    "examples_per_epoch": 3_000_000,
    "learning_rate": 1e-4,
    "learning_rate_decay_factor": 0.999,
    "model_weights_averaging": 0.9999,
    "momentum": 0.9,
    "num_epochs_per_decay": 2.0,
    "optimizer": "momentum",  # 'momentum' | 'rmsprop' | 'adam'
    "rmsprop_decay": 0.9,
    "rmsprop_epsilon": 1.0,
    "adam_beta2": 0.999,
    "adam_epsilon": 1e-8,
    "use_avg_model_params": True,
}


@config.configurable
def create_optimizer_from_hparams(hparams: Optional[dict] = None,
                                  **overrides) -> GradientTransformation:
  """The QT-Opt HParams surface: exponential-decay learning rate from
  epochs-per-decay (staircase), then momentum, rmsprop or adam.
  `model_weights_averaging` maps to the model's `ema_decay`, not to this
  transformation."""
  h = dict(DEFAULT_QTOPT_HPARAMS)
  h.update(hparams or {})
  h.update(overrides)
  decay_steps = max(1, int(h["examples_per_epoch"] / h["batch_size"]
                           * h["num_epochs_per_decay"]))
  learning_rate = _exponential_decay(h["learning_rate"], decay_steps,
                                     h["learning_rate_decay_factor"], True)
  if h["optimizer"] == "momentum":
    return _sgd(learning_rate, momentum=h["momentum"])
  if h["optimizer"] == "rmsprop":
    return _rmsprop(learning_rate, h["rmsprop_decay"], h["rmsprop_epsilon"],
                    h["momentum"])
  if h["optimizer"] == "adam":
    return _adam(learning_rate, h["momentum"], h["adam_beta2"],
                 h["adam_epsilon"])
  raise ValueError(f"Unknown optimizer {h['optimizer']!r}")
