"""Carries JAX (flax) parameters into the port.

`state_dict_from_flax` takes a flax param tree as nested dicts of arrays
(numpy, or anything `np.asarray` reads) and returns the port's flat
`state_dict`, named by joining the flax module path with '.':

* Dense: `kernel [in, out]` -> `weight [out, in]`; `bias` as is;
* LayerNorm: `scale` / `bias` -> `weight` / `bias`. The port's LayerNorms
  use flax's eps, 1e-6, not torch's 1e-5.

So `{"attn_0": {"q_proj": {"kernel", "bias"}}}` becomes
`attn_0.q_proj.weight` / `attn_0.q_proj.bias`. A leaf this mapping does
not know raises. Conv, BatchNorm and LSTM layouts come with the slices
that port those layers.

`train_state_from_jax` carries a whole JAX `TrainState` across — step,
params, optax state and EMA — so a JAX run can continue in the port. The
optax state is read by duck typing (no optax import): a NamedTuple
becomes a dict of its fields (`count` as an int, param-shaped moments
through `state_dict_from_flax`), EmptyState `{}`, a chain's tuple a
tuple — the layout of `models.optimizers`.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from tensor2robot_tpu_torch.parallel import train_step as ts

__all__ = ["state_dict_from_flax", "bridge_train_state",
           "optimizer_state_from_optax", "train_state_from_jax"]


def state_dict_from_flax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
  """A flax param tree as the port's flat f32 `state_dict`."""
  out: Dict[str, torch.Tensor] = {}

  def visit(tree: Mapping[str, Any], path: Tuple[str, ...]) -> None:
    leaves = {k: v for k, v in tree.items() if not isinstance(v, Mapping)}
    for key, value in tree.items():
      if isinstance(value, Mapping):
        visit(value, path + (key,))
    if not leaves:
      return
    name = ".".join(path)
    if set(leaves) == {"kernel", "bias"}:
      kernel = np.asarray(leaves["kernel"], np.float32)
      if kernel.ndim != 2:
        raise ValueError(f"{name}: only Dense kernels [in, out] are "
                         f"bridged, got shape {kernel.shape}")
      out[f"{name}.weight"] = torch.from_numpy(kernel.T.copy())
      out[f"{name}.bias"] = torch.from_numpy(
          np.asarray(leaves["bias"], np.float32).copy())
    elif set(leaves) == {"scale", "bias"}:
      out[f"{name}.weight"] = torch.from_numpy(
          np.asarray(leaves["scale"], np.float32).copy())
      out[f"{name}.bias"] = torch.from_numpy(
          np.asarray(leaves["bias"], np.float32).copy())
    else:
      raise ValueError(f"{name}: no bridge for a flax module with params "
                       f"{sorted(leaves)}")

  visit(params, ())
  return out


def bridge_train_state(params: Mapping[str, Any],
                       ema_params: Optional[Mapping[str, Any]] = None
                       ) -> Tuple[Dict[str, torch.Tensor],
                                  Optional[Dict[str, torch.Tensor]]]:
  """(params, ema_params) of a JAX TrainState as port `state_dict`s, for
  `CheckpointPredictor.load_params`."""
  return (state_dict_from_flax(params),
          None if ema_params is None else state_dict_from_flax(ema_params))


def _numpy_tree(tree: Any) -> Any:
  if isinstance(tree, Mapping):
    return {k: _numpy_tree(v) for k, v in tree.items()}
  return np.asarray(tree)


def optimizer_state_from_optax(state: Any) -> Any:
  """An optax optimizer state (NamedTuples inside chain tuples, leaves
  arrays) in the layout of `models.optimizers`. Raises on a field this
  mapping does not know."""
  if hasattr(state, "_fields"):  # an optax state NamedTuple
    out = {}
    for field in state._fields:
      value = getattr(state, field)
      if field == "count":
        out[field] = int(np.asarray(value))
      elif field in ("mu", "nu", "trace"):
        out[field] = state_dict_from_flax(_numpy_tree(value))
      else:
        raise ValueError(f"no bridge for optax state field {field!r} of "
                         f"{type(state).__name__}")
    return out
  if isinstance(state, (tuple, list)):
    return tuple(optimizer_state_from_optax(s) for s in state)
  raise ValueError(f"no bridge for optax state {type(state).__name__}")


def train_state_from_jax(state: Any) -> ts.TrainState:
  """A JAX `TrainState` (step, params, opt_state, ema_params; flax
  mutable collections must be empty) as the port's, on the CPU: move it
  with `TrainState.to(device)`."""
  if getattr(state, "mutable_state", None):
    raise ValueError("no bridge for flax mutable collections "
                     f"{sorted(state.mutable_state)}")
  ema = getattr(state, "ema_params", None)
  return ts.TrainState(
      step=int(np.asarray(state.step)),
      params=state_dict_from_flax(_numpy_tree(state.params)),
      ema_params=None if ema is None else state_dict_from_flax(
          _numpy_tree(ema)),
      opt_state=optimizer_state_from_optax(state.opt_state))
