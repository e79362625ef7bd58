"""Carries JAX (flax) parameters into the port.

`state_dict_from_flax` takes a flax param tree as nested dicts of arrays
(numpy, or anything `np.asarray` reads) and returns the port's flat
`state_dict`, named by joining the flax module path with '.':

* Dense: `kernel [in, out]` -> `weight [out, in]`; `bias` as is (a
  Dense or Conv with `use_bias=False` has a kernel only);
* Conv: `kernel [kh, kw, in, out]` (HWIO) -> `weight [out, in, kh, kw]`
  (OIHW);
* LayerNorm and BatchNorm: `scale` / `bias` -> `weight` / `bias` (a
  BatchNorm with `use_scale=False` has a bias only). The port's
  LayerNorms use flax's eps, 1e-6, not torch's 1e-5.

* 1-D Conv (snail's causal convs, TEC's temporal convs): `kernel [k,
  in, out]` -> `weight [out, in, k]`;
* `nn.Embed`: `embedding [num, features]` -> `weight` as is;
* `nn.GRUCell`: the input denses `ir`, `iz`, `in` (kernels [in, H] and
  biases) -> `weight_ih` [3H, in] and `bias_ih` [3H], the transposed
  kernels and the biases stacked in the gate order r, z, n; the recurrent
  denses `hr`, `hz`, `hn` ([H, H], only `hn` with a bias) -> `weight_hh`
  [3H, H] and `bias_hn` [H] (`layers.bcz_networks.GRUCell`);
* `nn.OptimizedLSTMCell`: the input kernels `ii`, `if`, `ig`, `io`
  ([in, H], no bias) and the hidden kernels `hi`, `hf`, `hg`, `ho` ([H,
  H], with biases) -> `weight_ih` [4H, in] and `weight_hh` [4H, H], the
  transposed kernels stacked by rows in the gate order i, f, g, o that
  torch's LSTM uses, and `bias_hh` [4H], the hidden biases in that order
  (the port's cell has no input bias).

* a module's own array parameters `bias_transform` (`PoseHead`),
  `log_temperature` (`SpatialSoftmax`) and MADE's `w1`, `b1`, `w_shift`,
  `w_scale`, `b_shift`, `b_scale` (`research/vrgripper/maf.py`, used as
  `x @ (w * mask)`) keep their names and shapes, untransposed;
* so do the stacked pipeline and expert leaves: the pipelined trunk's
  `stages_w1`, `stages_b1`, `stages_w2`, `stages_b2` ([S, h, h] and [S,
  h], flax's [in, out] matrices, in whichever layout the stack holds:
  depth order, or the interleaved order of v > 1), the heterogeneous
  towers' raveled `pp_stages` ([S * v, P_max], each stage's flax tree
  raveled with HWIO kernels; the stage functions permute inside), and
  the mixture of experts' `experts_w1`, `experts_b1`, `experts_w2`,
  `experts_b2` ([E, in, h], [E, 1, h], [E, h, out], [E, 1, out]);
* MAML with learned inner learning rates (`{"base": params, "inner_lr":
  tree}`): the base tree maps as above under `base.`, and each scalar
  rate of the mirror tree maps to the name its parameter has, under
  `inner_lr.` (`inner_lr.torso.conv_0.weight` for the kernel of
  `torso/conv_0`).

So `{"attn_0": {"q_proj": {"kernel", "bias"}}}` becomes
`attn_0.q_proj.weight` / `attn_0.q_proj.bias`. A leaf this mapping does
not know raises.
`mutable_state_from_flax` maps flax's `batch_stats` (`mean` / `var` per
BatchNorm) onto the port's mutable state, `<name>.running_mean` /
`<name>.running_var` (under a `prefix`, e.g. `base` for a MAML model
with learned inner rates, whose module nests the base's buffers).

`train_state_from_jax` carries a whole JAX `TrainState` across — step,
params, optax state, EMA and batch_stats — so a JAX run can continue in
the port. The optax state is read by duck typing (no optax import): a
NamedTuple becomes a dict of its fields (`count` as an int, param-shaped
moments through `state_dict_from_flax`, a masked transformation's
`inner_state` recursively), EmptyState `{}`, a chain's tuple a tuple —
the layout of `models.optimizers`; `optax.MultiStepsState` keeps its
fields (`mini_step` and `gradient_step` as ints, `acc_grads` through
`state_dict_from_flax`, `inner_opt_state` recursively, an empty
`skip_state` as `{}`).

`train_state_on_mesh` places a port state (e.g. a bridged one) on a
mesh: this rank's blocks by `state_shardings`, on the mesh's device;
`state_to_numpy` gathers a sharded state back to numpy trees for a
comparison with the JAX package's.

`export_variables_from_jax` carries a JAX export bundle's variables
(`{"params", "mutable"}` as numpy trees, read on the JAX side) into the
port's eval parameters and batch-norm buffers, the `variables.pt` layout
of the port's own bundles.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from tensor2robot_tpu_torch.parallel import train_step as ts

__all__ = ["LSTM_GATES", "GRU_GATES", "state_dict_from_flax", "mutable_state_from_flax",
           "bridge_train_state", "optimizer_state_from_optax",
           "train_state_from_jax", "export_variables_from_jax",
           "train_state_on_mesh", "state_to_numpy"]


LSTM_GATES = ("i", "f", "g", "o")
GRU_GATES = ("r", "z", "n")
# Array parameters a module owns directly, carried as they are (MADE's
# masked matrices keep their [in, out] layout).
RAW_LEAVES = ("bias_transform", "log_temperature", "w1", "b1", "w_shift",
              "w_scale", "b_shift", "b_scale", "stages_w1", "stages_b1",
              "stages_w2", "stages_b2", "pp_stages", "experts_w1",
              "experts_b1", "experts_w2", "experts_b2")
# flax leaf name -> the port's, for a MAML inner-rate mirror tree.
_MIRROR_NAMES = {"kernel": "weight", "scale": "weight", "bias": "bias",
                 **{leaf: leaf for leaf in RAW_LEAVES}}


def _lstm_cell(tree: Mapping[str, Any], name: str
               ) -> Dict[str, torch.Tensor]:
  """An OptimizedLSTMCell's eight Dense params as the port's cell."""

  def stacked(prefix: str, leaf: str, transpose: bool):
    parts = [np.asarray(tree[prefix + gate][leaf], np.float32)
             for gate in LSTM_GATES]
    return torch.from_numpy(np.concatenate(
        [p.T if transpose else p for p in parts], axis=0).copy())

  return {f"{name}.weight_ih": stacked("i", "kernel", True),
          f"{name}.weight_hh": stacked("h", "kernel", True),
          f"{name}.bias_hh": stacked("h", "bias", False)}


def _is_lstm_cell(tree: Mapping[str, Any]) -> bool:
  return set(tree) == {p + g for p in "ih" for g in LSTM_GATES}


def _gru_cell(tree: Mapping[str, Any], name: str
              ) -> Dict[str, torch.Tensor]:
  """A GRUCell's six Dense params as the port's cell."""

  def stacked(prefix: str, leaf: str, transpose: bool):
    parts = [np.asarray(tree[prefix + gate][leaf], np.float32)
             for gate in GRU_GATES]
    return torch.from_numpy(np.concatenate(
        [p.T if transpose else p for p in parts], axis=0).copy())

  return {f"{name}.weight_ih": stacked("i", "kernel", True),
          f"{name}.bias_ih": stacked("i", "bias", False),
          f"{name}.weight_hh": stacked("h", "kernel", True),
          f"{name}.bias_hn": _tensor(tree["hn"]["bias"])}


def _is_gru_cell(tree: Mapping[str, Any]) -> bool:
  return set(tree) == {p + g for p in "ih" for g in GRU_GATES}


def _tensor(value: Any) -> torch.Tensor:
  return torch.from_numpy(np.array(value, np.float32))


def _inner_rates(tree: Mapping[str, Any], path: Tuple[str, ...],
                 out: Dict[str, torch.Tensor]) -> None:
  """A MAML mirror tree of scalar inner rates under the port's names."""
  if _is_lstm_cell(tree) or _is_gru_cell(tree):
    raise ValueError(f"{'.'.join(path)}: no bridge for learned inner rates "
                     "of a recurrent cell (the port stacks its gates)")
  for key, value in tree.items():
    if isinstance(value, Mapping):
      _inner_rates(value, path + (key,), out)
    elif key in _MIRROR_NAMES:
      out[".".join(path + (_MIRROR_NAMES[key],))] = _tensor(value)
    else:
      raise ValueError(f"{'.'.join(path + (key,))}: no bridge for an inner "
                       "rate of this flax leaf")


def state_dict_from_flax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
  """A flax param tree as the port's flat f32 `state_dict`."""
  out: Dict[str, torch.Tensor] = {}
  if set(params) == {"base", "inner_lr"}:  # MAML, learned inner rates
    out.update({f"base.{k}": v
                for k, v in state_dict_from_flax(params["base"]).items()})
    _inner_rates(params["inner_lr"], ("inner_lr",), out)
    return out

  def visit(tree: Mapping[str, Any], path: Tuple[str, ...]) -> None:
    if _is_lstm_cell(tree):
      out.update(_lstm_cell(tree, ".".join(path)))
      return
    if _is_gru_cell(tree):
      out.update(_gru_cell(tree, ".".join(path)))
      return
    leaves = {k: v for k, v in tree.items() if not isinstance(v, Mapping)}
    for key, value in tree.items():
      if isinstance(value, Mapping):
        visit(value, path + (key,))
    for key in RAW_LEAVES:
      if key in leaves:
        out[".".join(path + (key,))] = _tensor(leaves.pop(key))
    if not leaves:
      return
    name = ".".join(path)
    if set(leaves) in ({"kernel", "bias"}, {"kernel"}):
      kernel = np.asarray(leaves["kernel"], np.float32)
      if kernel.ndim == 2:  # Dense [in, out] -> [out, in]
        weight = kernel.T
      elif kernel.ndim == 3:  # 1-D Conv [k, in, out] -> [out, in, k]
        weight = kernel.transpose(2, 1, 0)
      elif kernel.ndim == 4:  # Conv HWIO -> OIHW
        weight = kernel.transpose(3, 2, 0, 1)
      else:
        raise ValueError(f"{name}: only Dense kernels [in, out] and Conv "
                         f"kernels [k, in, out] or [kh, kw, in, out] are "
                         f"bridged, got shape {kernel.shape}")
      out[f"{name}.weight"] = torch.from_numpy(weight.copy())
    elif set(leaves) == {"embedding"}:  # nn.Embed [num, features]
      out[f"{name}.weight"] = _tensor(leaves.pop("embedding"))
    elif set(leaves) in ({"scale", "bias"}, {"bias"}):
      if "scale" in leaves:
        out[f"{name}.weight"] = torch.from_numpy(
            np.asarray(leaves["scale"], np.float32).copy())
    else:
      raise ValueError(f"{name}: no bridge for a flax module with params "
                       f"{sorted(leaves)}")
    if "bias" in leaves:
      out[f"{name}.bias"] = torch.from_numpy(
          np.asarray(leaves["bias"], np.float32).copy())

  visit(params, ())
  return out


def mutable_state_from_flax(batch_stats: Mapping[str, Any],
                            prefix: str = "") -> Dict[str, torch.Tensor]:
  """flax `batch_stats` ({name: {"mean", "var"}}, nested by module path)
  as the port's flat f32 mutable state: `<name>.running_mean` and
  `<name>.running_var`, under `<prefix>.` when a prefix is given."""
  if prefix:
    return {f"{prefix}.{k}": v
            for k, v in mutable_state_from_flax(batch_stats).items()}
  out: Dict[str, torch.Tensor] = {}

  def visit(tree: Mapping[str, Any], path: Tuple[str, ...]) -> None:
    if set(tree) == {"mean", "var"} and not any(
        isinstance(v, Mapping) for v in tree.values()):
      name = ".".join(path)
      for field in ("mean", "var"):
        out[f"{name}.running_{field}"] = torch.from_numpy(
            np.asarray(tree[field], np.float32).copy())
      return
    for key, value in tree.items():
      if not isinstance(value, Mapping):
        raise ValueError(f"{'.'.join(path + (key,))}: no bridge for a "
                         "batch_stats leaf outside a {mean, var} pair")
      visit(value, path + (key,))

  visit(batch_stats, ())
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


def _leaves_of(tree: Any) -> list:
  if isinstance(tree, Mapping):
    return [x for v in tree.values() for x in _leaves_of(v)]
  if isinstance(tree, (tuple, list)):
    return [x for v in tree for x in _leaves_of(v)]
  return [tree]


def optimizer_state_from_optax(state: Any) -> Any:
  """An optax optimizer state (NamedTuples inside chain tuples, leaves
  arrays) in the layout of `models.optimizers`. Raises on a field this
  mapping does not know."""
  if hasattr(state, "_fields"):  # an optax state NamedTuple
    out = {}
    for field in state._fields:
      value = getattr(state, field)
      if field in ("count", "mini_step", "gradient_step"):
        out[field] = int(np.asarray(value))
      elif field in ("mu", "nu", "trace", "acc_grads"):
        out[field] = state_dict_from_flax(_numpy_tree(value))
      elif field in ("inner_state", "inner_opt_state"):
        # optax.masked; optax.MultiSteps
        out[field] = optimizer_state_from_optax(value)
      elif field == "skip_state" and not _leaves_of(value):
        out[field] = {}  # MultiSteps without a skip function
      else:
        raise ValueError(f"no bridge for optax state field {field!r} of "
                         f"{type(state).__name__}")
    return out
  if isinstance(state, (tuple, list)):
    return tuple(optimizer_state_from_optax(s) for s in state)
  raise ValueError(f"no bridge for optax state {type(state).__name__}")


def train_state_from_jax(state: Any) -> ts.TrainState:
  """A JAX `TrainState` (step, params, opt_state, ema_params, and flax
  mutable collections: `batch_stats` or none) as the port's, on the CPU:
  move it with `TrainState.to(device)`."""
  collections = dict(getattr(state, "mutable_state", None) or {})
  unknown = sorted(set(collections) - {"batch_stats"})
  if unknown:
    raise ValueError(f"no bridge for flax mutable collections {unknown}")
  ema = getattr(state, "ema_params", None)
  return ts.TrainState(
      step=int(np.asarray(state.step)),
      params=state_dict_from_flax(_numpy_tree(state.params)),
      ema_params=None if ema is None else state_dict_from_flax(
          _numpy_tree(ema)),
      opt_state=optimizer_state_from_optax(state.opt_state),
      mutable_state=mutable_state_from_flax(
          _numpy_tree(collections.get("batch_stats", {}))))


def export_variables_from_jax(variables: Mapping[str, Any]
                              ) -> Dict[str, Dict[str, torch.Tensor]]:
  """A JAX export bundle's `{"params": flax params, "mutable": flax
  mutable collections}` as the port's `{"params": state_dict, "mutable":
  batch-norm buffers}`, on the CPU."""
  collections = dict(variables.get("mutable") or {})
  unknown = sorted(set(collections) - {"batch_stats"})
  if unknown:
    raise ValueError(f"no bridge for flax mutable collections {unknown}")
  return {"params": state_dict_from_flax(_numpy_tree(variables["params"])),
          "mutable": mutable_state_from_flax(
              _numpy_tree(collections.get("batch_stats", {})))}


# A bridged state on a mesh: (this rank's blocks on the mesh's device,
# the shardings).
train_state_on_mesh = ts.place_state


def state_to_numpy(state: ts.TrainState, shardings=None) -> Dict[str, Any]:
  """The full state as numpy trees ({"step", "params", "ema_params",
  "opt_state", "mutable_state"}), gathered from every rank's blocks
  first when `shardings` are given (collective: every rank calls it)."""
  if shardings is not None:
    state = ts.gather_state(state, shardings)
  host = ts.map_tensors(lambda x: x.detach().float().cpu().numpy(),
                        {"params": state.params,
                         "ema_params": state.ema_params,
                         "opt_state": state.opt_state,
                         "mutable_state": state.mutable_state})
  return {"step": int(state.step), **host}
