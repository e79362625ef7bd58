"""Shared pieces of the parity tests of Grasp2Vec, BC-Z and their layers:
error measures, redrawn flax parameters, one train-mode loss and gradient
on each side, and the JAX trees in the port's names without the bridge's
rounding to float32.

`bridged(tree)` carries a flax tree (float64 included) across by name: the
bridge maps layout only and rounds to float32, so the tree goes across as
float32 high and low parts summed in float64 (about 2^-48 relative).
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from tensor2robot_tpu import modes as jax_modes
from tensor2robot_tpu.specs import SpecStruct as JaxSpecStruct
from tensor2robot_tpu_torch import bridge
from tensor2robot_tpu_torch.parallel import train_step as ts
from tensor2robot_tpu_torch.specs import SpecStruct


def np64(x) -> np.ndarray:
  if isinstance(x, torch.Tensor):
    return x.detach().to(torch.float64).cpu().numpy()
  return np.asarray(x).astype(np.float64)


def scaled_err(got, want) -> float:
  """max |got - want| / max(1, max |want|)."""
  got, want = np64(got), np64(want)
  assert got.shape == want.shape, (got.shape, want.shape)
  if not want.size:
    return 0.0
  return float(np.abs(got - want).max() / max(1.0, np.abs(want).max()))


def randomized(params, seed):
  """flax params with every leaf redrawn, 0.3 x N(0, 1) (zero biases
  included, so a bias in the wrong place shows)."""
  rng = np.random.RandomState(seed)
  return jax.tree_util.tree_map(
      lambda a: (0.3 * rng.randn(*np.shape(a))).astype(np.float32), params)


def _split(tree):
  hi = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)
  lo = jax.tree_util.tree_map(
      lambda a, h: (np.asarray(a, np.float64) - h).astype(np.float32),
      tree, hi)
  return hi, lo


def bridged(tree, batch_stats: bool = False):
  """A flax param (or batch_stats) tree as the port's float64 names."""
  fn = (bridge.mutable_state_from_flax if batch_stats
        else bridge.state_dict_from_flax)
  hi, lo = (fn(t) for t in _split(tree))
  return {k: hi[k].double() + lo[k].double() for k in hi}


class _WideJnp:
  """`jax.numpy` with `float32` meaning float64."""

  float32 = jnp.float64

  def __getattr__(self, name):
    return getattr(jnp, name)


def widen_float32_casts(monkeypatch, *modules):
  """Under x64, the JAX spatial softmax and MDN head still round to
  float32 (`astype(jnp.float32)`); this makes those casts float64 in
  `modules` for one test, so a float64 case holds the rest of JAX's
  float64 path to float64 precision."""
  for module in modules:
    monkeypatch.setattr(module, "jnp", _WideJnp())


def init_variables(model, features, seed: int = 0):
  """`model.init_variables` (jitted) on numpy features, as numpy."""
  features = JaxSpecStruct({k: jnp.asarray(v) for k, v in features.items()})
  variables = jax.jit(model.init_variables)(jax.random.PRNGKey(seed),
                                            features)
  return jax.tree_util.tree_map(np.asarray, dict(variables))


def cast_tree(tree, dtype):
  return jax.tree_util.tree_map(lambda a: jnp.asarray(a, dtype), tree)


def flat_outputs(outputs) -> dict:
  """JAX outputs as numpy by the port's flat keys: a NamedTuple leaf (an
  MDN head's `MDNParams`) as `<key>/<field>`."""
  out = {}
  for key, value in outputs.items():
    if hasattr(value, "_fields"):
      out.update({f"{key}/{field}": np.asarray(getattr(value, field))
                  for field in value._fields})
    else:
      out[key] = np.asarray(value)
  return out


def jax_train(model, variables, features, labels, dtype, rng=None):
  """(loss, outputs, scalars, grads, new batch_stats) of JAX's train-mode
  loss on `variables` cast to `dtype` (float64 under x64), jitted (one
  compile instead of an op-by-op trace), grads and stats in the port's
  names."""
  with jax.enable_x64(dtype == jnp.float64):
    variables = cast_tree(variables, dtype)
    if "batch_stats" in variables:
      variables["batch_stats"] = cast_tree(
          variables["batch_stats"], jnp.promote_types(dtype, jnp.float32))
    features = JaxSpecStruct({k: jnp.asarray(v) for k, v in features.items()})
    labels = JaxSpecStruct({k: jnp.asarray(v) for k, v in labels.items()})

    def loss_fn(params):
      outputs, new_state = model.inference_network_fn(
          {**variables, "params": params}, features, jax_modes.TRAIN,
          rng=rng, train=True)
      outputs = JaxSpecStruct(jax.tree_util.tree_map(
          lambda x: x.astype(jnp.float32) if x.dtype == jnp.bfloat16 else x,
          dict(outputs.items())))
      loss, scalars = model.model_train_fn(features, labels, outputs,
                                           jax_modes.TRAIN)
      return loss, (outputs, scalars, new_state)

    (loss, (outputs, scalars, new_state)), grads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(variables["params"])
    outputs = flat_outputs(outputs)
    scalars = {k: np.asarray(v) for k, v in scalars.items()}
    grads = bridged(jax.tree_util.tree_map(np.asarray, grads))
    stats = (bridged(jax.tree_util.tree_map(
        np.asarray, new_state["batch_stats"]), batch_stats=True)
             if new_state and "batch_stats" in new_state else {})
  return np.asarray(loss), outputs, scalars, grads, stats


def port_inputs(tree, dtype):
  """numpy leaves as tensors, floats cast to `dtype`."""
  out = SpecStruct()
  for key, value in tree.items():
    value = torch.from_numpy(np.array(value))
    out[key] = value.to(dtype) if value.is_floating_point() else value
  return out


def port_train(model, params, buffers, features, labels, dtype):
  """The same on the port: (loss, outputs, scalars, grads, new state)."""
  params = {k: v.to(dtype) for k, v in params.items()}
  buffers = {k: v.to(torch.promote_types(dtype, torch.float32))
             for k, v in buffers.items()}
  features, labels = port_inputs(features, dtype), port_inputs(labels, dtype)
  loss, scalars, grads, new_state = ts.loss_and_grads(
      model, params, features, labels, buffers)
  with torch.no_grad():
    outputs, _ = model.inference_network_fn(params, buffers, features,
                                            "train", train=True)
  return loss, dict(outputs.items()), scalars, grads, new_state


def compare_train(got, want, tol, grad_tol) -> dict:
  """Every error of `port_train` against `jax_train`, by name; asserts the
  names match."""
  loss, outputs, scalars, grads, state = got
  w_loss, w_outputs, w_scalars, w_grads, w_state = want
  assert set(scalars) == set(w_scalars)
  assert set(grads) == set(w_grads)
  assert set(state) == set(w_state)
  errs = {"loss": scaled_err(loss, w_loss)}
  errs.update({f"out/{k}": scaled_err(outputs[k], w_outputs[k])
               for k in w_outputs})
  errs.update({f"scalar/{k}": scaled_err(scalars[k], w_scalars[k])
               for k in w_scalars})
  errs.update({f"state/{k}": scaled_err(state[k], w_state[k])
               for k in w_state})
  bad = {k: v for k, v in errs.items() if v > tol}
  bad.update({f"grad/{k}": e for k in w_grads
              if (e := scaled_err(grads[k], w_grads[k])) > grad_tol})
  assert not bad, bad
  return errs
