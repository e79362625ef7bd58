"""The port's FiLM-ResNet against the JAX package's, on the CPU.

`layers/film_resnet.py`: v1 and v2, size 18 (basic blocks) and size 50
(bottleneck blocks) at image 32, with and without FiLM conditioning, in
train and eval mode. flax's parameters and `batch_stats` are carried
across by `bridge.py` (the parameter and buffer names must match exactly,
so a projection shortcut or a FiLM dense in the wrong place fails); the
outputs, every endpoint and the updated running statistics are compared.

Tolerances, of max(1, max |ref|):
* float64 (both sides, JAX under `jax.enable_x64`): 1e-10;
* float32, eval mode: 1e-5;
* float32, train mode: batch norm over 4 rows at 1x1 (the last stage at
  image 32) amplifies rounding ~1e4 times, so the port's float32 error
  against the float64 reference is held to 4x JAX's own float32 error
  against it (and 1e-5 where that is smaller);
* bfloat16 eval forward: max(1e-2, 4x JAX's bf16 distance from its f32
  forward).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensor2robot_tpu.layers import film_resnet as jax_film_resnet
from tensor2robot_tpu_torch import bridge
from tensor2robot_tpu_torch.layers import film_resnet
from tests.torch_model_parity import scaled_err as _scaled_err

torch.set_num_threads(1)

F64_TOL = 1e-10
F32_TOL = 1e-5
BF16_FLOOR = 1e-2
BF16_FACTOR = 4.0
F32_TRAIN_FACTOR = 4.0
IMAGE = 32
BATCH = 4
COND = 5
CASES = [(18, 1), (18, 2), (50, 1), (50, 2)]


@functools.lru_cache(maxsize=None)
def _reference(size: int, version: int, conditioned: bool):
  """(flax module, f32 variables, images, conditioning or None)."""
  rng = np.random.RandomState(size + version)
  images = rng.rand(BATCH, IMAGE, IMAGE, 3)
  cond = rng.randn(BATCH, COND) if conditioned else None
  module = jax_film_resnet.ResNet(resnet_size=size, version=version)
  args = [jnp.asarray(images, jnp.float32)]
  if conditioned:
    args.append(jnp.asarray(cond, jnp.float32))
  variables = jax.tree_util.tree_map(
      np.asarray, module.init(jax.random.PRNGKey(size), *args))
  return module, variables, images, cond


def _flat_stats(tree, path=()) -> dict:
  """flax batch_stats under the port's buffer names, in their own dtype
  (the bridge rounds to float32)."""
  if set(tree) == {"mean", "var"}:
    return {".".join(path) + f".running_{k}": np.asarray(tree[k])
            for k in ("mean", "var")}
  out = {}
  for key, value in tree.items():
    out.update(_flat_stats(value, path + (key,)))
  return out


def _jax_apply(module, variables, images, cond, train, dtype):
  args = [jnp.asarray(images, dtype)]
  if cond is not None:
    args.append(jnp.asarray(cond, dtype))
  variables = jax.tree_util.tree_map(lambda a: jnp.asarray(a, dtype),
                                     variables)
  if dtype != jnp.float32:  # float64: the stats too; bf16: f32 stats
    variables["batch_stats"] = jax.tree_util.tree_map(
        lambda a: jnp.asarray(a, jnp.promote_types(dtype, jnp.float32)),
        variables["batch_stats"])
  if train:
    (out, endpoints), new = module.apply(variables, *args, train=True,
                                         mutable=["batch_stats"])
    stats = _flat_stats(new["batch_stats"])
  else:
    out, endpoints = module.apply(variables, *args, train=False)
    stats = {}
  return out, endpoints, stats


def _port(size, version, conditioned, variables, dtype=None):
  port = film_resnet.ResNet(3, size, version=version,
                            condition_size=COND if conditioned else 0,
                            dtype=dtype)
  params = bridge.state_dict_from_flax(variables["params"])
  buffers = bridge.mutable_state_from_flax(variables["batch_stats"])
  assert set(params) == set(dict(port.named_parameters()))
  assert set(buffers) == set(dict(port.named_buffers()))
  return port, params, buffers


def _port_apply(port, params, buffers, images, cond, train, dtype):
  buffer_dtype = torch.promote_types(dtype, torch.float32)
  variables = {**{k: v.to(dtype) for k, v in params.items()},
               **{k: v.to(buffer_dtype) for k, v in buffers.items()}}
  return torch.func.functional_call(
      port, variables, (torch.from_numpy(images).to(dtype),),
      {"conditioning": None if cond is None
       else torch.from_numpy(cond).to(dtype), "train": train})


def _run_both(size, version, conditioned, train, jdtype, tdtype):
  module, variables, images, cond = _reference(size, version, conditioned)
  with jax.enable_x64(jdtype == jnp.float64):
    want = _jax_apply(module, variables, images, cond, train, jdtype)
  port, params, buffers = _port(size, version, conditioned, variables)
  got = _port_apply(port, params, buffers, images, cond, train, tdtype)
  return got, want


def _errors(got, want) -> dict:
  (out, endpoints, stats), (w_out, w_endpoints, w_stats) = got, want
  assert set(endpoints) == set(w_endpoints) == {
      "block_layer1", "block_layer2", "block_layer3", "block_layer4",
      "final_reduce_mean"}
  assert set(stats) == set(w_stats)
  errs = {"out": _scaled_err(out, w_out)}
  errs.update({k: _scaled_err(endpoints[k], w_endpoints[k])
               for k in endpoints})
  errs.update({k: _scaled_err(stats[k], w_stats[k]) for k in stats})
  return errs


@pytest.mark.parametrize("size,version", CASES)
@pytest.mark.parametrize("conditioned", [False, True])
@pytest.mark.parametrize("train", [False, True])
def test_float64_forward_and_batch_stats(size, version, conditioned, train):
  got, want = _run_both(size, version, conditioned, train, jnp.float64,
                        torch.float64)
  assert got[0].dtype == torch.float64
  errs = _errors(got, want)
  assert bool(got[2]) == train
  assert max(errs.values()) <= F64_TOL, errs


@pytest.mark.parametrize("size,version", CASES)
def test_float32_eval_forward(size, version):
  got, want = _run_both(size, version, True, False, jnp.float32,
                        torch.float32)
  errs = _errors(got, want)
  assert max(errs.values()) <= F32_TOL, errs


@pytest.mark.parametrize("size,version", [(18, 1), (50, 2)])
def test_float32_train_forward_within_jax_rounding(size, version):
  exact = _run_both(size, version, True, True, jnp.float64, torch.float64)[1]
  got, jax32 = _run_both(size, version, True, True, jnp.float32,
                         torch.float32)
  port_errs, jax_errs = _errors(got, exact), _errors(jax32, exact)
  for key, err in port_errs.items():
    assert err <= max(F32_TOL, F32_TRAIN_FACTOR * jax_errs[key]), (
        key, err, jax_errs[key])


def test_bfloat16_eval_forward():
  module, variables, images, cond = _reference(18, 1, True)
  jax32, _, _ = _jax_apply(module, variables, images, cond, False,
                           jnp.float32)
  bf16_module = jax_film_resnet.ResNet(resnet_size=18, dtype=jnp.bfloat16)
  jax16, _, _ = _jax_apply(bf16_module, variables, images, cond, False,
                           jnp.bfloat16)
  assert jax16.dtype == jnp.bfloat16
  jax_own = _scaled_err(jax16, jax32)
  port, params, buffers = _port(18, 1, True, variables, torch.bfloat16)
  out, endpoints, _ = _port_apply(port, params, buffers, images, cond, False,
                                  torch.bfloat16)
  assert out.dtype == torch.bfloat16
  assert endpoints["block_layer2"].dtype == torch.bfloat16
  assert _scaled_err(out, jax32) <= max(BF16_FLOOR, BF16_FACTOR * jax_own)


def test_film_widths_and_projections():
  v1 = film_resnet.ResNet(3, 50, condition_size=COND)
  v2 = film_resnet.ResNet(3, 50, condition_size=COND, version=2)
  assert v1.film_generator.film_l0_b0.out_features == 2 * 4 * 64
  assert v2.film_generator.film_l0_b0.out_features == 2 * 64
  basic = film_resnet.ResNet(3, 18)
  assert basic.film_generator is None
  # Basic blocks project where the channels or the stride change.
  assert not basic.layer1_block0.has_proj
  assert basic.layer2_block0.has_proj and not basic.layer2_block1.has_proj
  assert v1.layer1_block0.has_proj and not v1.layer1_block1.has_proj
  with pytest.raises(ValueError, match="condition_size=0"):
    basic(torch.zeros(1, 32, 32, 3), torch.zeros(1, COND))
  with pytest.raises(ValueError, match="resnet_size"):
    film_resnet.ResNet(3, 19)
