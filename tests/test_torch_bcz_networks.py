"""The port's SNAIL and BC-Z network blocks against the JAX package's, on
the CPU.

`layers/snail.py` (`CausalConv`, `DenseBlock`, `TCBlock`,
`AttentionBlock`) and `layers/bcz_networks.py` (`SnailEncoder`,
`ConvGRUEncoder` with flax's `GRUCell` carried across by `bridge.py`,
`MultiHeadMLP`): flax init, the same numpy inputs, outputs and input
gradients compared. Parameters are drawn again at random where flax
initialises them to zero (biases), so a bias in the wrong place shows.

Tolerances, of max(1, max |ref|): float64 1e-10 (JAX under
`jax.enable_x64`; the attention block's softmax runs in float32 on both
sides, and flax's GRU scan refuses float64, so blocks holding them are
checked in float32 only); float32
outputs 1e-5; gradients 1e-4 x max(1, max |g|); bfloat16 forward max(1e-2,
4x JAX's bf16 distance from its f32 forward).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensor2robot_tpu.layers import bcz_networks as jax_bcz_networks
from tensor2robot_tpu.layers import snail as jax_snail
from tensor2robot_tpu_torch import bridge
from tensor2robot_tpu_torch.layers import bcz_networks
from tensor2robot_tpu_torch.layers import snail
from tests.torch_model_parity import randomized as _randomized
from tests.torch_model_parity import scaled_err as _err

torch.set_num_threads(1)

F64_TOL = 1e-10
F32_TOL = 1e-5
GRAD_TOL = 1e-4
BF16_FLOOR = 1e-2
BF16_FACTOR = 4.0


def _init(module, x, seed=0, **kwargs):
  variables = module.init(jax.random.PRNGKey(seed), jnp.asarray(x), **kwargs)
  return _randomized(jax.tree_util.tree_map(np.asarray,
                                            variables["params"]), seed + 1)


def _both(jax_module, port_module, params, x, dtype=np.float32,
          port_output=lambda out: out, **kwargs):
  """(port output, JAX output, port input grad, JAX input grad) of the sum
  of squares, in `dtype`; `port_output` picks the output from what the
  port's module returns."""
  tdtype = torch.float64 if dtype == np.float64 else torch.float32
  with jax.enable_x64(dtype == np.float64):
    jparams = jax.tree_util.tree_map(lambda a: jnp.asarray(a, dtype), params)
    fn = lambda inp: jax_module.apply({"params": jparams}, inp, **kwargs)
    jx = jnp.asarray(x, dtype)
    want = np.asarray(fn(jx))
    want_grad = np.asarray(jax.grad(lambda inp: (fn(inp) ** 2).sum())(jx))
  state = {k: v.to(tdtype) for k, v in
           bridge.state_dict_from_flax(params).items()}
  assert set(state) == set(dict(port_module.named_parameters()))
  tx = torch.tensor(np.asarray(x), dtype=tdtype, requires_grad=True)
  got = port_output(torch.func.functional_call(port_module, state, (tx,),
                                               kwargs))
  (got_grad,) = torch.autograd.grad((got ** 2).sum(), tx)
  return got, want, got_grad, want_grad


def _check(got, want, got_grad, want_grad, tol):
  assert _err(got, want) <= tol
  grad_tol = tol if tol == F64_TOL else GRAD_TOL
  assert _err(got_grad, want_grad) <= grad_tol


def _sequence(seed=0, b=3, t=7, c=5):
  return np.random.RandomState(seed).randn(b, t, c)


@pytest.mark.parametrize("dtype,tol", [(np.float64, F64_TOL),
                                       (np.float32, F32_TOL)])
@pytest.mark.parametrize("dilation", [1, 3])
def test_causal_conv(dtype, tol, dilation):
  x = _sequence()
  module = jax_snail.CausalConv(4, kernel_size=2, dilation=dilation)
  params = _init(module, x)
  assert params["conv"]["kernel"].shape == (2, 5, 4)  # flax [k, in, out]
  port = snail.CausalConv(5, 4, kernel_size=2, dilation=dilation)
  got, want, *grads = _both(module, port, params, x, dtype)
  _check(got, want, *grads, tol)
  # Causal: the first `dilation` outputs see only the left padding and
  # their own step.
  x2 = x.copy()
  x2[:, 4:] += 1.0
  later, *_ = _both(module, port, params, x2, dtype)
  np.testing.assert_array_equal(later[:, :4].detach().numpy(),
                                got[:, :4].detach().numpy())


@pytest.mark.parametrize("dtype,tol", [(np.float64, F64_TOL),
                                       (np.float32, F32_TOL)])
@pytest.mark.parametrize("seq_len", [1, 7, 8])
def test_tc_block(dtype, tol, seq_len):
  x = _sequence(1, t=seq_len)
  module = jax_snail.TCBlock(sequence_length=seq_len, filters=3)
  params = _init(module, x)
  port = snail.TCBlock(5, seq_len, 3)
  assert port.num_blocks == max(1, int(np.ceil(np.log2(seq_len))))
  assert len(params) == port.num_blocks
  got, want, *grads = _both(module, port, params, x, dtype)
  assert got.shape == (3, seq_len, 5 + 3 * port.num_blocks)
  _check(got, want, *grads, tol)


def test_attention_block():
  x = _sequence(2)
  module = jax_snail.AttentionBlock(key_size=4, value_size=6)
  params = _init(module, x)
  port = snail.AttentionBlock(5, 4, 6)
  got, want, *grads = _both(module, port, params, x)
  assert got.shape == (3, 7, 11)
  _check(got, want, *grads, F32_TOL)
  # Causal: step 3's read ignores every later step.
  x2 = x.copy()
  x2[:, 4:] *= -2.0
  later, *_ = _both(module, port, params, x2)
  np.testing.assert_allclose(later[:, :4].detach().numpy(),
                             got[:, :4].detach().numpy(), atol=1e-6)


def test_attention_block_bfloat16():
  x = _sequence(3)
  params = _init(jax_snail.AttentionBlock(key_size=4, value_size=6), x)
  jax32 = jax_snail.AttentionBlock(key_size=4, value_size=6).apply(
      {"params": params}, jnp.asarray(x, jnp.float32))
  jax16 = jax_snail.AttentionBlock(
      key_size=4, value_size=6, dtype=jnp.bfloat16).apply(
          {"params": jax.tree_util.tree_map(
              lambda a: jnp.asarray(a, jnp.bfloat16), params)},
          jnp.asarray(x, jnp.bfloat16))
  port = snail.AttentionBlock(5, 4, 6, dtype=torch.bfloat16)
  state = {k: v.to(torch.bfloat16) for k, v in
           bridge.state_dict_from_flax(params).items()}
  got = torch.func.functional_call(
      port, state, (torch.tensor(x, dtype=torch.bfloat16),))
  assert got.dtype == torch.bfloat16
  assert _err(got, jax32) <= max(BF16_FLOOR, BF16_FACTOR * _err(jax16, jax32))


def test_snail_encoder():
  x = _sequence(4, t=6, c=4)
  module = jax_bcz_networks.SnailEncoder(sequence_length=6, filters=3,
                                         key_size=4, value_size=5)
  params = _init(module, x)
  port = bcz_networks.SnailEncoder(4, 6, filters=3, key_size=4, value_size=5)
  got, want, *grads = _both(module, port, params, x)
  assert got.shape[-1] == port.out_features
  _check(got, want, *grads, F32_TOL)


def _frames(seed=5, b=2, t=3, size=12):
  return np.random.RandomState(seed).rand(b, t, size, size, 3)


def test_conv_gru_encoder():
  # float32 only: flax's scan refuses the float64 run (the GRU's carry
  # starts as float32 zeros and comes back float64).
  frames = _frames()
  module = jax_bcz_networks.ConvGRUEncoder(hidden_size=6, filters=(4, 3))
  variables = module.init(jax.random.PRNGKey(0),
                          jnp.asarray(frames, jnp.float32))
  assert set(variables["params"]) == {"torso", "GRUCell_0"}
  params = _randomized(jax.tree_util.tree_map(np.asarray,
                                              variables["params"]), 7)
  port = bcz_networks.ConvGRUEncoder(3, hidden_size=6, filters=(4, 3))
  states = []
  got, want, *grads = _both(module, port, params, frames,
                            port_output=lambda out: states.append(out[1])
                            or out[0])
  assert got.shape == (2, 3, 6) and states == [{}]
  _check(got, want, *grads, F32_TOL)


def test_gru_bridge_layout():
  params = {"ir": {"kernel": np.full((2, 3), 1.0), "bias": np.full(3, 4.0)},
            "iz": {"kernel": np.full((2, 3), 2.0), "bias": np.full(3, 5.0)},
            "in": {"kernel": np.full((2, 3), 3.0), "bias": np.full(3, 6.0)},
            "hr": {"kernel": np.full((3, 3), 7.0)},
            "hz": {"kernel": np.full((3, 3), 8.0)},
            "hn": {"kernel": np.full((3, 3), 9.0), "bias": np.full(3, 10.0)}}
  state = bridge.state_dict_from_flax({"cell": params})
  assert set(state) == {"cell.weight_ih", "cell.bias_ih", "cell.weight_hh",
                        "cell.bias_hn"}
  assert state["cell.weight_ih"].shape == (9, 2)
  assert state["cell.weight_ih"][:, 0].tolist() == [1.0] * 3 + [2.0] * 3 + [
      3.0] * 3
  assert state["cell.bias_ih"].tolist() == [4.0] * 3 + [5.0] * 3 + [6.0] * 3
  assert state["cell.weight_hh"][:, 0].tolist() == [7.0] * 3 + [8.0] * 3 + [
      9.0] * 3
  assert state["cell.bias_hn"].tolist() == [10.0] * 3


def test_gru_init_is_flax_s():
  cell = bcz_networks.GRUCell(5, 4)
  init = cell.initial_params(torch.Generator().manual_seed(0))
  assert set(init) == {"weight_ih", "bias_ih", "weight_hh", "bias_hn"}
  for gate in init["weight_hh"].chunk(3):  # orthogonal per gate
    np.testing.assert_allclose((gate @ gate.T).numpy(), np.eye(4), atol=1e-5)
  assert not init["bias_ih"].any() and not init["bias_hn"].any()


@pytest.mark.parametrize("stop_gradient_future", [True, False])
def test_multi_head_mlp(stop_gradient_future):
  feats = np.random.RandomState(6).randn(3, 5)
  module = jax_bcz_networks.MultiHeadMLP(
      num_waypoints=3, action_size=2, hidden_sizes=(4, 4),
      stop_gradient_future=stop_gradient_future)
  params = _init(module, feats)
  port = bcz_networks.MultiHeadMLP(5, 3, 2, hidden_sizes=(4, 4),
                                   stop_gradient_future=stop_gradient_future)
  got, want, *grads = _both(module, port, params, feats)
  assert got.shape == (3, 3, 2)
  _check(got, want, *grads, F32_TOL)


def test_future_heads_put_no_gradient_into_the_features():
  port = bcz_networks.MultiHeadMLP(5, 3, 2, hidden_sizes=(4,))
  feats = torch.randn(2, 5, generator=torch.Generator().manual_seed(0),
                      requires_grad=True)
  out = port(feats)
  for w in (1, 2):
    (grad,) = torch.autograd.grad(out[:, w].sum(), feats,
                                  retain_graph=True)
    assert not grad.any()
  (grad,) = torch.autograd.grad(out[:, 0].sum(), feats)
  assert grad.abs().sum() > 0
