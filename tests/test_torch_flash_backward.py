"""The port's flash backward against the JAX package's, on the CPU.

The same numpy q, k, v go through `flash_attention` in both packages
(the JAX one with its Pallas kernels interpreted, blocks of 16), and the
gradients of sum(out * cos(out)) — non-uniform cotangents — are compared:
through the port's `flash_forward` gradient (whose backward on a CPU
tensor is `_flash_backward_plain`), and through `flash_backward` called
on the padded operands directly. Also against torch autograd through the
plain `attention`, which is the repair of a CUDA `flash_attention` that
used to give its inputs no gradient.

Tolerances: f32 1e-5 absolute (both sides accumulate in f32; only the
summation order differs, on values of order 1); bf16 3e-2 relative to
max|ref| (8-bit mantissas on the inputs and the outputs), and 1e-2 on the
relative 2-norm |got - want| / |want|, which a gradient wrong for part of
its rows or keys would not pass. Sound bf16 readings: at most 7.5e-3 of
max|ref| and 4.0e-3 on the norm.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensor2robot_tpu.ops import attention as jax_attention
from tensor2robot_tpu_torch.layers import attention_layers
from tensor2robot_tpu_torch.ops import attention

# The port's tests run in the same worker processes as the JAX suite;
# one torch thread keeps torch from starting its OpenMP and MKL thread
# pools beside XLA's CPU threads.
torch.set_num_threads(1)

F32_TOL = 1e-5
BF16_TOL = 3e-2
BF16_RNORM_TOL = 1e-2


def _qkv(t, seed, b=1, h=2, d=8):
  rs = np.random.RandomState(seed)
  return [rs.randn(b, h, t, d).astype(np.float32) for _ in range(3)]


def _jax_dtype(dtype):
  return jnp.float32 if dtype == "float32" else jnp.bfloat16


def _torch_dtype(dtype):
  return torch.float32 if dtype == "float32" else torch.bfloat16


def _jax_grads(arrays, causal, dtype):
  def loss(q, k, v):
    out = jax_attention.flash_attention(q, k, v, causal=causal, block_q=16,
                                        block_k=16, interpret=True)
    out = out.astype(jnp.float32)
    return (out * jnp.cos(out)).sum()

  q, k, v = (jnp.asarray(a, _jax_dtype(dtype)) for a in arrays)
  return jax.grad(loss, argnums=(0, 1, 2))(q, k, v)


def _torch_grads(fn, arrays, dtype):
  leaves = [torch.from_numpy(a).to(_torch_dtype(dtype)).requires_grad_(True)
            for a in arrays]
  out = fn(*leaves).float()
  return torch.autograd.grad((out * torch.cos(out)).sum(), leaves)


def _assert_close(got, want, dtype):
  got = np.asarray(got.float())
  want = np.asarray(want, np.float32)
  if dtype == "float32":
    np.testing.assert_allclose(got, want, atol=F32_TOL, rtol=0)
  else:
    assert np.abs(got - want).max() <= BF16_TOL * np.abs(want).max()
    err = np.linalg.norm((got - want).astype(np.float64))
    assert err <= BF16_RNORM_TOL * np.linalg.norm(want.astype(np.float64))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("t", [32, 40])  # tiling and padded
def test_function_gradients_match_jax_vjp(t, causal, dtype):
  arrays = _qkv(t, seed=t + causal)
  want = _jax_grads(arrays, causal, dtype)
  got = _torch_grads(
      lambda q, k, v: attention.flash_attention(q, k, v, causal=causal,
                                                block_q=16, block_k=16),
      arrays, dtype)
  for g, w in zip(got, want):
    assert g.dtype == _torch_dtype(dtype)
    _assert_close(g, w, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("t", [32, 40])
def test_flash_backward_on_padded_operands_matches_jax_vjp(t, causal, dtype):
  """`flash_backward` (the plain version on the CPU) called on the padded
  [BH, T_pad, D] operands with the JAX forward's cotangent, sliced back,
  against `jax.vjp` of the JAX `flash_attention`."""
  arrays = _qkv(t, seed=7 * t + causal)
  jq, jk, jv = (jnp.asarray(a, _jax_dtype(dtype)) for a in arrays)
  out, vjp = jax.vjp(lambda q, k, v: jax_attention.flash_attention(
      q, k, v, causal=causal, block_q=16, block_k=16, interpret=True),
                     jq, jk, jv)
  cot = np.random.RandomState(t).randn(*out.shape).astype(np.float32)
  want = vjp(jnp.asarray(cot, out.dtype))

  bh, t_pad, d = 2, -(-t // 16) * 16, 8
  pad = lambda a: torch.nn.functional.pad(  # noqa: E731
      torch.from_numpy(a).to(_torch_dtype(dtype)).reshape(bh, t, d),
      (0, 0, 0, t_pad - t))
  q3, k3, v3, do3 = (pad(a) for a in (*arrays, cot))
  o3, lse = attention.flash_forward(q3, k3, v3, causal, t)
  got = attention.flash_backward(q3, k3, v3, o3, lse, do3, causal, t)
  for g, w in zip(got, want):
    assert g.shape == (bh, t_pad, d)
    assert not g[:, t:].any()  # padded keys and rows get no gradient
    _assert_close(g[:, :t].reshape(1, 2, t, d), w, dtype)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("t", [32, 40, 6])
def test_function_gradients_match_autograd_through_attention(t, causal):
  """q, k and v all get gradients through `flash_attention`, equal to torch
  autograd through the plain `attention`."""
  arrays = _qkv(t, seed=3 * t + causal, b=2)
  want = _torch_grads(lambda q, k, v: attention.attention(q, k, v,
                                                          causal=causal),
                      arrays, "float32")
  got = _torch_grads(lambda q, k, v: attention.flash_attention(
      q, k, v, causal=causal), arrays, "float32")
  for g, w in zip(got, want):
    assert g is not None and g.abs().sum() > 0
    torch.testing.assert_close(g, w, atol=F32_TOL, rtol=0)


def _graph_nodes(fn):
  seen, todo = [], [fn]
  while todo:
    node = todo.pop()
    if node is not None and node not in seen:
      seen.append(node)
      todo.extend(next_fn for next_fn, _ in node.next_functions)
  return [type(node).__name__ for node in seen]


@pytest.mark.parametrize("t", [16, 20])
def test_flash_attention_goes_through_the_autograd_function(t):
  q, k, v = (torch.from_numpy(a).requires_grad_(True) for a in _qkv(t, 0))
  out = attention.flash_attention(q, k, v, causal=True)
  # The gradient of the registered operator `t2r::flash_fwd`
  # (`register_autograd`), which calls `t2r::flash_bwd`.
  assert ("GeneratedBackwardFor_t2r_flash_fwd_defaultBackward"
          in _graph_nodes(out.grad_fn))
  q3 = q.detach().reshape(2, t, 8).requires_grad_(True)
  out3, lse = attention.flash_forward(q3, q3, q3, True, t)
  assert out3.requires_grad and not lse.requires_grad


def test_flash_module_trains_its_projections():
  """A loss through `MultiHeadAttention(backend='flash')` reaches every
  projection, as through backend='reference'."""
  torch.manual_seed(0)
  x = torch.randn(2, 12, 16)
  weights = attention_layers.MultiHeadAttention(16, num_heads=2,
                                                head_dim=8).state_dict()
  grads = {}
  for backend in ("flash", "reference"):
    layer = attention_layers.MultiHeadAttention(16, num_heads=2, head_dim=8,
                                                causal=True, backend=backend)
    layer.load_state_dict(weights)
    out = layer(x)
    (out * torch.cos(out)).sum().backward()
    grads[backend] = {name: p.grad.clone() for name, p in
                      layer.named_parameters()}
  for name, g in grads["flash"].items():
    if name != "k_proj.bias":  # softmax is shift-invariant: ~0 either way
      assert g.abs().sum() > 0, name
    torch.testing.assert_close(g, grads["reference"][name], atol=F32_TOL,
                               rtol=0)


def test_no_double_backward():
  q = torch.from_numpy(_qkv(16, 1)[0]).requires_grad_(True)
  out = attention.flash_attention(q, q, q, causal=True)
  (g,) = torch.autograd.grad(out.sum(), q, create_graph=True)
  with pytest.raises(RuntimeError):
    torch.autograd.grad(g.sum(), q)


def test_flash_backward_rejects_bad_operands():
  x = torch.zeros(2, 8, 16)
  lse = torch.zeros(2, 8, 1)
  with pytest.raises(ValueError, match="valid_len"):
    attention.flash_backward(x, x, x, x, lse, x, True, 0)
  with pytest.raises(ValueError, match="one shape"):
    attention.flash_backward(x, x, x, x, lse, torch.zeros(2, 8, 8), True, 8)
  meta = torch.zeros(2, 8, 16, device="meta")
  with pytest.raises(ValueError, match="unsupported device"):
    attention.flash_backward(meta, meta, meta, meta, lse, meta, True, 8)
