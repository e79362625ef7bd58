"""The port's attention ops against the JAX package's, on the CPU.

Same numpy inputs through both: `attention`, `cached_attention`, and the
flash forward (O and lse, against the Pallas kernel in interpret mode),
causal and not, tiling and non-tiling T, f32 and bf16.

Tolerances: f32 1e-5 (both sides accumulate in f32; only the summation
order differs); bf16 3e-2 (8-bit mantissas on inputs, P and outputs).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensor2robot_tpu.ops import attention as jax_attention
from tensor2robot_tpu_torch.ops import attention

# The port's tests run in the same worker processes as the JAX suite;
# one torch thread keeps torch from starting its OpenMP and MKL thread
# pools beside XLA's CPU threads.
torch.set_num_threads(1)

F32_TOL = 1e-5
BF16_TOL = 3e-2


def _qkv(shape, seed):
  rs = np.random.RandomState(seed)
  return [rs.randn(*shape).astype(np.float32) for _ in range(3)]


def _both(arrays, dtype):
  """The same values as JAX and torch arrays of `dtype`."""
  jax_dtype = jnp.float32 if dtype == "float32" else jnp.bfloat16
  torch_dtype = torch.float32 if dtype == "float32" else torch.bfloat16
  return ([jnp.asarray(a, jax_dtype) for a in arrays],
          [torch.from_numpy(a).to(torch_dtype) for a in arrays])


def _close(got, want, tol):
  np.testing.assert_allclose(np.asarray(got.float()),
                             np.asarray(want, np.float32), atol=tol, rtol=tol)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("t", [8, 32])
def test_attention_matches_jax(causal, t):
  (jq, jk, jv), (tq, tk, tv) = _both(_qkv((2, 4, t, 8), seed=t), "float32")
  _close(attention.attention(tq, tk, tv, causal=causal),
         jax_attention.attention(jq, jk, jv, causal=causal), F32_TOL)


def test_attention_causal_first_row_is_first_value():
  q, k, v = (torch.from_numpy(a) for a in _qkv((1, 2, 8, 8), seed=1))
  out = attention.attention(q, k, v, causal=True)
  torch.testing.assert_close(out[:, :, 0], v[:, :, 0], atol=1e-6, rtol=1e-5)


@pytest.mark.parametrize("t", [8, 32])
def test_cached_attention_matches_jax_at_every_index(t):
  rs = np.random.RandomState(t)
  b, h, d = 3, 4, 8
  q = rs.randn(b, h, d).astype(np.float32)
  k_cache = rs.randn(b, t, h, d).astype(np.float32)
  v_cache = rs.randn(b, t, h, d).astype(np.float32)
  for i in range(t):
    index = np.array([i, i // 2, 0], np.int32)
    want = jax_attention.cached_attention(
        jnp.asarray(q), jnp.asarray(k_cache), jnp.asarray(v_cache),
        jnp.asarray(index))
    got = attention.cached_attention(
        torch.from_numpy(q), torch.from_numpy(k_cache),
        torch.from_numpy(v_cache), torch.from_numpy(index))
    _close(got, want, F32_TOL)


def _padded(arrays, t, tile):
  t_pad = -(-t // tile) * tile
  return [np.pad(a, ((0, 0), (0, t_pad - t), (0, 0))) for a in arrays]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("t", [32, 30])  # tiling and padded
def test_flash_forward_out_and_lse_match_pallas(t, causal, dtype):
  """O and the per-row logsumexp of the port's flash forward (its plain
  version on the CPU) against `_flash_forward` of the Pallas kernel,
  interpreted, on the same padded input: rows past T carry lse = 0."""
  arrays = _padded(_qkv((6, t, 8), seed=3 * t), t, tile=16)
  (jq, jk, jv), (tq, tk, tv) = _both(arrays, dtype)
  want_out, want_lse = jax_attention._flash_forward(
      jq, jk, jv, causal, 16, 16, t, True)
  got_out, got_lse = attention.flash_forward(tq, tk, tv, causal, t)
  tol = F32_TOL if dtype == "float32" else BF16_TOL
  assert got_out.dtype == tq.dtype and got_lse.dtype == torch.float32
  assert got_lse.shape == tuple(want_lse.shape)
  _close(got_out[:, :t], want_out[:, :t], tol)
  _close(got_lse, want_lse, tol)
  assert not got_lse[:, t:].any()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("t", [32, 30, 6])
def test_flash_attention_matches_jax(t, causal, dtype):
  """The wrapper end to end: block normalisation, padding a T that does
  not tile, and the slice back."""
  (jq, jk, jv), (tq, tk, tv) = _both(_qkv((1, 2, t, 8), seed=t), dtype)
  want = jax_attention.flash_attention(jq, jk, jv, causal=causal,
                                       block_q=16, block_k=16, interpret=True)
  got = attention.flash_attention(tq, tk, tv, causal=causal, block_q=16,
                                  block_k=16)
  assert got.shape == tq.shape and got.dtype == tq.dtype
  _close(got, want, F32_TOL if dtype == "float32" else BF16_TOL)


def test_flash_attention_cross_falls_back_to_attention():
  rs = np.random.RandomState(0)
  q = torch.from_numpy(rs.randn(1, 2, 4, 8).astype(np.float32))
  kv = torch.from_numpy(rs.randn(1, 2, 6, 8).astype(np.float32))
  torch.testing.assert_close(attention.flash_attention(q, kv, kv),
                             attention.attention(q, kv, kv))


def test_flash_forward_rejects_bad_operands():
  x = torch.zeros(2, 8, 16)
  with pytest.raises(ValueError, match="valid_len"):
    attention.flash_forward(x, x, x, True, 9)
  with pytest.raises(ValueError, match="one shape"):
    attention.flash_forward(x, x, torch.zeros(2, 8, 8), True, 8)
  meta = torch.zeros(2, 8, 16, device="meta")
  with pytest.raises(ValueError, match="unsupported device"):
    attention.flash_forward(meta, meta, meta, True, 8)
