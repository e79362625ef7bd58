"""The port's fused decode tick against the JAX package's, on the CPU.

The port's `fused_decode_attention` on CPU tensors runs its plain
version, in place; the JAX side runs the Pallas kernel interpreted. Same
numpy arenas and inputs, at every append index with partial blocks,
mixed-progress lanes and a pad lane on the null slot.

Tolerances: out f32 1e-5 (the same online softmax, summed in another
order); arena rows are copies, so they must be equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensor2robot_tpu.ops import decode_kernels as jax_dk
from tensor2robot_tpu_torch.ops import decode_kernels as dk

# The port's tests run in the same worker processes as the JAX suite;
# one torch thread keeps torch from starting its OpenMP and MKL thread
# pools beside XLA's CPU threads.
torch.set_num_threads(1)

F32_TOL = 1e-5


def _inputs(rs, b, h, d):
  return [rs.randn(b, h, d).astype(np.float32) for _ in range(3)]


def _torch_args(q, k_new, v_new, k_arena, v_arena, slots, index, mask):
  return (torch.from_numpy(q), torch.from_numpy(k_new),
          torch.from_numpy(v_new), torch.from_numpy(k_arena.copy()),
          torch.from_numpy(v_arena.copy()),
          torch.tensor(slots, dtype=torch.int32),
          torch.tensor(index, dtype=torch.int32), torch.tensor(mask))


@pytest.mark.parametrize("t,block_k", [(8, 4), (8, 8), (32, 8)])
def test_matches_pallas_kernel_at_every_index(t, block_k):
  """Every append index 0..T-1: one lane at idx, one lagging at idx // 2,
  a pad lane on the null slot — out and both arenas."""
  s, b, h, d = 5, 3, 2, 4
  rs = np.random.RandomState(t * 31 + block_k)
  k_arena = rs.randn(s, t, h, d).astype(np.float32)
  v_arena = rs.randn(s, t, h, d).astype(np.float32)
  slots, mask = [1, 3, 0], [True, True, False]
  for idx in range(t):
    q, k_new, v_new = _inputs(rs, b, h, d)
    index = [idx, idx // 2, 0]
    want = jax_dk.fused_decode_attention(
        jnp.asarray(q), jnp.asarray(k_new), jnp.asarray(v_new),
        jnp.asarray(k_arena), jnp.asarray(v_arena),
        jnp.asarray(slots, jnp.int32), jnp.asarray(index, jnp.int32),
        jnp.asarray(mask), block_k=block_k, interpret=True)
    got = dk.fused_decode_attention(*_torch_args(
        q, k_new, v_new, k_arena, v_arena, slots, index, mask))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               atol=F32_TOL, rtol=F32_TOL,
                               err_msg=f"out at index {idx}")
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))


@pytest.mark.parametrize("t", [8, 32])
def test_reference_composition_matches_jax(t):
  s, b, h, d = 4, 3, 2, 4
  rs = np.random.RandomState(t)
  k_arena = rs.randn(s, t, h, d).astype(np.float32)
  v_arena = rs.randn(s, t, h, d).astype(np.float32)
  q, k_new, v_new = _inputs(rs, b, h, d)
  slots, index, mask = [2, 1, 0], [t - 1, 1, 0], [True, True, False]
  want = jax_dk.reference_decode_attention(
      jnp.asarray(q), jnp.asarray(k_new), jnp.asarray(v_new),
      jnp.asarray(k_arena), jnp.asarray(v_arena),
      jnp.asarray(slots, jnp.int32), jnp.asarray(index, jnp.int32),
      jnp.asarray(mask))
  args = _torch_args(q, k_new, v_new, k_arena, v_arena, slots, index, mask)
  got = dk.reference_decode_attention(*args)
  np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                             atol=F32_TOL, rtol=F32_TOL)
  np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
  # The composition leaves its input arenas alone.
  np.testing.assert_array_equal(args[3].numpy(), k_arena)
  # ... and the fused tick agrees with it.
  fused = dk.fused_decode_attention(*args)
  np.testing.assert_allclose(fused[0].numpy(), got[0].numpy(),
                             atol=F32_TOL, rtol=F32_TOL)
  np.testing.assert_array_equal(fused[1].numpy(), got[1].numpy())
  np.testing.assert_array_equal(fused[2].numpy(), got[2].numpy())


def test_pad_lane_leaves_null_slot_bit_identical():
  s, t, h, d = 3, 8, 2, 4
  rs = np.random.RandomState(7)
  k_arena = rs.randn(s, t, h, d).astype(np.float32)
  v_arena = rs.randn(s, t, h, d).astype(np.float32)
  q, k_new, v_new = _inputs(rs, 1, h, d)
  _, k_upd, v_upd = dk.fused_decode_attention(*_torch_args(
      q, k_new, v_new, k_arena, v_arena, [0], [3], [False]))
  np.testing.assert_array_equal(k_upd.numpy(), k_arena)
  np.testing.assert_array_equal(v_upd.numpy(), v_arena)


def test_arena_is_updated_in_place_at_live_rows_only():
  s, t, h, d = 4, 8, 2, 4
  rs = np.random.RandomState(11)
  k_arena = rs.randn(s, t, h, d).astype(np.float32)
  v_arena = rs.randn(s, t, h, d).astype(np.float32)
  q, k_new, v_new = _inputs(rs, 3, h, d)
  args = _torch_args(q, k_new, v_new, k_arena, v_arena, [3, 1, 0],
                     [5, 2, 0], [True, True, False])
  k_ptr, v_ptr = args[3].data_ptr(), args[4].data_ptr()
  _, k_out, v_out = dk.fused_decode_attention(*args)
  assert k_out is args[3] and v_out is args[4]
  assert k_out.data_ptr() == k_ptr and v_out.data_ptr() == v_ptr
  want_k, want_v = k_arena.copy(), v_arena.copy()
  want_k[3, 5], want_k[1, 2] = k_new[0], k_new[1]
  want_v[3, 5], want_v[1, 2] = v_new[0], v_new[1]
  np.testing.assert_array_equal(k_out.numpy(), want_k)
  np.testing.assert_array_equal(v_out.numpy(), want_v)


def test_effective_block_tiles_every_horizon():
  for t in range(1, 65):
    block = dk._effective_block(t, 8)
    assert 1 <= block <= min(8, t) and t % block == 0, (t, block)
    assert block == jax_dk._effective_block(t, 8)


def test_rejects_bad_operands_and_devices():
  rs = np.random.RandomState(0)
  q, k_new, v_new = _inputs(rs, 1, 2, 4)
  arena = np.zeros((2, 4, 2, 4), np.float32)
  args = list(_torch_args(q, k_new, v_new, arena, arena, [1], [0], [True]))
  bad = list(args)
  bad[3] = bad[3].double()
  with pytest.raises(ValueError, match="float32"):
    dk.fused_decode_attention(*bad)
  bad = list(args)
  bad[5] = torch.tensor([1, 1], dtype=torch.int32)
  with pytest.raises(ValueError, match="slots / index / mask"):
    dk.fused_decode_attention(*bad)
  meta = [a.to("meta") for a in args]
  with pytest.raises(ValueError, match="unsupported device"):
    dk.fused_decode_attention(*meta)
