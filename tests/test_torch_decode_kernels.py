"""The port's fused decode tick against the JAX package's, on the CPU.

The port's `fused_decode_attention` on CPU tensors runs its plain
version, in place; the JAX side runs the Pallas kernel interpreted. Same
numpy arenas and inputs, at every append index with partial blocks,
mixed-progress lanes and a pad lane on the null slot.

Tolerances: out f32 1e-5 (the same online softmax, summed in another
order); arena rows are copies, so they must be equal.

The CUDA kernel's split over T cannot run here; its arithmetic can.
`_split_t_decode` repeats it in plain torch (per-chunk partials over rows
< index, chunks past the index absent, the merge tree in chunk order,
this tick's K/V absorbed last) and is held to the plain version and the
Pallas kernel at the same 1e-5.
"""

import math

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


def _absorb(state, part):
  """The kernel's online merge of a partial (m, l, o) into a running
  state, per head: unchanged while both are empty."""
  (m, l, o), (mc, lc, oc) = state, part
  m_new = torch.maximum(m, mc)
  seen = m_new > float("-inf")
  safe = torch.where(seen, m_new, torch.zeros_like(m_new))
  a = torch.where(seen, torch.exp(m - safe), torch.ones_like(m))
  b = torch.where(seen, torch.exp(mc - safe), torch.zeros_like(m))
  return m_new, l * a + lc * b, o * a[:, None] + oc * b[:, None]


def _split_t_decode(q, k_new, v_new, k_arena, v_arena, slots, index, mask,
                    chunk, fan_in):
  """The CUDA kernel's arithmetic in plain torch: for each lane, chunks of
  `chunk` rows up to max(1, ceil(index / chunk)) (chunk 0 always, empty
  at index 0), each a partial (m, l, o) per head; each group of `fan_in`
  chunks merged in chunk order, then (with more than one group) the
  groups' states in group order; k_new / v_new absorbed as the last
  position; then the masked in-place append. Returns out [B, H, D]."""
  b, h, d = q.shape
  scale = 1.0 / math.sqrt(d)
  empty = (torch.full((h,), float("-inf")), torch.zeros(h), torch.zeros(h, d))
  out = torch.empty_like(q)
  for lane in range(b):
    slot, idx = int(slots[lane]), int(index[lane])
    partials = []
    for c in range(max(1, -(-idx // chunk))):
      rows = range(c * chunk, min((c + 1) * chunk, idx))
      if not rows:  # chunk 0 at index 0
        partials.append(empty)
        continue
      k = k_arena[slot, rows.start:rows.stop]  # [n, H, D]
      v = v_arena[slot, rows.start:rows.stop]
      s = torch.einsum("hd,nhd->hn", q[lane], k) * scale
      m = s.amax(dim=-1)
      p = torch.exp(s - m[:, None])
      partials.append((m, p.sum(dim=-1), torch.einsum("hn,nhd->hd", p, v)))
    groups = []
    for start in range(0, len(partials), fan_in):
      state = empty
      for part in partials[start:start + fan_in]:
        state = _absorb(state, part)
      groups.append(state)
    state = groups[0]
    if len(groups) > 1:
      state = empty
      for part in groups:
        state = _absorb(state, part)
    m, l, o = state
    s_new = (q[lane] * k_new[lane]).sum(dim=-1) * scale
    m_fin = torch.maximum(m, s_new)
    a = torch.exp(m - m_fin)
    p_new = torch.exp(s_new - m_fin)
    out[lane] = (o * a[:, None] + p_new[:, None] * v_new[lane]) / (
        l * a + p_new).clamp_min(1e-30)[:, None]
  live = mask.bool()
  slots_l, index_l = slots.long(), index.long()
  k_arena[slots_l[live], index_l[live]] = k_new[live]
  v_arena[slots_l[live], index_l[live]] = v_new[live]
  return out


@pytest.mark.parametrize("t,chunk,fan_in", [(8, 1, 2), (8, 3, 2), (8, 8, 16),
                                            (32, 1, 4), (32, 3, 2),
                                            (32, 8, 16)])
def test_split_t_merge_matches_plain_and_pallas_at_every_index(t, chunk,
                                                               fan_in):
  """The kernel's chunked partials and merge tree, at every index 0..T-1
  (chunk edges, ragged last chunks, one chunk, one merge group or several,
  index 0), with a lagging lane and a pad lane on the null slot: out
  against the plain version and the interpreted Pallas kernel, arenas
  equal."""
  s, b, h, d = 5, 3, 2, 4
  rs = np.random.RandomState(t * 7 + chunk)
  k_arena = rs.randn(s, t, h, d).astype(np.float32)
  v_arena = rs.randn(s, t, h, d).astype(np.float32)
  slots, mask = [1, 3, 0], [True, True, False]
  for idx in range(t):
    q, k_new, v_new = _inputs(rs, b, h, d)
    index = [idx, idx // 2, idx // 3]
    args = _torch_args(q, k_new, v_new, k_arena, v_arena, slots, index, mask)
    got = _split_t_decode(*args, chunk=chunk, fan_in=fan_in)
    plain_args = _torch_args(q, k_new, v_new, k_arena, v_arena, slots, index,
                             mask)
    plain = dk._decode_tick_plain(*plain_args)
    want = jax_dk.fused_decode_attention(
        jnp.asarray(q), jnp.asarray(k_new), jnp.asarray(v_new),
        jnp.asarray(k_arena), jnp.asarray(v_arena),
        jnp.asarray(slots, jnp.int32), jnp.asarray(index, jnp.int32),
        jnp.asarray(mask), block_k=8, interpret=True)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), atol=F32_TOL,
                               rtol=F32_TOL, err_msg=f"plain, index {idx}")
    np.testing.assert_allclose(got.numpy(), np.asarray(want[0]), atol=F32_TOL,
                               rtol=F32_TOL, err_msg=f"Pallas, index {idx}")
    np.testing.assert_array_equal(args[3].numpy(), plain_args[3].numpy())
    np.testing.assert_array_equal(args[4].numpy(), plain_args[4].numpy())
    np.testing.assert_array_equal(args[3].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(args[4].numpy(), np.asarray(want[2]))


@pytest.mark.parametrize("chunk", [1, 3, 8, dk.DECODE_CHUNK])
def test_split_t_chunks_cover_each_row_below_the_index_once(chunk):
  """The kernel's work split: of a grid of ceil(T / C) chunks, the ones
  that run (chunk 0, and every chunk starting below the index) read rows
  [c*C, min((c+1)*C, index)), which tile [0, index) exactly; their count
  is the kernel's max(1, ceil(index / C))."""
  t = 64
  grid = -(-t // chunk)
  for idx in range(t + 1):
    running = [c for c in range(grid) if c == 0 or c * chunk < idx]
    assert len(running) == max(1, -(-idx // chunk))
    rows = [r for c in running
            for r in range(c * chunk, min((c + 1) * chunk, idx))]
    assert rows == list(range(idx)), (chunk, idx)
