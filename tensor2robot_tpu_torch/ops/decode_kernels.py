"""The fused session decode tick: cached attention plus the arena append,
in place, in one kernel launch per attention block.

Counterpart of `tensor2robot_tpu.ops.decode_kernels`:

* `fused_decode_attention` — the registered operator `t2r::decode_tick`
  (mutating the arenas, opaque to `torch.compile`, with a fake
  implementation and a flop formula): on a CUDA tensor it launches
  `csrc/decode_tick.cu` once: per lane, an online softmax over the lane's
  own arena rows t < index, split over T into chunks of `DECODE_CHUNK`
  rows (one thread block each) whose partials the lane's last blocks
  merge in chunk order (groups of `DECODE_FAN_IN`, then the groups),
  this tick's K/V absorbed as the last position,
  and the K/V row (slot, index) written IN PLACE for live lanes. Pad
  lanes (mask False, on the null slot 0) write nothing. On a CPU tensor
  it runs `_decode_tick_plain`, the same function in plain PyTorch, also
  in place. `fused_decode_attention.launches` counts kernel launches.
* `reference_decode_attention` — the composition the kernel is pinned to
  (gather -> append -> `cached_attention` -> masked scatter), returning
  new arenas and leaving its inputs alone.

The arenas are [S, T, H, D] f32 (slot-major, T-major); slot 0 is the null
slot. The caller must keep every index below T: on the card a row past
the slot is another slot's memory (the engine's horizon guard keeps it
so; the kernel also skips such a write).
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
from torch.utils import flop_counter

from tensor2robot_tpu_torch.ops import _kernels
from tensor2robot_tpu_torch.ops import attention as attention_ops

__all__ = ["fused_decode_attention", "reference_decode_attention"]

DECODE_HEAD_DIMS = (16, 32, 64, 128)
# Rows per chunk of the plain version's online softmax.
_PLAIN_BLOCK = 512
# Arena rows per thread block of the CUDA kernel (its split over T): at
# B = 1 and index 4095 it makes 128 working blocks for the H100's 132
# SMs, at a bucket of 8 lanes of mixed progress a few hundred.
DECODE_CHUNK = 32
# Chunks per first-level merge of the kernel's partials (its kFanIn).
DECODE_FAN_IN = 16
# Per device, the kernel's ticket counters (int32, per lane and head
# group: one per merge group and one for the lane): zeroed once, and
# every launch leaves them 0 again.
_counters: Dict[torch.device, torch.Tensor] = {}

Tensors3 = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def reference_decode_attention(q: torch.Tensor, k_new: torch.Tensor,
                               v_new: torch.Tensor, k_arena: torch.Tensor,
                               v_arena: torch.Tensor, slots: torch.Tensor,
                               index: torch.Tensor, mask: torch.Tensor
                               ) -> Tensors3:
  """Gathers each lane's rows, appends this tick's K/V at the lane's
  index, runs `cached_attention`, and scatters the appended rows back
  masked (pad lanes scatter the OLD row, so the null slot never changes).
  Returns (out, k_arena', v_arena') as new tensors."""
  rows = torch.arange(q.shape[0], device=q.device)
  slots, index = slots.long(), index.long()
  k_cache = k_arena[slots]
  v_cache = v_arena[slots]
  k_cache[rows, index] = k_new
  v_cache[rows, index] = v_new
  out = attention_ops.cached_attention(q, k_cache, v_cache, index)
  lane = mask[:, None, None]
  k_row = torch.where(lane, k_new, k_arena[slots, index])
  v_row = torch.where(lane, v_new, v_arena[slots, index])
  k_out, v_out = k_arena.clone(), v_arena.clone()
  k_out[slots, index] = k_row
  v_out[slots, index] = v_row
  return out, k_out, v_out


def _effective_block(t: int, block_k: int) -> int:
  """Largest block <= block_k that divides T (every T tiles exactly)."""
  block = max(1, min(int(block_k), t))
  while t % block:
    block -= 1
  return block


def _decode_tick_plain(q, k_new, v_new, k_arena, v_arena, slots, index,
                       mask) -> torch.Tensor:
  """The plain PyTorch version of the decode-tick kernel: a chunked
  online softmax over arena rows t < index (later rows score
  finfo.min/2, as in the TPU kernel), this tick's K/V absorbed last, and
  the in-place masked append. Returns out [B, H, D]."""
  b, h, d = q.shape
  t = k_arena.shape[1]
  scale = 1.0 / math.sqrt(d)
  mask_val = attention_ops._mask_value(torch.float32)
  slots_l, index_l = slots.long(), index.long()
  block = _effective_block(t, _PLAIN_BLOCK)
  m = torch.full((b, h), float("-inf"), device=q.device)
  l = torch.zeros((b, h), device=q.device)
  o = torch.zeros((b, h, d), device=q.device)
  for start in range(0, t, block):
    pos = torch.arange(start, start + block, device=q.device)
    k_blk = k_arena[slots_l[:, None], pos[None, :]]  # [B, block, H, D]
    v_blk = v_arena[slots_l[:, None], pos[None, :]]
    s = torch.einsum("bhd,bthd->bht", q, k_blk) * scale
    s = s.masked_fill(~(pos[None, :] < index_l[:, None])[:, None, :],
                      mask_val)
    m_new = torch.maximum(m, s.amax(dim=-1))
    alpha = torch.exp(m - m_new)
    p = torch.exp(s - m_new[..., None])
    l = l * alpha + p.sum(dim=-1)
    o = o * alpha[..., None] + torch.einsum("bht,bthd->bhd", p, v_blk)
    m = m_new
  s_new = (q * k_new).sum(dim=-1) * scale
  m_fin = torch.maximum(m, s_new)
  alpha = torch.exp(m - m_fin)
  p_new = torch.exp(s_new - m_fin)
  l_fin = l * alpha + p_new
  o_fin = o * alpha[..., None] + p_new[..., None] * v_new
  live = mask.bool()
  k_arena[slots_l[live], index_l[live]] = k_new[live]
  v_arena[slots_l[live], index_l[live]] = v_new[live]
  return o_fin / l_fin.clamp_min(1e-30)[..., None]


def _check_operands(q, k_new, v_new, k_arena, v_arena, slots, index, mask):
  b, h, d = q.shape
  if k_new.shape != q.shape or v_new.shape != q.shape:
    raise ValueError(f"q / k_new / v_new must share [B, H, D], got "
                     f"{q.shape}, {k_new.shape}, {v_new.shape}")
  if (k_arena.dim() != 4 or k_arena.shape != v_arena.shape
      or k_arena.shape[2:] != (h, d)):
    raise ValueError(f"arenas must be [S, T, {h}, {d}], got "
                     f"{k_arena.shape}, {v_arena.shape}")
  if slots.shape != (b,) or index.shape != (b,) or mask.shape != (b,):
    raise ValueError(f"slots / index / mask must be [{b}], got "
                     f"{slots.shape}, {index.shape}, {mask.shape}")
  for name, x in (("q", q), ("k_new", k_new), ("v_new", v_new),
                  ("k_arena", k_arena), ("v_arena", v_arena)):
    if x.dtype != torch.float32:
      raise ValueError(f"{name} must be float32, got {x.dtype}")
  devices = {x.device for x in (q, k_new, v_new, k_arena, v_arena, slots,
                                index, mask)}
  if len(devices) != 1:
    raise ValueError(f"operands span devices {sorted(map(str, devices))}")


def fused_decode_attention(q: torch.Tensor, k_new: torch.Tensor,
                           v_new: torch.Tensor, k_arena: torch.Tensor,
                           v_arena: torch.Tensor, slots: torch.Tensor,
                           index: torch.Tensor, mask: torch.Tensor
                           ) -> Tensors3:
  """Fused gather + append + cached-attention decode tick, in place.

  q / k_new / v_new: [B, H, D] f32 — this tick's per-lane query and K/V;
  k_arena / v_arena: [S, T, H, D] f32 — the whole arena leaf, updated in
  place at each live lane's (slot, index) row;
  slots / index: [B] int32 — each lane's slot (live lanes distinct) and
  tick position; mask: [B] bool — live lanes.

  Returns (out [B, H, D], k_arena, v_arena): the arenas are the SAME
  tensors that came in. The call is the registered operator
  `t2r::decode_tick`, which mutates the arenas and returns `out` only (a
  custom operator may not return an input), so a compiled graph holds it.

  On CUDA: one launch per call, `ceil(T / DECODE_CHUNK)` x B blocks (times
  the head groups), with partials in scratch from `torch.empty` and one
  ticket-counter buffer per device that every launch leaves zeroed. Calls
  that share a device must therefore serialise on one stream, as
  `SessionEngine` does under its `_arena_lock`. Anything the kernel does
  not take raises; nothing falls back.
  """
  _check_operands(q, k_new, v_new, k_arena, v_arena, slots, index, mask)
  if q.device.type not in ("cpu", "cuda"):
    raise ValueError(f"fused_decode_attention: unsupported device "
                     f"{q.device}")
  out = torch.ops.t2r.decode_tick(q, k_new, v_new, k_arena, v_arena, slots,
                                  index, mask)
  return out, k_arena, v_arena


fused_decode_attention.launches = 0


@torch.library.custom_op("t2r::decode_tick",
                         mutates_args=("k_arena", "v_arena"),
                         device_types="cpu")
def _decode_tick_op(q: torch.Tensor, k_new: torch.Tensor,
                    v_new: torch.Tensor, k_arena: torch.Tensor,
                    v_arena: torch.Tensor, slots: torch.Tensor,
                    index: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
  """`t2r::decode_tick` on the CPU: the plain version. Its CUDA
  implementation, the kernel launch, is registered below. `out` is
  contiguous on every device, as the fake implementation says."""
  return _decode_tick_plain(q, k_new, v_new, k_arena, v_arena, slots, index,
                            mask).contiguous()


@_decode_tick_op.register_fake
def _decode_tick_fake(q, k_new, v_new, k_arena, v_arena, slots, index, mask):
  return q.new_empty(q.shape)


@_decode_tick_op.register_kernel("cuda")
def _launch_decode_tick(q, k_new, v_new, k_arena, v_arena, slots, index,
                        mask):
  b, h, d = q.shape
  if d not in DECODE_HEAD_DIMS:
    raise ValueError(f"decode kernel head_dim must be one of "
                     f"{DECODE_HEAD_DIMS}, got {d}")
  if not (k_arena.is_contiguous() and v_arena.is_contiguous()):
    raise ValueError("the arenas are updated in place and must be "
                     "contiguous")
  if slots.dtype != torch.int32 or index.dtype != torch.int32:
    raise ValueError(f"slots and index must be int32, got {slots.dtype}, "
                     f"{index.dtype}")
  q, k_new, v_new = q.contiguous(), k_new.contiguous(), v_new.contiguous()
  slots, index = slots.contiguous(), index.contiguous()
  mask = mask.to(torch.bool).contiguous()
  for name, x in (("q", q), ("k_new", k_new), ("v_new", v_new),
                  ("k_arena", k_arena), ("v_arena", v_arena)):
    if x.data_ptr() % 16:
      raise ValueError(f"{name} must be 16-byte aligned (float4 loads and "
                       f"bulk copies)")
  t = k_arena.shape[1]
  out = torch.empty_like(q)
  chunks = -(-t // DECODE_CHUNK)
  groups = -(-chunks // DECODE_FAN_IN)
  # Per (lane, chunk or merge group, head): o [D], then (m, l), padded.
  partials = torch.empty(b * (chunks + groups) * h * (d + 4),
                         dtype=torch.float32, device=q.device)
  counters = _counters.get(q.device)
  if counters is None or counters.numel() < b * h * (groups + 1):
    counters = torch.zeros(max(b * h * (groups + 1), 4096),
                           dtype=torch.int32, device=q.device)
    _counters[q.device] = counters
  lib = _kernels.library("decode_tick")
  status = lib.t2r_decode_tick(
      q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(), k_arena.data_ptr(),
      v_arena.data_ptr(), slots.data_ptr(), index.data_ptr(),
      mask.data_ptr(), out.data_ptr(), partials.data_ptr(),
      counters.data_ptr(), b, t, h, d, DECODE_CHUNK,
      torch.cuda.current_stream(q.device).cuda_stream)
  _kernels.check("decode_tick", status)
  fused_decode_attention.launches += 1
  return out


@flop_counter.register_flop_formula(torch.ops.t2r.decode_tick)
def _decode_tick_flops(q_shape, k_new_shape, v_new_shape, k_arena_shape,
                       v_arena_shape, slots_shape, index_shape, mask_shape,
                       out_shape=None, **kwargs) -> int:
  """4·H·D a position attended (a score and its weighted value), over the
  arena's T positions for each of the B lanes: the most the tick can need
  (the bound column counts each lane's index + 1, which its shapes do not
  carry)."""
  b, h, d = q_shape
  return 4 * b * k_arena_shape[1] * h * d
