"""Attention ops for the port: plain softmax attention, the one-tick
cached attention, and the flash forward kernel.

Counterpart of `tensor2robot_tpu.ops.attention`. All functions take
[batch, heads, seq, head_dim] ("BHTD") tensors.

* `attention` — plain softmax attention (any device).
* `cached_attention` — one decode tick against a per-session KV cache.
* `flash_attention` — the wrapper: pads a sequence that does not tile to
  the block multiple and masks it, then runs `flash_forward`.
* `flash_forward` — (out, lse) over [batch*heads, T, D]: the hand-written
  CUDA kernel (`csrc/flash_fwd.cu`) on a CUDA tensor, its plain PyTorch
  version (`_flash_forward_plain`) on a CPU tensor. Forward only; the
  backward kernels come with the training slice.

Ring and Ulysses sequence parallelism are not ported yet.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from tensor2robot_tpu_torch.ops import _kernels

__all__ = ["attention", "cached_attention", "flash_attention",
           "flash_forward"]

FLASH_HEAD_DIMS = (16, 32, 64, 128)


def _mask_value(dtype: torch.dtype) -> float:
  """The masked score: finfo.min / 2, not -inf (a fully masked row then
  softmaxes to uniform weights instead of NaN)."""
  return torch.finfo(dtype).min / 2


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool = False) -> torch.Tensor:
  """Plain softmax attention, [B, H, T, D]; softmax in f32."""
  scale = 1.0 / math.sqrt(q.shape[-1])
  scores = torch.einsum("bhqd,bhkd->bhqk", q, k) * scale
  if causal:
    tq, tk = scores.shape[-2], scores.shape[-1]
    mask = torch.ones((tq, tk), dtype=torch.bool,
                      device=q.device).tril(diagonal=tk - tq)
    scores = scores.masked_fill(~mask, _mask_value(scores.dtype))
  weights = torch.softmax(scores.float(), dim=-1)
  return torch.einsum("bhqk,bhkd->bhqd", weights.to(q.dtype), v)


def cached_attention(q_t: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, index: torch.Tensor
                     ) -> torch.Tensor:
  """One decode tick against a per-session KV cache.

  q_t: [B, H, D]; k_cache / v_cache: [B, T_max, H, D] (T-major, as the
  serving arena stores them); index: [B] int — each session's current
  tick, whose K/V are already appended at row `index`. Row b attends to
  positions t <= index[b]; later positions score `_mask_value`, exactly
  what row `index` of `attention(..., causal=True)` gives them.
  """
  scale = 1.0 / math.sqrt(q_t.shape[-1])
  scores = torch.einsum("bhd,bthd->bht", q_t, k_cache) * scale
  positions = torch.arange(k_cache.shape[1], device=q_t.device)
  valid = positions[None, :] <= index[:, None].long()  # [B, T]
  scores = scores.masked_fill(~valid[:, None, :], _mask_value(scores.dtype))
  weights = torch.softmax(scores.float(), dim=-1)
  return torch.einsum("bht,bthd->bhd", weights.to(q_t.dtype), v_cache)


def _flash_forward_plain(q3: torch.Tensor, k3: torch.Tensor,
                         v3: torch.Tensor, causal: bool, valid_len: int
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
  """The plain PyTorch version of the flash forward kernel: the same
  function (scores in f32, causal and padding masks, rows >= valid_len
  give out = 0 and lse = 0), computed all at once."""
  t, d = q3.shape[1], q3.shape[2]
  scale = 1.0 / math.sqrt(d)
  scores = torch.einsum("bqd,bkd->bqk", q3.float(), k3.float()) * scale
  pos = torch.arange(t, device=q3.device)
  valid = (pos[None, :] < valid_len) & (pos[:, None] < valid_len)
  if causal:
    valid = valid & (pos[:, None] >= pos[None, :])
  scores = scores.masked_fill(~valid, float("-inf"))
  row_valid = (pos < valid_len)[None, :, None]  # [1, T, 1]
  m = scores.amax(dim=-1, keepdim=True)
  m = torch.where(row_valid, m, torch.zeros_like(m))
  p = torch.exp(scores - m)  # masked entries and padded rows -> 0
  l = p.sum(dim=-1, keepdim=True)
  out = torch.einsum("bqk,bkd->bqd", p, v3.float()) / l.clamp_min(1e-30)
  lse = torch.where(row_valid, m + torch.log(l.clamp_min(1e-30)),
                    torch.zeros_like(m))
  return out.to(q3.dtype), lse


def flash_forward(q3: torch.Tensor, k3: torch.Tensor, v3: torch.Tensor,
                  causal: bool, valid_len: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
  """Flash attention forward over [batch*heads, T, D] (T already padded
  by the caller; keys and rows at or past `valid_len` are masked).

  Returns (out [BH, T, D] in the input dtype, lse [BH, T, 1] f32). A CPU
  tensor runs the plain version; a CUDA tensor launches
  `csrc/flash_fwd.cu` or raises (f32 or bf16, head_dim in
  FLASH_HEAD_DIMS). `flash_forward.launches` counts kernel launches.
  """
  if q3.shape != k3.shape or q3.shape != v3.shape or q3.dim() != 3:
    raise ValueError(f"flash_forward takes three [BH, T, D] tensors of one "
                     f"shape, got {q3.shape}, {k3.shape}, {v3.shape}")
  if not 0 < valid_len <= q3.shape[1]:
    raise ValueError(f"valid_len {valid_len} outside (0, {q3.shape[1]}]")
  if q3.device.type == "cpu":
    return _flash_forward_plain(q3, k3, v3, causal, valid_len)
  if q3.device.type != "cuda":
    raise ValueError(f"flash_forward: unsupported device {q3.device}")
  if not q3.dtype == k3.dtype == v3.dtype or q3.dtype not in (
      torch.float32, torch.bfloat16):
    raise ValueError(f"flash kernel takes f32 or bf16 q/k/v of one dtype, "
                     f"got {q3.dtype}, {k3.dtype}, {v3.dtype}")
  bh, t, d = q3.shape
  if d not in FLASH_HEAD_DIMS:
    raise ValueError(f"flash kernel head_dim must be one of "
                     f"{FLASH_HEAD_DIMS}, got {d}")
  q3, k3, v3 = q3.contiguous(), k3.contiguous(), v3.contiguous()
  out = torch.empty_like(q3)
  lse = torch.empty((bh, t, 1), dtype=torch.float32, device=q3.device)
  lib = _kernels.library("flash_fwd")
  status = lib.t2r_flash_fwd(
      q3.data_ptr(), k3.data_ptr(), v3.data_ptr(), out.data_ptr(),
      lse.data_ptr(), bh, t, d, int(valid_len), int(bool(causal)),
      0 if q3.dtype == torch.float32 else 1,
      torch.cuda.current_stream(q3.device).cuda_stream)
  _kernels.check("flash_fwd", status)
  flash_forward.launches += 1
  return out, lse


flash_forward.launches = 0


def _next_pow2(n: int) -> int:
  return 1 << (n - 1).bit_length()


def _pow2_floor(n: int) -> int:
  return 1 << (n.bit_length() - 1)


# Minimum block edge (the JAX package's hardware tile floor, kept so both
# packages pad a given T to the same length).
_MIN_BLOCK = 8
# The CUDA kernel's query/key tile (csrc/flash_fwd.cu kBlockM / kBlockN).
_KERNEL_TILE = 64


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False, block_q: int = _KERNEL_TILE,
                    block_k: int = _KERNEL_TILE) -> torch.Tensor:
  """Flash attention forward, [B, H, T, D].

  Blocks are normalized to powers of two in [_MIN_BLOCK, next_pow2(T)],
  and a T that does not tile max(block_q, block_k) is padded to the next
  multiple and masked (never an O(T^2) fallback). Cross-attention
  (Tq != Tk) falls back to `attention`.
  """
  b, h, t, d = q.shape
  if k.shape[2] != t:
    return attention(q, k, v, causal=causal)
  eff_bq = max(_MIN_BLOCK, min(_pow2_floor(block_q), _next_pow2(t)))
  eff_bk = max(_MIN_BLOCK, min(_pow2_floor(block_k), _next_pow2(t)))
  tile = max(eff_bq, eff_bk)
  t_pad = ((t + tile - 1) // tile) * tile
  q3 = q.reshape(b * h, t, d)
  k3 = k.reshape(b * h, t, d)
  v3 = v.reshape(b * h, t, d)
  if t_pad != t:
    pad = (0, 0, 0, t_pad - t)
    q3 = torch.nn.functional.pad(q3, pad)
    k3 = torch.nn.functional.pad(k3, pad)
    v3 = torch.nn.functional.pad(v3, pad)
  out, _ = flash_forward(q3, k3, v3, causal, t)
  if t_pad != t:
    out = out[:, :t]
  return out.reshape(b, h, t, d)
