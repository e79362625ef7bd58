"""Attention ops for the port: plain softmax attention, the one-tick
cached attention, and flash attention with its backward.

Counterpart of `tensor2robot_tpu.ops.attention`. All functions take
[batch, heads, seq, head_dim] ("BHTD") tensors.

* `attention` — plain softmax attention (any device).
* `cached_attention` — one decode tick against a per-session KV cache.
* `flash_attention` — the wrapper: pads a sequence that does not tile to
  the block multiple and masks it, then runs `flash_forward`, whose
  gradient is `flash_backward` (the JAX package's `_flash` custom VJP).
* `flash_forward` — (out, lse) over [batch*heads, T, D], the registered
  operator `t2r::flash_fwd`: the hand-written CUDA kernel
  (`csrc/flash_fwd.cu`) on a CUDA tensor, its plain PyTorch version
  (`_flash_forward_plain`) on a CPU tensor. Its autograd formula
  (`register_autograd`) calls `t2r::flash_bwd`.
* `flash_backward` — (dq, dk, dv) over [batch*heads, T, D], the
  registered operator `t2r::flash_bwd`: the dQ and dK/dV kernels
  (`csrc/flash_bwd.cu`; in f32 after its split pass) on a CUDA tensor,
  its plain PyTorch version (`_flash_backward_plain`) on a CPU tensor.

Both operators, and `t2r::decode_tick` (`ops.decode_kernels`), are
opaque to `torch.compile`: a compiled graph holds the call and launches
the kernel at run time, and each carries a fake implementation and a
flop formula (`torch.utils.flop_counter`), so a compiled step keeps its
kernels, its launch counts and its operation count.
* `ring_attention` — sequence parallelism over a mesh axis: each rank
  keeps its Q block and absorbs one K/V block per hop through the online
  softmax (`_online_block_update`), the blocks passed around the ring by
  `collectives.ppermute`. Plain torch ops, as the JAX package's ring is
  plain XLA.
* `ulysses_attention` — sequence parallelism by head all_to_all: each
  rank attends its head group over the whole sequence with the plain
  `attention` or `flash_attention` (the CUDA kernels on the card).

Both sequence-parallel functions take THIS RANK's blocks [B_l, H, T_l,
D] (the batch over `batch_axis`, T over `axis_name`) and return this
rank's block of the output: in the port's one-process-per-rank model a
rank holds only its block, where the JAX functions take global arrays
into `shard_map`.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch.utils import flop_counter

from tensor2robot_tpu_torch.ops import _kernels
from tensor2robot_tpu_torch.parallel import collectives

__all__ = ["attention", "cached_attention", "flash_attention",
           "flash_forward", "flash_backward",
           "ring_attention", "ulysses_attention"]

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


def _flash_valid(t: int, causal: bool, valid_len: int,
                 device: torch.device) -> torch.Tensor:
  """[T, T] score validity: the causal triangle and the key/row padding
  mask of `valid_len`."""
  pos = torch.arange(t, device=device)
  valid = (pos[None, :] < valid_len) & (pos[:, None] < valid_len)
  if causal:
    valid = valid & (pos[:, None] >= pos[None, :])
  return valid


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
  valid = _flash_valid(t, causal, valid_len, q3.device)
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


def _check_flash_operands(name: str, tensors, valid_len: int) -> str:
  """Validates [BH, T, D] operands of one shape and `valid_len`; returns
  the device type ('cpu' or 'cuda'). On a CUDA device also checks what
  the kernels take: f32 or bf16 of one dtype, head_dim in
  FLASH_HEAD_DIMS."""
  shape = tensors[0].shape
  if len(shape) != 3 or any(x.shape != shape for x in tensors):
    raise ValueError(f"{name} takes [BH, T, D] tensors of one shape, got "
                     f"{[tuple(x.shape) for x in tensors]}")
  if not 0 < valid_len <= shape[1]:
    raise ValueError(f"valid_len {valid_len} outside (0, {shape[1]}]")
  device = tensors[0].device
  if device.type not in ("cpu", "cuda"):
    raise ValueError(f"{name}: unsupported device {device}")
  if any(x.device != device for x in tensors):
    raise ValueError(f"{name}: operands on more than one device")
  if device.type == "cuda":
    dtype = tensors[0].dtype
    if dtype not in (torch.float32, torch.bfloat16) or any(
        x.dtype != dtype for x in tensors):
      raise ValueError(f"flash kernels take f32 or bf16 operands of one "
                       f"dtype, got {[x.dtype for x in tensors]}")
    if shape[2] not in FLASH_HEAD_DIMS:
      raise ValueError(f"flash kernel head_dim must be one of "
                       f"{FLASH_HEAD_DIMS}, got {shape[2]}")
  return device.type


def flash_forward(q3: torch.Tensor, k3: torch.Tensor, v3: torch.Tensor,
                  causal: bool, valid_len: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
  """Flash attention forward over [batch*heads, T, D] (T already padded
  by the caller; keys and rows at or past `valid_len` are masked).

  Returns (out [BH, T, D] in the input dtype, lse [BH, T, 1] f32) through
  the registered operator `t2r::flash_fwd`, so a `torch.export` program
  or a compiled graph records the call: a CPU tensor runs the plain
  version; a CUDA tensor launches `csrc/flash_fwd.cu` or raises (f32 or
  bf16, head_dim in FLASH_HEAD_DIMS). `out` is differentiable in q, k and
  v through `flash_backward`; lse is not. `flash_forward.launches`
  counts kernel launches.
  """
  _check_flash_operands("flash_forward", (q3, k3, v3), valid_len)
  return torch.ops.t2r.flash_fwd(q3, k3, v3, bool(causal), int(valid_len))


flash_forward.launches = 0


@torch.library.custom_op("t2r::flash_fwd", mutates_args=(),
                         device_types="cpu")
def _flash_fwd_op(q3: torch.Tensor, k3: torch.Tensor, v3: torch.Tensor,
                  causal: bool, valid_len: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
  """`t2r::flash_fwd` on the CPU: the plain version. Its CUDA
  implementation, the kernel launch, is registered below. Outputs are
  contiguous on every device, as the fake implementation says."""
  out, lse = _flash_forward_plain(q3, k3, v3, causal, valid_len)
  return out.contiguous(), lse.contiguous()


@_flash_fwd_op.register_fake
def _flash_fwd_fake(q3, k3, v3, causal, valid_len):
  bh, t, _ = q3.shape
  return (q3.new_empty(q3.shape),
          q3.new_empty((bh, t, 1), dtype=torch.float32))


@_flash_fwd_op.register_kernel("cuda")
def _launch_flash_fwd(q3, k3, v3, causal, valid_len):
  # Checked again here: a loaded program calls the operator directly.
  _check_flash_operands("flash_forward", (q3, k3, v3), valid_len)
  bh, t, d = q3.shape
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


def _flash_backward_plain(q3: torch.Tensor, k3: torch.Tensor,
                          v3: torch.Tensor, out: torch.Tensor,
                          lse: torch.Tensor, do: torch.Tensor, causal: bool,
                          valid_len: int
                          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
  """The plain PyTorch version of the flash backward kernels, computed
  all at once, with their numerics: S in f32 from the input dtype, dO
  widened to f32, P, dP and dS in f32, masked entries P = 0 (masked
  before the exp: padded rows carry lse = 0), and dq, dk, dv cast to the
  input dtype at the end."""
  t, d = q3.shape[1], q3.shape[2]
  scale = 1.0 / math.sqrt(d)
  qf, kf, vf, dof = q3.float(), k3.float(), v3.float(), do.float()
  delta = (dof * out.float()).sum(dim=-1, keepdim=True)  # [BH, T, 1]
  scores = torch.einsum("bqd,bkd->bqk", qf, kf) * scale
  valid = _flash_valid(t, causal, valid_len, q3.device)
  p = torch.exp(scores.masked_fill(~valid, float("-inf")) - lse)
  dp = torch.einsum("bqd,bkd->bqk", dof, vf)
  ds = p * (dp - delta) * scale
  dq = torch.einsum("bqk,bkd->bqd", ds, kf)
  dk = torch.einsum("bqk,bqd->bkd", ds, qf)
  dv = torch.einsum("bqk,bqd->bkd", p, dof)
  return dq.to(q3.dtype), dk.to(k3.dtype), dv.to(v3.dtype)


def _tf32(x: torch.Tensor) -> torch.Tensor:
  """f32 `x` rounded to TF32 (10 mantissa bits), to nearest with ties away
  from zero, as `cvt.rna.tf32.f32` rounds: on the int32 view, add half of
  the 13 dropped bits and clear them."""
  bits = x.contiguous().view(torch.int32)
  return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


# The index that position p of each group of 8 of a transposed plane
# holds (`perm8` in csrc/hopper_common.cuh): index j sits at position
# (j >> 1) + 4 (j & 1), so that a score accumulator's registers are the
# tf32 A fragment of the next product.
_PERM8 = (0, 2, 4, 6, 1, 3, 5, 7)
# Order of the planes in the split pass's outputs (`RowPlane` and
# `ColPlane` in csrc/flash_bwd.cu).
_ROW_PLANES = ("q_big", "q_small", "k_big", "k_small", "v_big", "v_small",
               "do_big", "do_small")
_COL_PLANES = ("qt_big", "qt_small", "dot_big", "dot_small", "kt_big",
               "kt_small")


def _split_plane_shapes(bh: int, t: int, d: int):
  """Shapes of the split pass's outputs: rows [8, BH, T, DP] and cols
  [6, BH, DP, T8], DP = max(D, 32) (head_dim 16 is computed at 32), T8 =
  T rounded up to 8."""
  dp, t8 = max(d, 32), -(-t // 8) * 8
  return (len(_ROW_PLANES), bh, t, dp), (len(_COL_PLANES), bh, dp, t8)


def _flash_bwd_split_plain(q3: torch.Tensor, k3: torch.Tensor,
                           v3: torch.Tensor, do: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
  """The plain version of the f32 backward's split pass
  (`flash_bwd_split_kernel`): every f32 operand x as big = tf32(x) and
  small = tf32(x - big), columns past D zero. Returns (rows, cols): the
  planes of Q, K, V and dO ([8, BH, T, DP], `_ROW_PLANES`), and those of
  Q^T, dO^T and K^T ([6, BH, DP, T8], `_COL_PLANES`), whose T index is
  permuted by `_PERM8` in each group of 8, positions past T zero."""
  bh, t, d = q3.shape
  (_, _, _, dp), (_, _, _, t8) = _split_plane_shapes(bh, t, d)
  parts = {}
  for name, x in (("q", q3), ("k", k3), ("v", v3), ("do", do)):
    x = torch.nn.functional.pad(x.float(), (0, dp - d))
    big = _tf32(x)
    parts[name] = (big, _tf32(x - big))
  rows = torch.stack([p for name in ("q", "k", "v", "do")
                      for p in parts[name]])
  order = torch.tensor([8 * (i // 8) + _PERM8[i % 8] for i in range(t8)],
                       device=q3.device)

  def transposed(x):
    x = torch.nn.functional.pad(x, (0, 0, 0, t8 - t))
    return x[:, order, :].transpose(1, 2)

  cols = torch.stack([transposed(p) for name in ("q", "do", "k")
                      for p in parts[name]])
  return rows, cols.contiguous()


def flash_backward(q3: torch.Tensor, k3: torch.Tensor, v3: torch.Tensor,
                   out: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                   causal: bool, valid_len: int
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
  """Flash attention backward over [batch*heads, T, D]: the forward's
  operands, its out and lse [BH, T, 1] f32, and the cotangent `do` of
  out. Returns (dq, dk, dv) in the input dtype, through the registered
  operator `t2r::flash_bwd`.

  delta = rowsum(dO * O) is a torch op, as in the JAX package. A CPU
  tensor runs the plain version; a CUDA tensor launches the dQ and the
  dK/dV kernels of `csrc/flash_bwd.cu` or raises. In f32 the split pass
  (`_launch_flash_bwd_split`) runs first, and both kernels read its
  planes. `flash_backward.launches_dq`, `.launches_dkv` and
  `.launches_split` count launches.
  """
  _check_flash_operands("flash_backward", (q3, k3, v3, out, do), valid_len)
  return torch.ops.t2r.flash_bwd(q3, k3, v3, out, lse, do, bool(causal),
                                 int(valid_len))


@torch.library.custom_op("t2r::flash_bwd", mutates_args=(),
                         device_types="cpu")
def _flash_bwd_op(q3: torch.Tensor, k3: torch.Tensor, v3: torch.Tensor,
                  out: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                  causal: bool, valid_len: int
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
  """`t2r::flash_bwd` on the CPU: the plain version. Its CUDA
  implementation, the kernel launches, is registered below. Outputs are
  contiguous on every device, as the fake implementation says."""
  return tuple(g.contiguous() for g in _flash_backward_plain(
      q3, k3, v3, out, lse, do, causal, valid_len))


@_flash_bwd_op.register_fake
def _flash_bwd_fake(q3, k3, v3, out, lse, do, causal, valid_len):
  return q3.new_empty(q3.shape), k3.new_empty(k3.shape), v3.new_empty(
      v3.shape)


@_flash_bwd_op.register_kernel("cuda")
def _launch_flash_bwd(q3, k3, v3, out, lse, do, causal, valid_len):
  _check_flash_operands("flash_backward", (q3, k3, v3, out, do), valid_len)
  bh, t, d = q3.shape
  if lse.shape != (bh, t, 1) or lse.dtype != torch.float32:
    raise ValueError(f"lse must be f32 [{bh}, {t}, 1], got {lse.dtype} "
                     f"{tuple(lse.shape)}")
  q3, k3, v3, do, lse = (x.contiguous() for x in (q3, k3, v3, do, lse))
  delta = (do.float() * out.float()).sum(dim=-1).contiguous()  # [BH, T]
  planes = (_launch_flash_bwd_split(q3, k3, v3, do)
            if q3.dtype == torch.float32 else None)
  dq = _launch_flash_bwd_dq(q3, k3, v3, do, lse, delta, causal, valid_len,
                            planes)
  dk, dv = _launch_flash_bwd_dkv(q3, k3, v3, do, lse, delta, causal,
                                 valid_len, planes)
  return dq, dk, dv


def _flash_fwd_setup_context(ctx, inputs, output):
  q3, k3, v3, causal, valid_len = inputs
  out, lse = output
  ctx.save_for_backward(q3, k3, v3, out, lse)
  ctx.causal, ctx.valid_len = causal, valid_len
  ctx.mark_non_differentiable(lse)


def _flash_fwd_backward(ctx, dout, dlse):
  """The gradient of `t2r::flash_fwd`'s out: `t2r::flash_bwd` (lse is not
  differentiable). No double backward."""
  del dlse
  q3, k3, v3, out, lse = ctx.saved_tensors
  dq, dk, dv = torch.ops.t2r.flash_bwd(q3, k3, v3, out, lse,
                                       dout.contiguous(), ctx.causal,
                                       ctx.valid_len)
  return dq, dk, dv, None, None


_flash_fwd_op.register_autograd(_flash_fwd_backward,
                                setup_context=_flash_fwd_setup_context)


def _launch_flash_bwd_split(q3, k3, v3, do):
  """Launches the split pass of `csrc/flash_bwd.cu` on f32 CUDA operands
  (already validated, contiguous); counts the launch. Returns (rows,
  cols), the planes `_flash_bwd_split_plain` computes."""
  bh, t, d = q3.shape
  rows_shape, cols_shape = _split_plane_shapes(bh, t, d)
  rows = torch.empty(rows_shape, dtype=torch.float32, device=q3.device)
  cols = torch.empty(cols_shape, dtype=torch.float32, device=q3.device)
  status = _kernels.library("flash_bwd").t2r_flash_bwd_split(
      q3.data_ptr(), k3.data_ptr(), v3.data_ptr(), do.data_ptr(),
      rows.data_ptr(), cols.data_ptr(), bh, t, d,
      torch.cuda.current_stream(q3.device).cuda_stream)
  _kernels.check("flash_bwd", status, "t2r_flash_bwd_split")
  flash_backward.launches_split += 1
  return rows, cols


def _bwd_args(q3, k3, v3, do, lse, delta, causal, valid_len, planes):
  """The pointer operands and the trailing ints + stream of both
  backward launch functions (inputs already validated, contiguous;
  `planes` the split pass's (rows, cols) in f32, None in bf16)."""
  bh, t, d = q3.shape
  f32 = q3.dtype == torch.float32
  if f32 != (planes is not None):
    raise ValueError("the f32 backward kernels take the split pass's planes "
                     "and the bf16 ones none")
  rows, cols = (p.data_ptr() for p in planes) if f32 else (None, None)
  operands = (q3.data_ptr(), k3.data_ptr(), v3.data_ptr(), do.data_ptr(),
              lse.data_ptr(), delta.data_ptr(), rows, cols)
  common = (bh, t, d, int(valid_len), int(bool(causal)), 0 if f32 else 1,
            torch.cuda.current_stream(q3.device).cuda_stream)
  return operands, common


def _launch_flash_bwd_dq(q3, k3, v3, do, lse, delta, causal, valid_len,
                         planes):
  """Launches the dQ kernel of `csrc/flash_bwd.cu`; counts the launch."""
  operands, common = _bwd_args(q3, k3, v3, do, lse, delta, causal, valid_len,
                               planes)
  dq = torch.empty_like(q3)
  status = _kernels.library("flash_bwd").t2r_flash_bwd_dq(
      *operands, dq.data_ptr(), *common)
  _kernels.check("flash_bwd", status, "t2r_flash_bwd_dq")
  flash_backward.launches_dq += 1
  return dq


def _launch_flash_bwd_dkv(q3, k3, v3, do, lse, delta, causal, valid_len,
                          planes):
  """Launches the dK/dV kernel of `csrc/flash_bwd.cu`; counts the launch."""
  operands, common = _bwd_args(q3, k3, v3, do, lse, delta, causal, valid_len,
                               planes)
  dk, dv = torch.empty_like(k3), torch.empty_like(v3)
  status = _kernels.library("flash_bwd").t2r_flash_bwd_dkv(
      *operands, dk.data_ptr(), dv.data_ptr(), *common)
  _kernels.check("flash_bwd", status, "t2r_flash_bwd_dkv")
  flash_backward.launches_dkv += 1
  return dk, dv


flash_backward.launches_dq = 0
flash_backward.launches_dkv = 0
flash_backward.launches_split = 0


def _attention_products(q_shape, causal: bool) -> int:
  """FLOPs of one [T, T] x D product over [BH, T, D] operands: 2·BH·T²·D,
  halved when causal (the bound column of `PERF.md`'s kernel table)."""
  bh, t, d = q_shape
  return 2 * bh * t * t * d // (2 if causal else 1)


@flop_counter.register_flop_formula(torch.ops.t2r.flash_fwd)
def _flash_fwd_flops(q3_shape, k3_shape, v3_shape, causal, valid_len,
                     out_shape=None, **kwargs) -> int:
  """S = QK^T and O = PV: two products."""
  return 2 * _attention_products(q3_shape, causal)


@flop_counter.register_flop_formula(torch.ops.t2r.flash_bwd)
def _flash_bwd_flops(q3_shape, k3_shape, v3_shape, out_shape_, lse_shape,
                     do_shape, causal, valid_len, out_shape=None,
                     **kwargs) -> int:
  """dQ recomputes S and forms dP and dQ (three products); dK/dV
  recomputes S and forms dP, dV and dK (four)."""
  return 7 * _attention_products(q3_shape, causal)


def _next_pow2(n: int) -> int:
  return 1 << (n - 1).bit_length()


def _pow2_floor(n: int) -> int:
  return 1 << (n.bit_length() - 1)


# Minimum block edge (the JAX package's hardware tile floor, kept so both
# packages pad a given T to the same length).
_MIN_BLOCK = 8
# The default block edge of `flash_attention`, which pads T to a multiple
# of it (the JAX package pads to its blocks the same way). The kernels
# take any T: their TMA loads fill rows past T with zeros, per head.
_KERNEL_TILE = 64


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False, block_q: int = _KERNEL_TILE,
                    block_k: int = _KERNEL_TILE) -> torch.Tensor:
  """Flash attention, [B, H, T, D], differentiable on every device through
  `flash_forward`'s gradient (the flash backward kernels on a CUDA
  tensor).

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


# -- the online-softmax block update (the ring's) ------------------------------


def _online_block_update(q, k_blk, v_blk, m_prev, l_prev, o_prev,
                         score_mask=None):
  """Absorbs one K/V block into the running (max, denominator, output).

  q: [..., Tq, D]; k_blk / v_blk: [..., Tk, D]; m_prev / l_prev:
  [..., Tq] f32; o_prev: [..., Tq, D] f32 (the unnormalized numerator);
  `score_mask` (broadcast against [..., Tq, Tk]) is True where a score
  counts. Scores and the products accumulate in f32. Returns the new
  (m, l, o)."""
  scale = 1.0 / math.sqrt(q.shape[-1])
  s = torch.einsum("...qd,...kd->...qk", q.float(), k_blk.float()) * scale
  if score_mask is not None:
    s = s.masked_fill(~score_mask, _mask_value(s.dtype))
  m_new = torch.maximum(m_prev, s.amax(dim=-1))
  alpha = torch.exp(m_prev - m_new)
  p = torch.exp(s - m_new[..., None])
  l_new = l_prev * alpha + p.sum(dim=-1)
  o_new = (o_prev * alpha[..., None]
           + torch.einsum("...qk,...kd->...qd", p.to(v_blk.dtype).float(),
                          v_blk.float()))
  return m_new, l_new, o_new


def _finalize(o: torch.Tensor, l: torch.Tensor) -> torch.Tensor:
  return o / l[..., None].clamp_min(1e-30)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   mesh, axis_name: str = "sp", causal: bool = False,
                   batch_axis: Optional[str] = "data",
                   block_k: Optional[int] = None) -> torch.Tensor:
  """Exact attention with T split over `axis_name` (size S).

  q, k, v are this rank's blocks [B_l, H, T_l, D] (module docstring).
  The rank keeps its Q block and absorbs one K/V block per hop, S hops,
  the K/V blocks passed to the next rank of the axis between hops; the
  causal mask compares global positions (this rank's Q block starts at
  `axis_index * T_l`, the block held at hop j came from rank index - j).
  `block_k` streams each hop's block through the online softmax in
  chunks of that many keys (bounding the scores held at once at [B_l, H,
  T_l, block_k]); it must divide T_l. Returns this rank's output block
  in q's dtype. `batch_axis` names the batch's axis, for the JAX
  signature: the batch needs no communication here."""
  del batch_axis
  axis_size = mesh.shape[axis_name]
  t_local = k.shape[2]
  if block_k is not None and t_local % block_k:
    raise ValueError(
        f"block_k={block_k} must divide the per-device K length "
        f"{t_local} (T={t_local * axis_size} over {axis_size} "
        f"'{axis_name}' shards)")
  group = mesh.group(axis_name)
  idx = collectives.axis_index(mesh, axis_name)
  tq = q.shape[2]
  m = torch.full(q.shape[:-1], float("-inf"), dtype=torch.float32,
                 device=q.device)
  l = torch.zeros(q.shape[:-1], dtype=torch.float32, device=q.device)
  o = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
  q_pos = idx * tq + torch.arange(tq, device=q.device)
  chunk = block_k or t_local
  k_blk, v_blk = k, v
  for step in range(axis_size):
    src = (idx - step) % axis_size  # whose block this rank holds now
    for start in range(0, t_local, chunk):
      mask = None
      if causal:
        k_pos = src * t_local + start + torch.arange(chunk, device=q.device)
        mask = q_pos[:, None] >= k_pos[None, :]
      m, l, o = _online_block_update(q, k_blk[:, :, start:start + chunk],
                                     v_blk[:, :, start:start + chunk], m, l,
                                     o, mask)
    if step + 1 < axis_size:
      perm = [(i, (i + 1) % axis_size) for i in range(axis_size)]
      k_blk = collectives.ppermute(k_blk, group, perm)
      v_blk = collectives.ppermute(v_blk, group, perm)
  return _finalize(o, l).to(q.dtype)


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      mesh, axis_name: str = "sp", causal: bool = False,
                      batch_axis: Optional[str] = "data",
                      inner: str = "reference") -> torch.Tensor:
  """Exact attention with T split over `axis_name` (size S), by head
  all_to_all (DeepSpeed-Ulysses).

  q, k, v are this rank's blocks [B_l, H, T_l, D]. An all_to_all turns
  each into [B_l, H/S, T, D] (this rank's head group over the whole
  sequence, the sources in sequence order), the inner attention runs
  unchanged on it, causal mask included, and the inverse all_to_all
  returns this rank's T block of every head. `inner` is 'reference'
  (`attention`) or 'flash' (`flash_attention`: on the card the forward
  and the dQ and dK/dV kernels, at B_l x H/S heads over the full T).
  Needs H % S == 0."""
  del batch_axis
  s = mesh.shape[axis_name]
  b_l, h, t_l, d = q.shape
  if h % s:
    raise ValueError(f"num_heads={h} must be divisible by the "
                     f"'{axis_name}' axis size {s} for Ulysses "
                     f"(head-group all_to_all)")
  if k.shape[2] != t_l:
    raise ValueError("ulysses_attention assumes self-attention layout "
                     f"(Tq={t_l} != Tk={k.shape[2]})")
  if inner not in ("reference", "flash"):
    raise ValueError(f"Unknown inner kernel {inner!r}")
  group = mesh.group(axis_name)

  def seq_to_heads(x):
    # [B_l, H, T_l, D] -> [S, B_l, H/S, T_l, D] -(a2a)-> source-major ->
    # [B_l, H/S, S * T_l, D]: the source order is the sequence order.
    x = x.reshape(b_l, s, h // s, t_l, d).movedim(1, 0)
    x = collectives.all_to_all(x.contiguous(), group)
    return x.permute(1, 2, 0, 3, 4).reshape(b_l, h // s, s * t_l, d)

  def heads_to_seq(x):
    # [B_l, H/S, T, D] -> [S, B_l, H/S, T_l, D] -(a2a)-> group-major ->
    # [B_l, H, T_l, D].
    x = x.reshape(b_l, h // s, s, t_l, d).permute(2, 0, 1, 3, 4)
    x = collectives.all_to_all(x.contiguous(), group)
    return x.movedim(0, 1).reshape(b_l, h, t_l, d)

  q_g, k_g, v_g = seq_to_heads(q), seq_to_heads(k), seq_to_heads(v)
  if inner == "flash":
    out = flash_attention(q_g, k_g, v_g, causal=causal)
  else:
    out = attention(q_g, k_g, v_g, causal=causal)
  return heads_to_seq(out)
