"""The fused batch-norm training forward and its gradient.

flax `nn.BatchNorm` in training, over dim 1 of [N, C] or [N, C, H, W]:
the batch statistics mean = E[x] and the fast variance var = max(E[x^2] -
E[x]^2, 0) over every dim but 1, y = (x - mean) * (rsqrt(var + eps) *
scale) + bias in at least float32, rounded once to x's dtype, and the new
running statistics momentum * running + (1 - momentum) * (mean, var)
(`layers/flax_layers.py` `moments` and `normalize` compute the same
function as a chain of plain ops).

* `batch_norm_train` — (y, new running mean, new running var) through
  the registered operator `t2r::batch_norm_fwd`: on a CUDA tensor the
  three launches of `csrc/batch_norm.cu` (statistics, finalise,
  normalise) or a raise; on a CPU tensor its plain PyTorch version
  (`_batch_norm_forward_plain`). Its autograd formula calls
  `t2r::batch_norm_bwd`: on a CUDA tensor three more launches (the sums
  of dy and dy x^, finalise, dx), on a CPU tensor
  `_batch_norm_backward_plain`. The forward saves x in its own dtype and
  the per-channel mean and rstd, no float32 copy of an activation.
  `batch_norm_train.launches` counts kernel launches, both ways.

The kernels take x without a copy in two layouts (`layout`): rows, [M,
C] with C contiguous (a contiguous [N, C]; channels-last NCHW, M = N*H*W)
and planes, [N, C, H*W] (NCHW-contiguous); they raise on any other. Both
operators are opaque to `torch.compile` and carry fake implementations,
so a compiled step or a traced graph holds one node each way.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch

from tensor2robot_tpu_torch.ops import _kernels

__all__ = ["batch_norm_train", "layout", "takes", "ROWS", "PLANES"]

ROWS, PLANES = 0, 1
KERNEL_DTYPES = (torch.float32, torch.bfloat16)
# Threads of a block of the CUDA passes, and the blocks of 256 threads an
# SM holds at once (2048 threads).
_THREADS = 256
_BLOCKS_PER_SM = 2048 // _THREADS
# A chunk of a plane in the planes layout: 16 16-byte vectors a lane.
_CHUNK_VECTORS = 32 * 16
_sm_counts: Dict[int, int] = {}

Tensors3 = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]
Tensors5 = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
                 torch.Tensor]


def _reduced_dims(x: torch.Tensor) -> Tuple[int, ...]:
  """The dims the statistics reduce over: every dim but 1."""
  return (0,) + tuple(range(2, x.ndim))


def _stat_dtype(x: torch.Tensor) -> torch.dtype:
  """The statistics' dtype: at least float32 (float64 stays)."""
  return torch.promote_types(x.dtype, torch.float32)


def _param_dtype(weight: Optional[torch.Tensor],
                 bias: Optional[torch.Tensor]) -> torch.dtype:
  for p in (weight, bias):
    if p is not None:
      return p.dtype
  return torch.float32


def _layout(x: torch.Tensor) -> Optional[Tuple[int, int, int, int]]:
  if x.ndim == 2 and x.is_contiguous():
    return ROWS, x.shape[0], x.shape[1], 1
  if x.ndim == 4:
    n, c, h, w = x.shape
    if h * w > 1 and x.is_contiguous():
      return PLANES, n, c, h * w
    if x.is_contiguous(memory_format=torch.channels_last):
      return ROWS, n * h * w, c, 1
  return None


def takes(x: torch.Tensor) -> bool:
  """Whether the kernels take x: float32 or bf16 in a layout `layout`
  reads without a copy."""
  return x.dtype in KERNEL_DTYPES and _layout(x) is not None


def layout(x: torch.Tensor) -> Tuple[int, int, int, int]:
  """(ROWS or PLANES, outer, C, inner) of a tensor the kernels take
  without a copy: rows [M, C] with C contiguous (outer M, inner 1), or
  planes [N, C, P] with each (n, c) plane of P = H*W contiguous (outer N,
  inner P). Raises ValueError on any other layout."""
  found = _layout(x)
  if found is None:
    raise ValueError(f"the batch-norm kernels take a contiguous [N, C], or "
                     f"[N, C, H, W] NCHW-contiguous or channels-last; got "
                     f"shape {tuple(x.shape)} strides {x.stride()}")
  return found


def _plan(kind: int, outer: int, c: int, inner: int, width: int,
          sms: int) -> Tuple[int, int, int]:
  """(grid_x, grid_y, split) of the kernels' passes for vectors of
  `width` elements on a card of `sms` SMs. Rows: `split` lanes (a power
  of two up to 32) cover one row's C / width channel groups, grid.y tiles
  the groups, grid.x strides over the rows with at most one wave of
  blocks. Planes: grid.y is the channel, each plane cut into `split`
  chunks, grid.x at most two waves over the channels."""
  wave = sms * _BLOCKS_PER_SM
  if kind == ROWS:
    groups = c // width
    lanes = min(1 << (groups - 1).bit_length(), 32)
    grid_y = -(-groups // lanes)
    rows_per_step = _THREADS // lanes
    grid_x = max(1, min(-(-outer // rows_per_step), -(-wave // grid_y)))
    return grid_x, grid_y, lanes
  chunks = max(1, -(-(inner // width) // _CHUNK_VECTORS))
  grid_x = max(1, min(-(-outer * chunks // (_THREADS // 32)),
                      -(-2 * wave // c)))
  return grid_x, c, chunks


def _sm_count(device: torch.device) -> int:
  index = device.index if device.index is not None else (
      torch.cuda.current_device())
  if index not in _sm_counts:
    _sm_counts[index] = torch.cuda.get_device_properties(
        index).multi_processor_count
  return _sm_counts[index]


def _vector_width(kind: int, c: int, x: torch.Tensor,
                  tensors: Sequence[torch.Tensor]) -> int:
  """16-byte vectors where every pointer is 16-byte aligned and, in rows,
  C is a multiple of the vector; else scalars (1)."""
  width = 16 // x.element_size()
  if kind == ROWS and c % width:
    return 1
  if any(t.data_ptr() % 16 for t in tensors):
    return 1
  return width


def _like(x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
  """t laid out with x's strides, copied only where they differ."""
  if t.stride() == x.stride():
    return t
  out = torch.empty_like(x, dtype=t.dtype)
  out.copy_(t)
  return out


# -- the plain versions ------------------------------------------------------


def _batch_norm_forward_plain(x: torch.Tensor, weight: Optional[torch.Tensor],
                              bias: Optional[torch.Tensor],
                              running_mean: torch.Tensor,
                              running_var: torch.Tensor, momentum: float,
                              epsilon: float) -> Tensors5:
  """The plain PyTorch version of the forward kernels: (y, new running
  mean, new running var, mean, rstd), the statistics [C] in at least
  float32. y is `moments` then `normalize` (`layers/flax_layers.py`),
  the chain the kernels replace, so on the CPU it is theirs."""
  # flax_layers imports this module.
  from tensor2robot_tpu_torch.layers import flax_layers

  mean, var = flax_layers.moments(x, _reduced_dims(x))
  y = flax_layers.normalize(x, mean, var, weight, bias, epsilon)
  mean, var = mean.reshape(-1), var.reshape(-1)
  return (y, momentum * running_mean + (1.0 - momentum) * mean,
          momentum * running_var + (1.0 - momentum) * var, mean,
          torch.rsqrt(var + epsilon))


def _batch_norm_backward_plain(dy: torch.Tensor, x: torch.Tensor,
                               weight: Optional[torch.Tensor],
                               mean: torch.Tensor, rstd: torch.Tensor,
                               param_dtype: torch.dtype) -> Tensors3:
  """The plain PyTorch version of the backward kernels: (dx in x's
  dtype, dscale = sum(dy x^), dbias = sum(dy) in `param_dtype`), with x^ =
  (x - mean) * rstd recomputed from x, and dx = scale * rstd * (dy -
  sum(dy) / M - x^ sum(dy x^) / M). Computed in float64 and rounded once:
  the same quantity as the kernels' float32 passes with their float64
  finalise, more exactly, and the same on any number of CPU threads."""
  dims = _reduced_dims(x)
  shape = (1, -1) + (1,) * (x.ndim - 2)
  dtype = torch.float64
  count = x.numel() // x.shape[1]
  mean, rstd = mean.to(dtype), rstd.to(dtype)
  dyw = dy.to(dtype)
  xhat = (x.to(dtype) - mean.reshape(shape)) * rstd.reshape(shape)
  sum_dy = dyw.sum(dims)
  sum_dy_xhat = (dyw * xhat).sum(dims)
  scale = rstd if weight is None else rstd * weight.to(dtype)
  dx = scale.reshape(shape) * (dyw - (sum_dy / count).reshape(shape)
                               - xhat * (sum_dy_xhat / count).reshape(shape))
  return (dx.to(x.dtype), sum_dy_xhat.to(param_dtype),
          sum_dy.to(param_dtype))


# -- the operators -----------------------------------------------------------


def batch_norm_train(x: torch.Tensor, weight: Optional[torch.Tensor],
                     bias: Optional[torch.Tensor], running_mean: torch.Tensor,
                     running_var: torch.Tensor, momentum: float,
                     epsilon: float) -> Tensors3:
  """flax `nn.BatchNorm` in training over dim 1 of x ([N, C] or [N, C, H,
  W]; `weight` and `bias` [C] or None): (y in x's dtype and layout, the
  new running mean, the new running var). y is differentiable in x,
  weight and bias. A CPU tensor runs the plain version. Any other runs
  the kernels or raises ValueError: x float32 or bf16 in a layout `layout`
  takes, scale and bias one of those dtypes, the running statistics
  float32, and no functorch transform (the operators have no rule for
  one)."""
  c = x.shape[1] if x.ndim >= 2 else -1
  for name, t in (("weight", weight), ("bias", bias),
                  ("running_mean", running_mean),
                  ("running_var", running_var)):
    if t is not None and tuple(t.shape) != (c,):
      raise ValueError(f"batch_norm_train: {name} must be [{c}], got "
                       f"{tuple(t.shape)} for x {tuple(x.shape)}")
  if x.device.type != "cpu":
    if torch._C._are_functorch_transforms_active():
      raise ValueError("batch_norm_train: the kernels' operators have no "
                       "functorch rule (vmap, grad)")
    _check_cuda("batch_norm_train", x, (weight, bias),
                (running_mean, running_var))
    layout(x)
  y, new_mean, new_var, _, _ = torch.ops.t2r.batch_norm_fwd(
      x, weight, bias, running_mean, running_var, float(momentum),
      float(epsilon))
  return y, new_mean, new_var


batch_norm_train.launches = 0

# The operators are defined through `torch.library.define` and `impl`, not
# `torch.library.custom_op`: custom_op wraps each kernel so that its first
# call imports `torch._dynamo`, seconds of a process's start.
_LIB = torch.library.Library("t2r", "FRAGMENT")
_LIB.define("batch_norm_fwd(Tensor x, Tensor? weight, Tensor? bias, "
            "Tensor running_mean, Tensor running_var, float momentum, "
            "float epsilon) -> (Tensor, Tensor, Tensor, Tensor, Tensor)")
_LIB.define("batch_norm_bwd(Tensor dy, Tensor x, Tensor? weight, "
            "Tensor mean, Tensor rstd, ScalarType param_dtype) "
            "-> (Tensor, Tensor, Tensor)")


@torch.library.impl("t2r::batch_norm_fwd", "cpu", lib=_LIB)
def _batch_norm_fwd_cpu(x, weight, bias, running_mean, running_var,
                        momentum, epsilon):
  """`t2r::batch_norm_fwd` on the CPU: the plain version. Its CUDA
  implementation, the kernel launches, is registered below."""
  y, *rest = _batch_norm_forward_plain(x, weight, bias, running_mean,
                                       running_var, momentum, epsilon)
  return (_like(x, y), *rest)


@torch.library.register_fake("t2r::batch_norm_fwd", lib=_LIB)
def _batch_norm_fwd_fake(x, weight, bias, running_mean, running_var,
                         momentum, epsilon):
  c, stat = x.shape[1], _stat_dtype(x)
  running = torch.promote_types(running_mean.dtype, stat)
  return (torch.empty_like(x), x.new_empty((c,), dtype=running),
          x.new_empty((c,), dtype=running), x.new_empty((c,), dtype=stat),
          x.new_empty((c,), dtype=stat))


def _check_cuda(name: str, x: torch.Tensor, params, stats) -> None:
  """What the kernels take: x float32 or bf16 on one CUDA device with
  every operand; `params` (scale and bias, or None) one dtype of float32
  or bf16, contiguous [C]; `stats` float32 contiguous [C]."""
  if x.dtype not in KERNEL_DTYPES:
    raise ValueError(f"{name}: the kernels take float32 or bf16, got "
                     f"{x.dtype}")
  c = x.shape[1]
  given = [p for p in params if p is not None]
  if len({p.dtype for p in given}) > 1 or any(
      p.dtype not in KERNEL_DTYPES for p in given):
    raise ValueError(f"{name}: scale and bias must be one dtype of float32 "
                     f"or bf16, got {[p.dtype for p in given]}")
  for t in given + list(stats):
    if t.device != x.device:
      raise ValueError(f"{name}: operands on more than one device")
    if tuple(t.shape) != (c,) or not t.is_contiguous():
      raise ValueError(f"{name}: per-channel operands must be contiguous "
                       f"[{c}], got {tuple(t.shape)}")
  if any(t.dtype != torch.float32 for t in stats):
    raise ValueError(f"{name}: running and saved statistics must be "
                     f"float32, got {[t.dtype for t in stats]}")


def _stream(x: torch.Tensor) -> int:
  return torch.cuda.current_stream(x.device).cuda_stream


@torch.library.impl("t2r::batch_norm_fwd", "cuda", lib=_LIB)
def _launch_batch_norm_fwd(x, weight, bias, running_mean, running_var,
                           momentum, epsilon):
  _check_cuda("batch_norm_fwd", x, (weight, bias),
              (running_mean, running_var))
  kind, outer, c, inner = layout(x)
  if kind == PLANES and c > 65535:
    raise ValueError(f"batch_norm_fwd: at most 65535 channels in NCHW, got "
                     f"{c}")
  y = torch.empty_like(x)
  new_mean, new_var, mean, rstd = (
      torch.empty(c, dtype=torch.float32, device=x.device) for _ in range(4))
  width = _vector_width(kind, c, x, (x, y))
  grid_x, grid_y, split = _plan(kind, outer, c, inner, width,
                                _sm_count(x.device))
  # The blocks' partial sums [2, grid_x, C], then mul and shift [2, C].
  work = torch.empty(2 * grid_x * c + 2 * c, dtype=torch.float32,
                     device=x.device)
  status = _kernels.library("batch_norm").t2r_batch_norm_fwd(
      x.data_ptr(), y.data_ptr(),
      None if weight is None else weight.data_ptr(),
      None if bias is None else bias.data_ptr(),
      running_mean.data_ptr(), running_var.data_ptr(), new_mean.data_ptr(),
      new_var.data_ptr(), mean.data_ptr(), rstd.data_ptr(), work.data_ptr(),
      work.data_ptr() + 4 * 2 * grid_x * c, kind,
      int(x.dtype == torch.bfloat16), int(width > 1),
      int(_param_dtype(weight, bias) == torch.bfloat16), c, grid_x, grid_y,
      split, outer, inner, float(momentum), float(1.0 - momentum),
      float(epsilon), _stream(x))
  _kernels.check("batch_norm", status, "t2r_batch_norm_fwd")
  batch_norm_train.launches += 3
  return y, new_mean, new_var, mean, rstd


@torch.library.impl("t2r::batch_norm_bwd", "cpu", lib=_LIB)
def _batch_norm_bwd_cpu(dy, x, weight, mean, rstd, param_dtype):
  """`t2r::batch_norm_bwd` on the CPU: the plain version. Its CUDA
  implementation, the kernel launches, is registered below."""
  dx, dscale, dbias = _batch_norm_backward_plain(dy, x, weight, mean, rstd,
                                                 param_dtype)
  return _like(x, dx), dscale, dbias


@torch.library.register_fake("t2r::batch_norm_bwd", lib=_LIB)
def _batch_norm_bwd_fake(dy, x, weight, mean, rstd, param_dtype):
  c = x.shape[1]
  return (torch.empty_like(x), x.new_empty((c,), dtype=param_dtype),
          x.new_empty((c,), dtype=param_dtype))


@torch.library.impl("t2r::batch_norm_bwd", "cuda", lib=_LIB)
def _launch_batch_norm_bwd(dy, x, weight, mean, rstd, param_dtype):
  _check_cuda("batch_norm_bwd", x, (weight,), (mean, rstd))
  if param_dtype not in KERNEL_DTYPES or (
      weight is not None and weight.dtype != param_dtype):
    raise ValueError(f"batch_norm_bwd: param_dtype {param_dtype} against "
                     f"scale {None if weight is None else weight.dtype}")
  kind, outer, c, inner = layout(x)
  if (dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device
      or dy.stride() != x.stride()):
    raise ValueError(f"batch_norm_bwd: dy must have x's shape, dtype and "
                     f"strides: {dy.dtype} {tuple(dy.shape)} {dy.stride()} "
                     f"against {x.dtype} {tuple(x.shape)} {x.stride()}")
  if kind == PLANES and c > 65535:
    raise ValueError(f"batch_norm_bwd: at most 65535 channels in NCHW, got "
                     f"{c}")
  dx = torch.empty_like(x)
  dscale, dbias = (torch.empty(c, dtype=param_dtype, device=x.device)
                   for _ in range(2))
  width = _vector_width(kind, c, x, (dy, x, dx))
  grid_x, grid_y, split = _plan(kind, outer, c, inner, width,
                                _sm_count(x.device))
  # The blocks' partial sums [2, grid_x, C], then dx's coefficients [3, C].
  work = torch.empty(2 * grid_x * c + 3 * c, dtype=torch.float32,
                     device=x.device)
  status = _kernels.library("batch_norm").t2r_batch_norm_bwd(
      dy.data_ptr(), x.data_ptr(),
      None if weight is None else weight.data_ptr(), mean.data_ptr(),
      rstd.data_ptr(), dx.data_ptr(), dscale.data_ptr(), dbias.data_ptr(),
      work.data_ptr(), work.data_ptr() + 4 * 2 * grid_x * c, kind,
      int(x.dtype == torch.bfloat16), int(width > 1),
      int(param_dtype == torch.bfloat16), c, grid_x, grid_y, split, outer,
      inner, _stream(x))
  _kernels.check("batch_norm", status, "t2r_batch_norm_bwd")
  batch_norm_train.launches += 3
  return dx, dscale, dbias


def _batch_norm_fwd_setup_context(ctx, inputs, output):
  x, weight, bias = inputs[:3]
  _, new_mean, new_var, mean, rstd = output
  ctx.save_for_backward(x, weight, mean, rstd)
  ctx.param_dtype = _param_dtype(weight, bias)
  ctx.has_weight, ctx.has_bias = weight is not None, bias is not None
  ctx.mark_non_differentiable(new_mean, new_var, mean, rstd)


def _batch_norm_fwd_backward(ctx, dy, *unused):
  """The gradient of `t2r::batch_norm_fwd`'s y in x, weight and bias:
  `t2r::batch_norm_bwd`. No double backward."""
  del unused
  x, weight, mean, rstd = ctx.saved_tensors
  # dy as autograd hands it over (an expanded constant, another memory
  # format) is copied once into x's layout, which the kernels read it in.
  dx, dscale, dbias = torch.ops.t2r.batch_norm_bwd(
      _like(x, dy), x, weight, mean, rstd, ctx.param_dtype)
  return (dx, dscale if ctx.has_weight else None,
          dbias if ctx.has_bias else None, None, None, None, None)


torch.library.register_autograd(
    "t2r::batch_norm_fwd", _batch_norm_fwd_backward,
    setup_context=_batch_norm_fwd_setup_context, lib=_LIB)
