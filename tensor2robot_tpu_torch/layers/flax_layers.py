"""flax's Conv, max_pool, BatchNorm and LayerNorm semantics on NCHW tensors.

The JAX package's vision towers use flax's built-in layers, which differ
from torch's stock ones:

* `nn.Conv` and `nn.max_pool` with padding "SAME" pad as TensorFlow does:
  pad_total = max((ceil(n / s) - 1) * s + k - n, 0), pad_total // 2
  before and the rest after, so an odd total pads more at the bottom and
  right. Torch's `padding='same'` refuses strides above 1, and a symmetric
  padding is wrong on an odd total. max_pool pads with -inf. The 1-D
  conv (`conv1d_same`) pads its time axis the same way.
* `nn.Dense(dtype=...)` computes in its `dtype` when one is given and
  else in the promoted dtype of its input and parameters (`dense`): a
  float32 input (a one-hot, a noise draw) lifts a bfloat16 layer to
  float32, where torch's `F.linear` refuses mixed dtypes.
* `nn.BatchNorm`: `momentum` is the decay of the running averages
  (`ra = momentum * ra + (1 - momentum) * batch`); the running variance
  takes the *biased* batch variance, flax's fast E[x^2] - E[x]^2 clamped
  at 0. `use_scale=False` has no weight. `BatchNorm.forward` returns the
  new running statistics instead of writing them, so a train step stays
  pure, as flax's `apply(..., mutable=["batch_stats"])` is.
* `nn.LayerNorm` (eps 1e-6) normalises over the last axis of NHWC: over
  channels, dim 1, here.

Both norms compute their statistics and the normalisation in at least
float32 (flax's `force_float32_reductions`: bfloat16 widens to float32,
float64 stays), with a bfloat16 scale and bias widened, and round once to
the input's dtype.
"""

from __future__ import annotations

import math
import time
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from tensor2robot_tpu_torch.obs import metrics as obs_metrics
from tensor2robot_tpu_torch.obs import trace as obs_trace
from tensor2robot_tpu_torch.ops import batch_norm as batch_norm_ops
from tensor2robot_tpu_torch.parallel import collectives

__all__ = ["same_padding", "conv2d", "conv1d_same", "max_pool", "dense",
           "moments",
           "normalize", "layer_norm", "BatchNorm"]


def same_padding(size: int, kernel: int, stride: int) -> Tuple[int, int]:
  """TF 'SAME' padding of one spatial dim: (before, after)."""
  out = -(-size // stride)
  total = max((out - 1) * stride + kernel - size, 0)
  return total // 2, total - total // 2


def _same_pads(x: torch.Tensor, kernel: Sequence[int],
               stride: Sequence[int]) -> Tuple[int, int, int, int]:
  """(left, right, top, bottom), the order of `F.pad` on NCHW."""
  top, bottom = same_padding(x.shape[2], kernel[0], stride[0])
  left, right = same_padding(x.shape[3], kernel[1], stride[1])
  return left, right, top, bottom


def conv2d(x: torch.Tensor, weight: torch.Tensor,
           bias: Optional[torch.Tensor] = None, stride: int = 1,
           padding: str = "SAME") -> torch.Tensor:
  """flax `nn.Conv` on NCHW with an OIHW weight, 'SAME' or 'VALID'."""
  if padding == "VALID":
    return F.conv2d(x, weight, bias, stride)
  if padding != "SAME":
    raise ValueError(f"padding must be 'SAME' or 'VALID', got {padding!r}")
  left, right, top, bottom = _same_pads(x, weight.shape[2:], (stride, stride))
  if left == right and top == bottom:
    return F.conv2d(x, weight, bias, stride, (top, left))
  return F.conv2d(F.pad(x, (left, right, top, bottom)), weight, bias, stride)


def conv1d_same(x: torch.Tensor, weight: torch.Tensor,
                bias: Optional[torch.Tensor] = None) -> torch.Tensor:
  """flax 1-D `nn.Conv(padding='SAME')`, stride 1, on channels-last
  [B, T, C] with an [out, in, k] weight, in the promoted dtype of input
  and weight: an even kernel pads one more after than before (k = 10:
  4 and 5)."""
  dtype = torch.promote_types(x.dtype, weight.dtype)
  before, after = same_padding(x.shape[-2], weight.shape[-1], 1)
  y = F.conv1d(F.pad(x.to(dtype).transpose(-1, -2), (before, after)),
               weight.to(dtype), None if bias is None else bias.to(dtype))
  return y.transpose(-1, -2)


def max_pool(x: torch.Tensor, window: int, stride: int) -> torch.Tensor:
  """flax `nn.max_pool(..., padding='SAME')` on NCHW: -inf padding."""
  pads = _same_pads(x, (window, window), (stride, stride))
  if any(pads):
    x = F.pad(x, pads, value=float("-inf"))
  return F.max_pool2d(x, window, stride)


def dense(x: torch.Tensor, weight: torch.Tensor,
          bias: Optional[torch.Tensor] = None,
          dtype: Optional[torch.dtype] = None) -> torch.Tensor:
  """flax `nn.Dense(dtype=dtype)` with torch's [out, in] weight."""
  if dtype is None:
    dtype = torch.promote_types(x.dtype, weight.dtype)
  return F.linear(x.to(dtype), weight.to(dtype),
                  None if bias is None else bias.to(dtype))


def _feature_shape(x: torch.Tensor, dim: int) -> Tuple[int, ...]:
  shape = [1] * x.ndim
  shape[dim] = -1
  return tuple(shape)


def _widened(x: torch.Tensor) -> torch.Tensor:
  """x in at least float32."""
  return x.to(torch.promote_types(x.dtype, torch.float32))


def moments(x: torch.Tensor, dims: Sequence[int]
            ) -> Tuple[torch.Tensor, torch.Tensor]:
  """flax's `_compute_stats`: mean and fast variance E[x^2] - E[x]^2
  (clamped at 0) over `dims`, in at least float32, keeping the reduced
  dims."""
  x = _widened(x)
  mean = x.mean(dims, keepdim=True)
  var = torch.clamp(x.square().mean(dims, keepdim=True) - mean.square(),
                    min=0.0)
  return mean, var


def normalize(x: torch.Tensor, mean: torch.Tensor, var: torch.Tensor,
              weight: Optional[torch.Tensor], bias: Optional[torch.Tensor],
              epsilon: float, dim: int = 1) -> torch.Tensor:
  """flax's `_normalize`: (x - mean) * (rsqrt(var + eps) * scale) + bias
  in at least float32, rounded once to x's dtype. `mean` and `var`
  broadcast against x; `weight` and `bias` are per feature on `dim`."""
  shape = _feature_shape(x, dim)
  y = _widened(x) - mean
  mul = torch.rsqrt(var + epsilon)
  if weight is not None:
    mul = mul * _widened(weight).reshape(shape)
  y = y * mul
  if bias is not None:
    y = y + _widened(bias).reshape(shape)
  return y.to(x.dtype)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               epsilon: float = 1e-6, dim: int = 1) -> torch.Tensor:
  """flax `nn.LayerNorm` over the features on `dim` (channels of NCHW)."""
  mean, var = moments(x, (dim,))
  return normalize(x, mean, var, weight, bias, epsilon, dim)


def _global_moments(x: torch.Tensor, dims: Sequence[int], group
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
  """`moments` of a batch sharded over `group` (equal blocks): the sums
  of x and x^2 over every rank's block (one differentiable all-reduce),
  as flax's statistics over the global batch under a mesh."""
  x = _widened(x)
  count = math.prod(x.shape[d] for d in dims) * group.size
  sums = collectives.all_reduce_sum(
      torch.stack([x.sum(dims, keepdim=True),
                   x.square().sum(dims, keepdim=True)]), group)
  mean = sums[0] / count
  var = torch.clamp(sums[1] / count - mean.square(), min=0.0)
  return mean, var


def _backward_span(x: torch.Tensor, y: torch.Tensor, name: str) -> None:
  """Records span `name` on the thread that runs the backward (the
  autograd engine's, on CUDA): from the moment `y`'s gradient is ready to
  the moment `x`'s is."""
  started = []

  def begin(grad):
    started.append(time.perf_counter_ns())

  def end(grad):
    if started:
      begun = started.pop()
      obs_trace.add_complete(name, begun, time.perf_counter_ns() - begun,
                             cat="model")

  y.register_hook(begin)
  x.register_hook(end)


def _fusable(x: torch.Tensor) -> bool:
  """Whether a training forward of `BatchNorm` on x outside a batch group
  goes through the fused operator (`ops.batch_norm`). Off the CPU, every
  float32 or bf16 one, the kernels' dtypes: the operator runs them or
  raises on a rank or layout they do not take (float64, a reference
  precision the kernels do not have, keeps the chain). On the CPU, a
  float32 or bf16 [N, C] or [N, C, H, W] in a layout the kernels read
  without a copy, outside functorch's transforms, which the operator has
  no rule for."""
  if x.device.type != "cpu":
    return x.dtype in batch_norm_ops.KERNEL_DTYPES
  return (batch_norm_ops.takes(x)
          and not torch._C._are_functorch_transforms_active())


class BatchNorm(nn.Module):
  """flax `nn.BatchNorm` over dim 1 of [N, C] or [N, C, H, W].

  Parameters `weight` (absent with `use_scale=False`) and `bias`; buffers
  `running_mean` (zeros) and `running_var` (ones), which the model keeps
  as its mutable state. Inside `collectives.batch_group(group)` (the
  train step on a mesh) the batch statistics cover the whole batch
  sharded over the group. `forward(x, train)` returns (y, new running
  stats): with `train`, y uses the batch statistics and the new stats
  are `momentum * running + (1 - momentum) * batch`; without, y uses the
  running stats and the dict is empty.

  A float32 or bf16 training forward outside a batch group (`_fusable`:
  on the card every one, on the CPU an [N, C] or [N, C, H, W] in a layout
  the kernels read) is one call of the fused operator
  `ops.batch_norm.batch_norm_train` (the CUDA kernels, which raise on an
  input they do not take; on the CPU their plain version) and bumps the
  counter `model/batch_norm/fused`; any other goes through `moments` and
  `normalize` (under a batch group, `_global_moments`).

  While the tracer (`obs.trace`) is on, a training forward is a
  `model/batch_norm` span, and one whose input has a gradient also
  registers two tensor hooks that record its backward as a
  `model/batch_norm.backward` span. With the tracer off, or under
  `torch.compile`, neither is recorded and no hook is registered.
  """

  def __init__(self, num_features: int, use_scale: bool = True,
               momentum: float = 0.99, epsilon: float = 1e-5):
    super().__init__()
    self.momentum = momentum
    self.epsilon = epsilon
    if use_scale:
      self.weight = nn.Parameter(torch.ones(num_features))
    else:
      self.register_parameter("weight", None)
    self.bias = nn.Parameter(torch.zeros(num_features))
    self.register_buffer("running_mean", torch.zeros(num_features))
    self.register_buffer("running_var", torch.ones(num_features))

  def forward(self, x: torch.Tensor, train: bool
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    shape = _feature_shape(x, 1)
    if not train:
      return normalize(x, self.running_mean.reshape(shape),
                       self.running_var.reshape(shape), self.weight,
                       self.bias, self.epsilon), {}
    if torch.compiler.is_compiling() or not obs_trace.get_tracer().enabled:
      return self._train_forward(x)
    with obs_trace.span("model/batch_norm", cat="model"):
      y, new = self._train_forward(x)
      if (x.grad_fn is not None and y.requires_grad
          and not torch._C._are_functorch_transforms_active()):
        _backward_span(x, y, "model/batch_norm.backward")
    return y, new

  def _train_forward(self, x: torch.Tensor
                     ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    dims = (0,) + tuple(range(2, x.ndim))
    group = collectives.current_batch_group()
    if group is None and _fusable(x):
      y, new_mean, new_var = batch_norm_ops.batch_norm_train(
          x, self.weight, self.bias, self.running_mean, self.running_var,
          self.momentum, self.epsilon)
      if not torch.compiler.is_compiling():
        obs_metrics.counter("model/batch_norm/fused").inc()
      return y, {"running_mean": new_mean, "running_var": new_var}
    mean, var = (moments(x, dims) if group is None
                 else _global_moments(x, dims, group))
    decay = self.momentum
    new = {"running_mean": decay * self.running_mean
                           + (1.0 - decay) * mean.detach().reshape(-1),
           "running_var": decay * self.running_var
                          + (1.0 - decay) * var.detach().reshape(-1)}
    return normalize(x, mean, var, self.weight, self.bias, self.epsilon), new
