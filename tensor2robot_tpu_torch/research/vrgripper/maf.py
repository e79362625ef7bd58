"""Masked autoregressive flow (MAF) action decoder.

Counterpart of `tensor2robot_tpu.research.vrgripper.maf`: MADE blocks
(masked dense autoregressive nets emitting a per-dim shift and log scale,
output dim d seeing only inputs < d) with reversing permutations between
them. The density pass is parallel matmuls; sampling inverts one
dimension at a time.

`MADE` keeps the JAX package's raw parameters in its [in, out] layout
(`w1`, `b1`, `w_shift`, `w_scale`, `b_shift`, `b_scale`, used as
`x @ (w * mask)`), so `bridge.py` copies them without a transpose; the
masks are non-persistent buffers built from the sizes. A context input
goes through a Dense `context_proj`, whose width the constructor takes
(`context_size`; 0 for none). `MAFDecoder.sample` takes its unit normal
draw as an argument.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["MADE", "MAFDecoder"]

_LOG_SCALE_CLAMP = 5.0


def _made_masks(dim: int, hidden: int) -> Tuple[np.ndarray, np.ndarray]:
  """Input->hidden and hidden->output masks for autoregressive deps."""
  in_degrees = np.arange(1, dim + 1)
  hidden_degrees = (np.arange(hidden) % max(dim - 1, 1)) + 1
  mask_in = (hidden_degrees[None, :] >= in_degrees[:, None]).astype(
      np.float32)  # [dim, hidden]
  out_degrees = np.arange(1, dim + 1)
  mask_out = (out_degrees[None, :] > hidden_degrees[:, None]).astype(
      np.float32)  # [hidden, dim]
  return mask_in, mask_out


def _lecun_normal_in_out(shape, generator: torch.Generator) -> torch.Tensor:
  """flax `lecun_normal()` for an [in, out] kernel (fan_in = in)."""
  weight = torch.empty(shape)
  std = math.sqrt(1.0 / shape[0]) / 0.87962566103423978
  nn.init.trunc_normal_(weight, std=std, a=-2 * std, b=2 * std,
                        generator=generator)
  return weight


class MADE(nn.Module):
  """One autoregressive block: x, context -> (shift, log_scale) per dim."""

  def __init__(self, dim: int, hidden: int = 64, context_size: int = 0):
    super().__init__()
    self.dim = dim
    self.hidden = hidden
    mask_in, mask_out = _made_masks(dim, hidden)
    self.register_buffer("mask_in", torch.from_numpy(mask_in),
                         persistent=False)
    self.register_buffer("mask_out", torch.from_numpy(mask_out),
                         persistent=False)
    self.w1 = nn.Parameter(torch.zeros(dim, hidden))
    self.b1 = nn.Parameter(torch.zeros(hidden))
    self.w_shift = nn.Parameter(torch.zeros(hidden, dim))
    self.w_scale = nn.Parameter(torch.zeros(hidden, dim))
    self.b_shift = nn.Parameter(torch.zeros(dim))
    self.b_scale = nn.Parameter(torch.zeros(dim))
    self.context_proj = (nn.Linear(context_size, hidden) if context_size
                         else None)

  def initial_params(self, generator: torch.Generator
                     ) -> Dict[str, torch.Tensor]:
    """flax's: `w1` and `w_shift` lecun normal, the rest zeros (the
    `context_proj` Dense is visited by `T2RModel.init_params`)."""
    return {"w1": _lecun_normal_in_out((self.dim, self.hidden), generator),
            "b1": torch.zeros(self.hidden),
            "w_shift": _lecun_normal_in_out((self.hidden, self.dim),
                                            generator),
            "w_scale": torch.zeros(self.hidden, self.dim),
            "b_shift": torch.zeros(self.dim),
            "b_scale": torch.zeros(self.dim)}

  def forward(self, x: torch.Tensor,
              context: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    mask_in = self.mask_in.to(self.w1.dtype)
    mask_out = self.mask_out.to(self.w1.dtype)
    h = x @ (self.w1 * mask_in) + self.b1
    if context is not None:
      if self.context_proj is None:
        raise ValueError("MADE was built with context_size=0 and got a "
                         "context")
      h = h + self.context_proj(context)
    h = F.relu(h)
    shift = h @ (self.w_shift * mask_out) + self.b_shift
    log_scale = torch.clamp(h @ (self.w_scale * mask_out) + self.b_scale,
                            -_LOG_SCALE_CLAMP, _LOG_SCALE_CLAMP)
    return shift, log_scale


class MAFDecoder(nn.Module):
  """A stack of MADE blocks (`made_{i}`) with reversing permutations.

  Density direction: u = (x - shift(x)) * exp(-log_scale(x)) per block,
  all parallel. Sampling inverts sequentially per dim."""

  def __init__(self, dim: int, num_blocks: int = 3, hidden: int = 64,
               context_size: int = 0):
    super().__init__()
    self.dim = dim
    self.num_blocks = num_blocks
    for i in range(num_blocks):
      self.add_module(f"made_{i}", MADE(dim, hidden, context_size))

  def _blocks(self):
    return [getattr(self, f"made_{i}") for i in range(self.num_blocks)]

  def log_prob(self, x: torch.Tensor,
               context: Optional[torch.Tensor] = None) -> torch.Tensor:
    """log p(x | context), x: [..., dim]."""
    u = x
    total_log_det = 0.0
    for i, block in enumerate(self._blocks()):
      if i % 2 == 1:
        u = u.flip(-1)
      shift, log_scale = block(u, context)
      u = (u - shift) * torch.exp(-log_scale)
      total_log_det = total_log_det - log_scale.sum(-1)
    base = -0.5 * (u ** 2).sum(-1) - 0.5 * self.dim * math.log(2 * math.pi)
    return base + total_log_det

  def forward(self, x: torch.Tensor,
              context: Optional[torch.Tensor] = None) -> torch.Tensor:
    return self.log_prob(x, context)

  def sample(self, normal: torch.Tensor,
             context: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The inverse pass of a unit `normal` draw [..., dim] (the shape of
    `context.shape[:-1] + (dim,)` where a context is given)."""
    x = normal
    for i, block in reversed(list(enumerate(self._blocks()))):
      # invert one block: x_d = u_d * exp(log_scale(x_<d)) + shift(x_<d)
      y = torch.zeros_like(x)
      for d in range(self.dim):
        shift, log_scale = block(y, context)
        y = y.clone()
        y[..., d] = x[..., d] * torch.exp(log_scale[..., d]) + shift[..., d]
      x = y
      if i % 2 == 1:
        x = x.flip(-1)
    return x

