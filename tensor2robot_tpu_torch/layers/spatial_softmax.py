"""Spatial soft arg-max: feature maps -> expected 2D feature points.

Counterpart of `tensor2robot_tpu.layers.spatial_softmax` on the port's
NCHW layout: a softmax over each channel's H x W extent, in at least
float32, then the expected (x, y) of that distribution over a grid in
[-1, 1] (x runs along W, y along H), in the tower's dtype. The output is
[B, C * 2] with (x, y) interleaved per channel, the JAX package's order.

Gumbel sampling adds -log(-log(u + 1e-10)) noise to the logits, u uniform
in [1e-10, 1). The JAX package draws u from flax's "dropout" stream
(threefry); here it comes from an explicit `torch.Generator`, so the two
draw other numbers for one seed. Parity tests leave sampling off or pass
the draws in (`uniform=`).
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
from torch import nn

__all__ = ["SpatialSoftmax", "spatial_softmax", "GUMBEL_MIN"]

GUMBEL_MIN = 1e-10  # the JAX package's uniform minval and log offset


def _grid(h: int, w: int, dtype: torch.dtype, device) -> torch.Tensor:
  """[H * W, 2]: (x, y) of each pixel in row-major order, as
  `jnp.meshgrid(linspace(-1, 1, w), linspace(-1, 1, h))` ravels them;
  the linspace in at least float32, as JAX's default dtype is."""
  wide = torch.promote_types(dtype, torch.float32)
  pos_y, pos_x = torch.meshgrid(
      torch.linspace(-1.0, 1.0, h, device=device, dtype=wide),
      torch.linspace(-1.0, 1.0, w, device=device, dtype=wide),
      indexing="ij")
  return torch.stack([pos_x.reshape(-1), pos_y.reshape(-1)],
                     dim=-1).to(dtype)


def spatial_softmax(features: torch.Tensor,
                    temperature: Optional[torch.Tensor] = None,
                    uniform: Optional[torch.Tensor] = None) -> torch.Tensor:
  """[B, C, H, W] -> [B, C * 2] expected (x, y) in [-1, 1] per channel.

  `temperature` divides the logits; `uniform`, draws in [1e-10, 1) of
  shape [B, C, H * W], adds their Gumbel noise."""
  if features.ndim != 4:
    raise ValueError(f"Expected [B,C,H,W], got {tuple(features.shape)}")
  b, c, h, w = features.shape
  logits = features.to(torch.promote_types(features.dtype, torch.float32))
  if temperature is not None:
    logits = logits / temperature
  flat = logits.reshape(b, c, h * w)
  if uniform is not None:
    flat = flat - torch.log(-torch.log(uniform.to(flat.dtype) + GUMBEL_MIN))
  # The softmax runs in at least f32; the expectation in the tower's
  # dtype, so a bf16 tower stays bf16 downstream.
  attention = torch.softmax(flat, dim=-1).to(features.dtype)
  points = attention @ _grid(h, w, features.dtype, features.device)
  return points.reshape(b, c * 2)


class SpatialSoftmax(nn.Module):
  """Module wrapper with an optional learned temperature
  (`log_temperature`, initialised at log(initial_temperature)) and
  optional Gumbel sampling in train mode, drawn from `generator` (a
  CPU generator seeded 0 when None)."""

  def __init__(self, learn_temperature: bool = False,
               initial_temperature: float = 1.0,
               gumbel_sampling: bool = False,
               generator: Optional[torch.Generator] = None):
    super().__init__()
    self.initial_temperature = initial_temperature
    self.gumbel_sampling = gumbel_sampling
    self.generator = generator
    if learn_temperature:
      self.log_temperature = nn.Parameter(
          torch.tensor(math.log(initial_temperature)))
    else:
      self.register_parameter("log_temperature", None)

  def initial_params(self, generator: torch.Generator
                     ) -> Dict[str, torch.Tensor]:
    del generator  # a constant
    if self.log_temperature is None:
      return {}
    return {"log_temperature": torch.tensor(
        math.log(self.initial_temperature), dtype=torch.float32)}

  def forward(self, features: torch.Tensor,
              train: bool = False) -> torch.Tensor:
    temperature = (None if self.log_temperature is None
                   else torch.exp(self.log_temperature))
    uniform = None
    if self.gumbel_sampling and train:
      if self.generator is None:
        self.generator = torch.Generator().manual_seed(0)
      b, c, h, w = features.shape
      uniform = torch.rand((b, c, h * w), generator=self.generator,
                           device=self.generator.device)
      uniform = (GUMBEL_MIN + uniform * (1.0 - GUMBEL_MIN)).to(
          features.device)
    return spatial_softmax(features, temperature, uniform)
