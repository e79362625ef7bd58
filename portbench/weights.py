"""Weights from the seed, made on the device in one draw.

Both sides of the comparison get these same tensors (the reference a
float32 copy), so the init is the benchmark's, not the program's. The
rule follows flax's defaults by the leaf's shape and name: a kernel
(rank 2 or more) is a normal clipped at two standard deviations and
scaled by the configuration's `init.kernel` ("lecun": 1/sqrt(fan_in),
the truncated normal's 0.8796 correction included; or a fixed number);
a rank-1 `.weight` (a norm's scale) is 1; every other leaf is 0.
"""

from __future__ import annotations

import math
from typing import Dict, Mapping, Tuple

import torch


def draw(shapes: Mapping[str, Tuple[int, ...]], kernel_init,
         generator: torch.Generator, device) -> Dict[str, torch.Tensor]:
  """{name: float32 tensor} on `device` for every name of `shapes`."""
  kernels = [k for k, s in shapes.items() if len(s) >= 2]
  total = sum(math.prod(shapes[k]) for k in kernels)
  flat = torch.randn((total,), generator=generator, device=device)
  flat.clamp_(-2.0, 2.0)
  out, offset = {}, 0
  for name, shape in shapes.items():
    if len(shape) >= 2:
      n = math.prod(shape)
      fan_in = n // shape[0]
      std = (1.0 / math.sqrt(fan_in) / 0.87962566103423978
             if kernel_init == "lecun" else float(kernel_init))
      out[name] = flat[offset:offset + n].view(shape).mul_(std)
      offset += n
    elif name.endswith(".weight"):
      out[name] = torch.ones(shape, device=device)
    else:
      out[name] = torch.zeros(shape, device=device)
  return out
