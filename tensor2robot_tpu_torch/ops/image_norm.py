"""Device-side image normalization that respects the compute dtype.

Counterpart of `tensor2robot_tpu.ops.image_norm`: a uint8 image becomes
[0, 1] in the module's compute dtype (bfloat16 under the bfloat16 policy),
so one float32 activation does not turn the whole tower float32.
"""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["normalize_image"]


def normalize_image(image: torch.Tensor,
                    dtype: Optional[torch.dtype] = None) -> torch.Tensor:
  """uint8 [0, 255] -> float [0, 1] in `dtype` (float32 when None), the
  division rounded in that dtype as the JAX package's is; a float image
  passes through, cast to `dtype` when one is given."""
  if not torch.is_floating_point(image):
    return image.to(dtype or torch.float32) / 255.0
  if dtype is not None and image.dtype != dtype:
    return image.to(dtype)
  return image
