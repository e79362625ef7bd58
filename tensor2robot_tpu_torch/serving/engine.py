"""The serving bucket ladder.

Counterpart of `tensor2robot_tpu.serving.engine` (`bucket_ladder` only;
`BucketedEngine` comes with the stateless-serving slice).
"""

from __future__ import annotations

from typing import List

__all__ = ["bucket_ladder"]


def bucket_ladder(max_batch_size: int) -> List[int]:
  """The doubling ladder 1, 2, 4, ... with max always included (a
  non-power-of-two max becomes the top rung: 12 -> [1, 2, 4, 8, 12])."""
  if max_batch_size < 1:
    raise ValueError(f"max_batch_size must be >= 1, got {max_batch_size}")
  ladder = []
  b = 1
  while b < max_batch_size:
    ladder.append(b)
    b *= 2
  ladder.append(max_batch_size)
  return ladder
