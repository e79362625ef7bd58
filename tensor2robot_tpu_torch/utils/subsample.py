"""Trajectory subsampling index generators.

Counterpart of `tensor2robot_tpu.utils.subsample`: uniform, random,
first/last-pinned and randomized-boundary index selection, which cut long
episodes to a fixed length. The index functions are numpy on a
`RandomState` (the host pipeline's), copies of the JAX package's, so one
seed gives the same indices; `gather_subsequence` gathers on the
tensor's device.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

__all__ = ["uniform_indices", "random_indices", "pinned_random_indices",
           "boundary_segment_indices", "gather_subsequence"]


def uniform_indices(sequence_length: int, num_samples: int) -> np.ndarray:
  """Consistent-frame-rate indices, last frame ALWAYS included.

  The reference's uniform subsampler (get_uniform_subsample_indices):
  a fixed stride of (L-1)/n anchored at the LAST frame, so the same
  frames are always selected for a given length, the first frame may be
  dropped, and num_samples=1 returns the last frame (NOT an endpoint
  linspace)."""
  idx = np.round(np.arange(num_samples, dtype=np.float64)
                 * (sequence_length - 1) / num_samples)
  idx = (sequence_length - 1) - idx
  return np.sort(idx).astype(np.int64)


def random_indices(sequence_length: int, num_samples: int,
                   rng: Optional[np.random.RandomState] = None
                   ) -> np.ndarray:
  """Sorted random indices, sampled WITH replacement (the reference's
  no-first/last subsampler draws floor(U * L) per slot: duplicates
  allowed even for long sequences)."""
  rng = rng or np.random
  return np.sort(rng.randint(0, sequence_length,
                             size=num_samples)).astype(np.int64)


def pinned_random_indices(sequence_length: int, num_samples: int,
                          rng: Optional[np.random.RandomState] = None
                          ) -> np.ndarray:
  """First/last frames pinned, random middle, the reference recipe
  (get_subsample_indices / get_np_subsample_indices): num_samples=1
  returns one uniformly random frame; long-enough
  sequences draw the middle WITHOUT replacement from the interior
  (shuffle-and-slice); shorter sequences draw WITH replacement over the
  FULL range (endpoints may repeat)."""
  if num_samples < 1:
    raise ValueError(f"num_samples must be >= 1, got {num_samples}")
  rng = rng or np.random
  if num_samples == 1:
    return rng.randint(0, sequence_length, size=(1,)).astype(np.int64)
  if sequence_length >= num_samples:
    interior = np.arange(1, sequence_length - 1)
    rng.shuffle(interior)
    middle = interior[:num_samples - 2]
  else:
    middle = rng.randint(0, sequence_length, size=num_samples - 2)
  return np.sort(np.concatenate(
      [[0], middle, [sequence_length - 1]])).astype(np.int64)


def boundary_segment_indices(sequence_length: int, num_samples: int,
                             rng: Optional[np.random.RandomState] = None
                             ) -> np.ndarray:
  """One random index per equal segment (randomized-boundary generator)."""
  rng = rng or np.random
  boundaries = np.linspace(0, sequence_length, num_samples + 1)
  idx = []
  for lo, hi in zip(boundaries[:-1], boundaries[1:]):
    lo_i, hi_i = int(np.floor(lo)), max(int(np.ceil(hi)) - 1, int(np.floor(lo)))
    idx.append(rng.randint(lo_i, hi_i + 1))
  return np.asarray(idx, np.int64)


def gather_subsequence(sequence: torch.Tensor,
                       indices: torch.Tensor) -> torch.Tensor:
  """Gathers [T, ...] -> [K, ...] on the sequence's device."""
  indices = torch.as_tensor(indices, device=sequence.device)
  return torch.index_select(sequence, 0, indices)
