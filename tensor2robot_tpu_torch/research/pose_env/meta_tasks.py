"""The pose MAML end task: reach targets offset per task.

The task of the JAX package's `tests/test_convergence.py`
(`TestMAMLEndTaskLearns`) at any image size: each task shifts every
reach target by one offset in [-0.5, 0.5]^2 that only the condition
split's labels reveal, so adaptation, not the image alone, recovers it.
Features and labels are numpy, in `MAMLModel`'s meta layout over
`PoseEnvRegressionModel`.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

__all__ = ["offset_reach_batch"]


def offset_reach_batch(rng: np.random.RandomState, tasks: int, cond: int,
                       inf: int, size: int
                       ) -> Tuple[Dict[str, np.ndarray],
                                  Dict[str, np.ndarray]]:
  """One meta batch: per task a 3x3 dot at a random pixel of a size x
  size image, target = its position in [-1, 1) plus the task's offset;
  the first `cond` samples are the condition split."""
  f_c, l_c, f_i, l_i = [], [], [], []
  half = size / 2
  for _ in range(tasks):
    offset = rng.uniform(-0.5, 0.5, 2).astype(np.float32)
    images, targets = [], []
    for _ in range(cond + inf):
      image = np.zeros((size, size, 1), np.uint8)
      y, x = rng.randint(2, size - 2, 2)
      image[y - 1:y + 2, x - 1:x + 2] = 255
      images.append(image)
      targets.append(np.array([x / half - 1.0, y / half - 1.0],
                              np.float32) + offset)
    images, targets = np.stack(images), np.stack(targets)
    f_c.append(images[:cond])
    l_c.append(targets[:cond])
    f_i.append(images[cond:])
    l_i.append(targets[cond:])
  return ({"condition/features/state/image": np.stack(f_c),
           "condition/labels/target_pose": np.stack(l_c),
           "inference/features/state/image": np.stack(f_i)},
          {"target_pose": np.stack(l_i)})
