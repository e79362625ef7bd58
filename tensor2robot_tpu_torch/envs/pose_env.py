"""Toy visual pose/reach environment for end-to-end runs.

Counterpart of `tensor2robot_tpu.envs.pose_env`, pure numpy and drawing
from the same `np.random.RandomState` streams, so one seed gives the JAX
package's episodes bit for bit. A target dot is rendered into a 32x32
grayscale image; the action is a 2D position guess in [-1, 1]^2; the
reward is the negative distance. Follows the gymnasium API
(`reset() -> (obs, info)`, `step(a) -> (obs, reward, terminated,
truncated, info)`).

Also `RandomPolicy` (uniform actions) and `episode_to_transitions` (one
replay example per step: the PNG image, the action and the Monte-Carlo
return), whose records are byte-identical to the JAX package's.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from tensor2robot_tpu_torch.utils import config

__all__ = ["PoseToyEnv", "RandomPolicy", "episode_to_transitions"]

IMAGE_SIZE = 32


@config.configurable
class PoseToyEnv:
  """2D reach: observe a rendered target, output its position."""

  action_size = 2

  def __init__(self, image_size: int = IMAGE_SIZE, episode_length: int = 1,
               seed: Optional[int] = None):
    self._image_size = image_size
    self._episode_length = episode_length
    self._rng = np.random.RandomState(seed)
    self._target = np.zeros(2, np.float32)
    self._t = 0

  def _render(self) -> np.ndarray:
    image = np.zeros((self._image_size, self._image_size, 1), np.uint8)
    xy = ((self._target + 1.0) / 2.0 * (self._image_size - 1)).astype(int)
    x, y = int(xy[0]), int(xy[1])
    image[max(y - 1, 0):y + 2, max(x - 1, 0):x + 2, 0] = 255
    return image

  def _obs(self) -> Dict[str, np.ndarray]:
    return {"image": self._render(),
            "timestep": np.asarray(self._t, np.int64)}

  def reset(self, seed: Optional[int] = None
            ) -> Tuple[Dict[str, np.ndarray], Dict]:
    if seed is not None:
      self._rng = np.random.RandomState(seed)
    self._target = self._rng.uniform(-0.9, 0.9, 2).astype(np.float32)
    self._t = 0
    return self._obs(), {"target": self._target.copy()}

  def step(self, action: np.ndarray
           ) -> Tuple[Dict[str, np.ndarray], float, bool, bool, Dict]:
    action = np.asarray(action, np.float32)
    distance = float(np.linalg.norm(action - self._target))
    reward = -distance
    self._t += 1
    terminated = self._t >= self._episode_length
    return self._obs(), reward, terminated, False, {
        "distance": distance, "target": self._target.copy()}


@config.configurable
class RandomPolicy:
  """Uniform random actions in [-1, 1]."""

  def __init__(self, action_size: int = 2, seed: Optional[int] = None):
    self._action_size = action_size
    self._rng = np.random.RandomState(seed)

  def select_action(self, obs, explore_prob: float = 0.0) -> np.ndarray:
    return self._rng.uniform(-1, 1, self._action_size).astype(np.float32)

  def sample_action(self, obs, explore_prob: float = 0.0) -> np.ndarray:
    return self.select_action(obs)

  def reset(self) -> None:
    pass

  def restore(self) -> bool:
    return True

  @property
  def global_step(self) -> int:
    return 0


@config.configurable
def episode_to_transitions(episode: List[Dict[str, Any]]
                           ) -> List[Dict[str, Any]]:
  """Flattens one episode into per-step training examples: PNG image
  bytes, the action and the Monte-Carlo return."""
  from tensor2robot_tpu_torch.data import codec

  transitions = []
  rewards = [step["reward"] for step in episode]
  for i, step in enumerate(episode):
    mc_return = float(sum(rewards[i:]))
    transitions.append({
        "state/image": codec.encode_image(step["obs"]["image"], "png"),
        "action/action": np.asarray(step["action"], np.float32),
        "reward": np.asarray([mc_return], np.float32),
    })
  return transitions
