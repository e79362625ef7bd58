"""On-device CEM serving: the whole argmax_a Q(s, a) loop on the card.

Counterpart of `tensor2robot_tpu.policies.device_cem`. The sampling
loop, the candidate scoring (one batched critic forward per iteration)
and the elite refit all run on the device through
`ops.cem.cross_entropy_method`, and action selection costs one host
fetch.

The objective follows the JAX package's exactly: it skips the
preprocessor, builds `state/*` by repeating the observation
`cem_samples` times, sets `action/action`, casts for compute and runs the
eval-mode forward on the EMA parameters with the running statistics,
taking `q_predicted` in float32.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from tensor2robot_tpu_torch import modes as modes_lib
from tensor2robot_tpu_torch.ops import cem as cem_lib
from tensor2robot_tpu_torch.policies import policies as policies_lib
from tensor2robot_tpu_torch.utils import config
from tensor2robot_tpu_torch.utils import device as device_lib

__all__ = ["make_device_cem_fn", "DeviceCEMPolicy"]


def make_device_cem_fn(model,
                       action_size: int,
                       cem_samples: int = 64,
                       cem_iterations: int = 3,
                       cem_elites: int = 10,
                       action_low: float = -1.0,
                       action_high: float = 1.0,
                       q_key: str = "q_predicted") -> Callable:
  """Builds select(state, obs_tree, generator=None, draws=None) ->
  (action [action_size], q []), both on the state's device.

  `obs_tree` holds one observation as tensors on that device
  (unbatched state features, keys without the 'state/' prefix).
  `generator` draws the CEM normals; `draws` replaces them (see
  `cross_entropy_method`).
  """

  @torch.no_grad()
  def select(state, obs_tree, generator=None, draws=None):
    device = next(iter(obs_tree.values())).device
    low = torch.full((action_size,), action_low, device=device)
    high = torch.full((action_size,), action_high, device=device)
    repeated = {f"state/{k}": v[None].expand((cem_samples,) + v.shape)
                for k, v in obs_tree.items()}
    params = state.eval_params(use_ema=True)

    def objective(actions):  # [cem_samples, action_size]
      features = dict(repeated)
      features["action/action"] = actions
      outputs, _ = model.inference_network_fn(
          params, state.mutable_state,
          model.cast_features_for_compute(features), modes_lib.PREDICT,
          train=False)
      return outputs[q_key].float().reshape(-1)

    best, score, _ = cem_lib.cross_entropy_method(
        objective, mean=(low + high) / 2.0, stddev=(high - low) / 2.0,
        num_samples=cem_samples, num_iterations=cem_iterations,
        num_elites=cem_elites, low=low, high=high, generator=generator,
        draws=draws)
    return best, score

  return select


@config.configurable
class DeviceCEMPolicy(policies_lib.Policy):
  """Policy over the device CEM, its train state held on the device.

  The normals come from a `torch.Generator` on the policy's device seeded
  from `seed`: every call draws new ones, and a fresh policy with the
  same seed repeats the same actions. Runs on CUDA unless given
  `device='cpu'`.
  """

  def __init__(self, model=None, state=None, action_size: int = None,
               cem_samples: int = 64, cem_iterations: int = 3,
               cem_elites: int = 10, seed: int = 0, device=None, **kwargs):
    super().__init__()
    if model is None or action_size is None:
      raise ValueError("model and action_size are required.")
    self._model = model
    self._device = device_lib.resolve_device(device)
    self._state = None
    if state is not None:
      self.set_state(state)
    self._select = make_device_cem_fn(
        model, action_size, cem_samples=cem_samples,
        cem_iterations=cem_iterations, cem_elites=cem_elites, **kwargs)
    self._generator = torch.Generator(device=self._device).manual_seed(seed)
    self.last_q_value: Optional[float] = None

  def set_state(self, state) -> None:
    """Hot-swaps the served train state (e.g. from a checkpoint poll)."""
    self._state = state.to(self._device)

  def restore(self) -> bool:
    return self._state is not None

  @property
  def global_step(self) -> int:
    if self._state is None:
      return -1
    return int(self._state.step)

  def select_action(self, obs, explore_prob: float = 0.0) -> np.ndarray:
    if self._state is None:
      raise ValueError("No state set; call set_state() first.")
    obs_tree = {k: torch.as_tensor(np.asarray(v), device=self._device)
                for k, v in dict(obs).items()}
    action, score = self._select(self._state, obs_tree, self._generator)
    # One host fetch per action: the action and its score together.
    fetched = torch.cat([action.float(), score.reshape(1)]).cpu().numpy()
    self.last_q_value = float(fetched[-1])
    return fetched[:-1]
