"""Meta-learning policies: condition-on-demo action selection.

Counterpart of `tensor2robot_tpu.meta_learning.meta_policies`:
`MetaLearningPolicy` (an `adapt()` over demo data), `MAMLRegressionPolicy`
and `MAMLCEMPolicy` (the condition split fed beside the live
observation), `ScheduledExplorationMAMLRegressionPolicy` (OU noise on a
global-step schedule), `WTLPolicy` (Watch-Try-Learn: model inputs from the
model's `pack_features` over the previous episodes) and
`FixedLengthSequentialRegressionPolicy` (walks a trajectory output).

A MAML predictor's features are the meta layout (condition/features,
condition/labels, inference/features, each [task=1, samples, ...]); these
policies keep the condition buffer from `adapt()` and splice the live
observation into the inference split. Every action of a MAML predictor
runs the inner gradient steps on the predictor's device, under its
`no_grad`. Draws (CEM, OU noise) are numpy `RandomState`s from the given
seeds, as in the JAX package.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np

from tensor2robot_tpu_torch.ops import cem as cem_lib
from tensor2robot_tpu_torch.policies import policies as policies_lib
from tensor2robot_tpu_torch.utils import config

__all__ = ["MetaLearningPolicy", "MAMLRegressionPolicy", "MAMLCEMPolicy",
           "FixedLengthSequentialRegressionPolicy",
           "ScheduledExplorationMAMLRegressionPolicy", "WTLPolicy"]


class MetaLearningPolicy(policies_lib.Policy):
  """Policy that first adapts to demonstration data."""

  def __init__(self, predictor=None):
    super().__init__(predictor)
    self._condition_features: Optional[Dict[str, np.ndarray]] = None
    self._condition_labels: Optional[Dict[str, np.ndarray]] = None

  def adapt(self, condition_features: Mapping[str, Any],
            condition_labels: Mapping[str, Any]) -> None:
    """Stores the demo (condition) split; arrays are [num_samples, ...]."""
    self._condition_features = {k: np.asarray(v)
                                for k, v in dict(condition_features).items()}
    self._condition_labels = {k: np.asarray(v)
                              for k, v in dict(condition_labels).items()}

  def reset(self) -> None:
    self._condition_features = None
    self._condition_labels = None

  def _meta_features(self, inference_features: Mapping[str, np.ndarray]
                     ) -> Dict[str, np.ndarray]:
    if self._condition_features is None:
      raise ValueError("Call adapt() with demo data before acting.")
    features: Dict[str, np.ndarray] = {}
    for key, value in self._condition_features.items():
      features[f"condition/features/{key}"] = value[None]  # task batch 1
    for key, value in self._condition_labels.items():
      features[f"condition/labels/{key}"] = value[None]
    for key, value in dict(inference_features).items():
      features[f"inference/features/{key}"] = np.asarray(value)[None]
    return features

  def _repeated(self, obs, count: int) -> Dict[str, np.ndarray]:
    """Each observation leaf repeated `count` times on a new first dim."""
    return {k: np.repeat(np.asarray(v)[None], count, axis=0)
            for k, v in dict(obs).items()}


@config.configurable
class MAMLRegressionPolicy(MetaLearningPolicy):
  """Regression through the adapted model: the first inference sample's
  conditioned output."""

  def __init__(self, predictor=None, action_key: str = "inference_output",
               num_inference_samples: int = 1):
    super().__init__(predictor)
    self._action_key = action_key
    self._num_inference = num_inference_samples

  def _conditioned(self, obs) -> np.ndarray:
    outputs = self._predictor.predict(self._meta_features(
        self._repeated(obs, self._num_inference)))
    return np.asarray(outputs["conditioned_output/" + self._action_key])

  def select_action(self, obs, explore_prob: float = 0.0) -> np.ndarray:
    return self._conditioned(obs)[0, 0]  # [task, sample, ...] -> first


@config.configurable
class MAMLCEMPolicy(MetaLearningPolicy):
  """CEM over an adapted critic: each candidate batch goes through the
  inference split, scored by its conditioned q."""

  def __init__(self, predictor=None, action_size: int = None,
               cem_samples: int = 64, cem_iterations: int = 3,
               cem_elites: int = 10, q_key: str = "q_predicted",
               seed: Optional[int] = None):
    super().__init__(predictor)
    if action_size is None:
      raise ValueError("action_size is required.")
    self._action_size = action_size
    self._cem = cem_lib.CrossEntropyMethod(
        num_samples=cem_samples, num_iterations=cem_iterations,
        num_elites=cem_elites, seed=seed)
    self._q_key = q_key

  def select_action(self, obs, explore_prob: float = 0.0) -> np.ndarray:
    def objective(actions: np.ndarray) -> np.ndarray:
      inference = {"state/" + k: v for k, v in
                   self._repeated(obs, actions.shape[0]).items()}
      inference["action/action"] = actions
      outputs = self._predictor.predict(self._meta_features(inference))
      q = np.asarray(outputs["conditioned_output/" + self._q_key])
      return q.reshape(-1)

    best, _ = self._cem.optimize(
        objective, mean=np.zeros(self._action_size),
        stddev=np.ones(self._action_size))
    return best


@config.configurable
class ScheduledExplorationMAMLRegressionPolicy(MAMLRegressionPolicy):
  """MAML regression with step-scheduled Ornstein-Uhlenbeck noise: its
  magnitude follows a global-step boundary schedule, and `sample_action`
  reports is_demo=False so replay writers form MetaExamples correctly."""

  def __init__(self, theta: float = 0.15, sigma: float = 0.2,
               action_size: int = None,
               schedule_boundaries=(0,), schedule_values=(1.0,),
               seed: Optional[int] = None, **kwargs):
    super().__init__(**kwargs)
    if action_size is None:
      raise ValueError("action_size is required.")
    if len(schedule_boundaries) != len(schedule_values):
      raise ValueError("boundaries and values must align.")
    self._ou = policies_lib.OUNoiseProcess(
        action_size, theta=theta, sigma=sigma, seed=seed)
    self._boundaries = list(schedule_boundaries)
    self._values = list(schedule_values)

  def reset(self) -> None:
    """Per-episode reset: zeroes the noise only; the adapted condition
    data survives across episodes until `reset_task`."""
    self._ou.reset()

  def reset_task(self) -> None:
    """Drops the adapted condition data."""
    self._condition_features = None
    self._condition_labels = None

  def get_noise(self) -> np.ndarray:
    scale = policies_lib.boundary_schedule_value(
        self._boundaries, self._values, self.global_step)
    return scale * self._ou.sample()

  def select_action(self, obs, explore_prob: float = 0.0) -> np.ndarray:
    del explore_prob  # the schedule owns the magnitude
    action = super().select_action(obs)
    return action + self.get_noise()

  def sample_action(self, obs, explore_prob: float = 0.0):
    action = self.select_action(obs, explore_prob)
    return action, {"is_demo": False}


@config.configurable
class WTLPolicy(policies_lib.Policy):
  """Watch-Try-Learn serving policy: holds the prior episode data (the
  demo for the trial phase; demo and trial for the retrial phase) and
  builds model inputs with the model's `pack_features(state,
  prev_episode_data, timestep)`, sent through the predictor's
  `predict_preprocessed` (they are the model's layout, not the wire's).
  Episode data entries are (obs, action, reward, ...) tuples."""

  def __init__(self, model=None, predictor=None,
               action_key: str = "inference_output"):
    super().__init__(predictor)
    if model is None:
      raise ValueError("model (providing pack_features) is required.")
    self._model = model
    self._action_key = action_key
    self._prev_episode_data: Optional[list] = None
    self._timestep = 0

  def adapt(self, prev_episode_data) -> None:
    """Sets the conditioning episodes: [demo] or [demo, trial]."""
    self._prev_episode_data = list(prev_episode_data)

  def reset(self) -> None:
    self._timestep = 0

  def reset_task(self) -> None:
    self._prev_episode_data = None
    self._timestep = 0

  def select_action(self, obs, explore_prob: float = 0.0) -> np.ndarray:
    if self._prev_episode_data is None:
      raise ValueError("Call adapt() with episode data before acting.")
    features = self._model.pack_features(obs, self._prev_episode_data,
                                         self._timestep)
    predict = getattr(self._predictor, "predict_preprocessed", None)
    if predict is None:
      raise TypeError(
          f"{type(self._predictor).__name__} does not support model-layout "
          "features (no predict_preprocessed); WTLPolicy requires a "
          "CheckpointPredictor or an ExportedModelPredictor.")
    outputs = predict({k: np.asarray(v) for k, v in features.items()})
    action = np.asarray(outputs[self._action_key])
    # [task=1, inference_ep=1, T, A]: walk the predicted trajectory rows.
    if action.ndim == 4:
      idx = min(self._timestep, action.shape[2] - 1)
      action = action[0, 0, idx]
    elif action.ndim == 3:
      action = action[0, 0]
    else:
      raise ValueError(f"Invalid action rank {action.ndim}.")
    self._timestep += 1
    return action


@config.configurable
class FixedLengthSequentialRegressionPolicy(MAMLRegressionPolicy):
  """Adapted regression over trajectory outputs: walks the waypoint rows,
  one per action."""

  def __init__(self, **kwargs):
    super().__init__(**kwargs)
    self._timestep = 0

  def reset(self) -> None:
    super().reset()
    self._timestep = 0

  def select_action(self, obs, explore_prob: float = 0.0) -> np.ndarray:
    action_all = self._conditioned(obs)[0, 0]
    if action_all.ndim >= 2:
      action = action_all[min(self._timestep, action_all.shape[0] - 1)]
    else:
      action = action_all
    self._timestep += 1
    return action
