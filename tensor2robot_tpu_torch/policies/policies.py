"""Policies: predictor-backed action selection for robot control loops.

Counterpart of `tensor2robot_tpu.policies.policies`:

* `Policy`, the contract env loops call;
* `CEMPolicy`, argmax of a critic's q by the cross-entropy method, and
  `LSTMCEMPolicy`, which threads a predictor's `hidden_state` output
  back into its next call;
* `RegressionPolicy` (the regression head of a one-row predict),
  `SequentialRegressionPolicy` (the current timestep's row of an
  episode-shaped output) and `SessionRegressionPolicy` (one decode tick
  of a server-side session per action);
* exploration: `OUNoiseProcess`, `OUExploreRegressionPolicy`,
  `ScheduledExplorationRegressionPolicy` (noise scaled by
  `boundary_schedule_value` of the global step) and
  `PerEpisodeSwitchPolicy` (an explore or a greedy policy per episode).

Their draws are numpy `RandomState`s from the given seeds, as in the JAX
package, so both draw the same numbers.
"""

from __future__ import annotations

import abc
from typing import Any, Dict, Mapping, Optional, Sequence

import numpy as np

from tensor2robot_tpu_torch.obs import metrics as obs_metrics
from tensor2robot_tpu_torch.ops import cem as cem_lib
from tensor2robot_tpu_torch.serving import session as session_lib
from tensor2robot_tpu_torch.utils import config

__all__ = ["Policy", "CEMPolicy", "LSTMCEMPolicy", "RegressionPolicy",
           "SequentialRegressionPolicy", "SessionRegressionPolicy",
           "OUExploreRegressionPolicy",
           "ScheduledExplorationRegressionPolicy", "PerEpisodeSwitchPolicy",
           "OUNoiseProcess", "boundary_schedule_value"]


class Policy(abc.ABC):
  """Action-selection contract for env loops."""

  def __init__(self, predictor=None):
    self._predictor = predictor

  @property
  def predictor(self):
    return self._predictor

  @abc.abstractmethod
  def select_action(self, obs: Mapping[str, Any], explore_prob: float = 0.0
                    ) -> np.ndarray:
    ...

  def SelectAction(self, obs, env=None, timestep: int = 0) -> np.ndarray:  # noqa: N802
    """The reference's name for `select_action`."""
    return self.select_action(obs)

  def sample_action(self, obs, explore_prob: float = 0.0) -> np.ndarray:
    """Adapter used by collect loops; records the action latency."""
    with obs_metrics.histogram("policy/select_action_ms").time_ms():
      return self.select_action(obs, explore_prob=explore_prob)

  def reset(self) -> None:
    """Per-episode state reset."""

  def abort_episode(self) -> None:
    """Mid-episode teardown: release serving-side episode state without
    touching the predictor."""

  def restore(self) -> bool:
    if self._predictor is not None:
      ok = self._predictor.restore()
      # A serving front (`BucketedEngine`, `MicroBatcher`) runs every
      # rung here, before the robot loop starts, instead of on the first
      # action's critical path.
      warm = getattr(self._predictor, "warmup", None)
      if ok and warm is not None:
        warm()
      return ok
    return True

  @property
  def global_step(self) -> int:
    if self._predictor is not None:
      return self._predictor.global_step
    return -1

  def close(self) -> None:
    if self._predictor is not None:
      self._predictor.close()


@config.configurable
class CEMPolicy(Policy):
  """argmax_a Q(s, a) via the host CEM over the critic predictor
  (defaults 64 samples x 3 iterations, 10 elites).

  Each CEM iteration repeats the observation over the candidates and
  sends them through `predictor.predict` (a `MicroBatcher` in front of a
  `BucketedEngine` when served): at 472x472 that is 64 copies of the
  image per iteration, as in the JAX package.
  """

  def __init__(self, predictor=None, action_size: int = None,
               cem_samples: int = 64, cem_iterations: int = 3,
               cem_elites: int = 10,
               action_low: float = -1.0, action_high: float = 1.0,
               q_key: str = "q_predicted", seed: Optional[int] = None):
    super().__init__(predictor)
    if action_size is None:
      raise ValueError("action_size is required.")
    self._cem = cem_lib.CrossEntropyMethod(
        num_samples=cem_samples, num_iterations=cem_iterations,
        num_elites=cem_elites, seed=seed)
    self._low = np.full(action_size, action_low, np.float32)
    self._high = np.full(action_size, action_high, np.float32)
    self._q_key = q_key

  def _objective(self, obs):
    def objective_fn(actions: np.ndarray) -> np.ndarray:
      features = {("state/" + k): np.repeat(
          np.asarray(v)[None], actions.shape[0], axis=0)
          for k, v in dict(obs).items()}
      features["action/action"] = actions
      return self._predictor.predict(features)[self._q_key].reshape(-1)

    return objective_fn

  def select_action(self, obs, explore_prob: float = 0.0) -> np.ndarray:
    if explore_prob > 0.0 and np.random.rand() < explore_prob:
      self.last_q_value = None  # no Q for random actions
      return np.random.uniform(self._low, self._high).astype(np.float32)
    mean = (self._low + self._high) / 2.0
    stddev = (self._high - self._low) / 2.0
    action, score = self._cem.optimize(self._objective(obs), mean, stddev,
                                       low=self._low, high=self._high)
    # Exposed for actor-side Q-value summaries.
    self.last_q_value = score
    return action


class LSTMCEMPolicy(CEMPolicy):
  """CEM policy threading recurrent hidden state between steps: the
  predictor returns `hidden_state`, which the next call feeds back as
  `state/<hidden_state_key>` (the first row of the last CEM batch)."""

  def __init__(self, hidden_state_key: str = "hidden_state", **kwargs):
    super().__init__(**kwargs)
    self._hidden_state_key = hidden_state_key
    self._hidden_state = None
    self._last_outputs = None

  def reset(self) -> None:
    self._hidden_state = None

  def _objective(self, obs):
    hidden = self._hidden_state
    key = self._hidden_state_key

    def objective_fn(actions):
      features = {("state/" + k): np.repeat(
          np.asarray(v)[None], actions.shape[0], axis=0)
          for k, v in dict(obs).items()}
      features["action/action"] = actions
      if hidden is not None:
        features["state/" + key] = np.repeat(hidden, actions.shape[0],
                                             axis=0)
      outputs = self._predictor.predict(features)
      self._last_outputs = outputs
      return outputs[self._q_key].reshape(-1)

    return objective_fn

  def select_action(self, obs, explore_prob: float = 0.0) -> np.ndarray:
    action = super().select_action(obs, explore_prob=explore_prob)
    outputs = self._last_outputs
    if outputs is not None and self._hidden_state_key in outputs:
      self._hidden_state = outputs[self._hidden_state_key][:1]
    return action


@config.configurable
class RegressionPolicy(Policy):
  """The regression head of a one-row predict."""

  def __init__(self, predictor=None, action_key: str = "inference_output"):
    super().__init__(predictor)
    self._action_key = action_key

  def _features(self, obs) -> Dict[str, np.ndarray]:
    return {k: np.asarray(v)[None] for k, v in dict(obs).items()}

  def select_action(self, obs, explore_prob: float = 0.0) -> np.ndarray:
    outputs = self._predictor.predict(self._features(obs))
    return np.asarray(outputs[self._action_key])[0]


@config.configurable
class SequentialRegressionPolicy(RegressionPolicy):
  """Regression over episode-shaped outputs: the current timestep's row
  (the last row once the episode outruns the output)."""

  def __init__(self, **kwargs):
    super().__init__(**kwargs)
    self._timestep = 0

  def reset(self) -> None:
    self._timestep = 0

  def select_action(self, obs, explore_prob: float = 0.0) -> np.ndarray:
    outputs = self._predictor.predict(self._features(obs))
    action_all = np.asarray(outputs[self._action_key])[0]
    if action_all.ndim >= 2:
      action = action_all[min(self._timestep, action_all.shape[0] - 1)]
    else:
      action = action_all
    self._timestep += 1
    return action


@config.configurable
class SessionRegressionPolicy(Policy):
  """Regression policy riding a server-side SESSION: each episode is one
  session whose decode cache lives on the device between control ticks,
  so every `select_action` costs one O(1) decode tick.

  `predictor` is anything with the session surface (`open` / `step` /
  `close_session`: a `SessionEngine` or `SessionBatcher`). `reset()`
  closes the previous episode's session and opens the next; `close()`
  closes a live session too. An eviction surfaces as
  `SessionEvictedError` from `select_action`, and the policy drops its
  session id so a later `reset()` starts clean.
  """

  def __init__(self, predictor=None, action_key: str = "inference_output"):
    super().__init__(predictor)
    self._action_key = action_key
    self._session_id: Optional[int] = None

  @property
  def session_id(self) -> Optional[int]:
    return self._session_id

  def reset(self) -> None:
    self._close_session()
    self._session_id = self._predictor.open()

  def abort_episode(self) -> None:
    """The episode will not resume: free the server-side slot now."""
    self._close_session()

  def _close_session(self) -> None:
    if self._session_id is None:
      return
    sid, self._session_id = self._session_id, None
    try:
      self._predictor.close_session(sid)
    except session_lib.SessionError:
      pass  # already evicted, closed or forgotten server-side

  def select_action(self, obs, explore_prob: float = 0.0) -> np.ndarray:
    if self._session_id is None:
      self.reset()
    features = {k: np.asarray(v) for k, v in dict(obs).items()}
    try:
      outputs = self._predictor.step(self._session_id, features)
    except session_lib.SessionHorizonError:
      # The session is alive and holds its slot: close it.
      self._close_session()
      raise
    except (session_lib.SessionEvictedError, session_lib.SessionClosedError,
            session_lib.UnknownSessionError):
      # The slot is gone server-side: holding the id would mis-route the
      # next episode's ticks.
      self._session_id = None
      raise
    # Any other error (a full queue, a concurrent-tick rejection) keeps
    # the id, so the caller can retry this tick.
    return np.asarray(outputs[self._action_key])

  def close(self) -> None:
    self._close_session()
    super().close()


@config.configurable
class OUNoiseProcess:
  """Ornstein-Uhlenbeck noise: each sample moves the f32 state by
  `-theta * noise + sigma * N(0, 1)` from a `RandomState(seed)`."""

  def __init__(self, action_size: int, theta: float = 0.15,
               sigma: float = 0.2, seed: Optional[int] = None):
    self._theta = theta
    self._sigma = sigma
    self._action_size = action_size
    self._rng = np.random.RandomState(seed)
    self._noise = np.zeros(action_size, np.float32)

  def reset(self) -> None:
    self._noise = np.zeros(self._action_size, np.float32)

  def sample(self) -> np.ndarray:
    self._noise += (-self._theta * self._noise
                    + self._sigma * self._rng.randn(self._action_size))
    return self._noise


def boundary_schedule_value(boundaries: Sequence[int],
                            values: Sequence[float], step: int) -> float:
  """Step-boundary schedule lookup: the value of the last boundary <=
  step (a negative step reads as 0)."""
  step = max(step, 0)
  value = values[0]
  for boundary, v in zip(boundaries, values):
    if step >= boundary:
      value = v
  return value


class OUExploreRegressionPolicy(RegressionPolicy):
  """Regression actions plus `explore_prob` times Ornstein-Uhlenbeck
  noise."""

  def __init__(self, theta: float = 0.15, sigma: float = 0.2,
               action_size: int = None, seed: Optional[int] = None,
               **kwargs):
    super().__init__(**kwargs)
    if action_size is None:
      raise ValueError("action_size is required.")
    self._ou = OUNoiseProcess(action_size, theta=theta, sigma=sigma,
                              seed=seed)

  def reset(self) -> None:
    self._ou.reset()

  def select_action(self, obs, explore_prob: float = 0.0) -> np.ndarray:
    action = super().select_action(obs)
    return action + explore_prob * self._ou.sample()


@config.configurable
class ScheduledExplorationRegressionPolicy(OUExploreRegressionPolicy):
  """OU exploration whose magnitude follows the policy's global step
  through a boundary schedule."""

  def __init__(self, schedule_boundaries: Sequence[int] = (0,),
               schedule_values: Sequence[float] = (1.0,), **kwargs):
    super().__init__(**kwargs)
    if len(schedule_boundaries) != len(schedule_values):
      raise ValueError("boundaries and values must align.")
    self._boundaries = list(schedule_boundaries)
    self._values = list(schedule_values)

  def _scheduled_value(self) -> float:
    return boundary_schedule_value(self._boundaries, self._values,
                                   self.global_step)

  def select_action(self, obs, explore_prob: float = 0.0) -> np.ndarray:
    return super().select_action(obs,
                                 explore_prob=self._scheduled_value())


@config.configurable
class PerEpisodeSwitchPolicy(Policy):
  """Picks the explore or the greedy sub-policy once per episode, at
  `reset()`, with probability `explore_prob` from a `RandomState(seed)`."""

  def __init__(self, explore_policy: Policy = None,
               greedy_policy: Policy = None,
               explore_prob: float = 0.1, seed: Optional[int] = None):
    super().__init__()
    if explore_policy is None or greedy_policy is None:
      raise ValueError("Both sub-policies are required.")
    self._explore_policy = explore_policy
    self._greedy_policy = greedy_policy
    self._explore_prob = explore_prob
    self._rng = np.random.RandomState(seed)
    self._active = greedy_policy

  def reset(self) -> None:
    self._active = (self._explore_policy
                    if self._rng.rand() < self._explore_prob
                    else self._greedy_policy)
    self._active.reset()

  def restore(self) -> bool:
    return self._explore_policy.restore() and self._greedy_policy.restore()

  @property
  def global_step(self) -> int:
    return self._greedy_policy.global_step

  def select_action(self, obs, explore_prob: float = 0.0) -> np.ndarray:
    return self._active.select_action(obs, explore_prob=explore_prob)
