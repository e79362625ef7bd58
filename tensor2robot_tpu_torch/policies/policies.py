"""Policies: predictor-backed action selection for robot control loops.

Counterpart of `tensor2robot_tpu.policies.policies` (the `Policy`
contract, `CEMPolicy` and `SessionRegressionPolicy`; `LSTMCEMPolicy` and
the stateless regression policies come with the LSTM, ROADMAP Queue A
item 12).
"""

from __future__ import annotations

import abc
from typing import Any, Mapping, Optional

import numpy as np

from tensor2robot_tpu_torch.obs import metrics as obs_metrics
from tensor2robot_tpu_torch.ops import cem as cem_lib
from tensor2robot_tpu_torch.serving import session as session_lib
from tensor2robot_tpu_torch.utils import config

__all__ = ["Policy", "CEMPolicy", "SessionRegressionPolicy"]


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
