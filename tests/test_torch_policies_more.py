"""The rest of the port's policies against their JAX twins, on the CPU.

Each pair runs on the same fake predictors (numpy in, numpy out, as
`tests/test_serving.py` fakes them) with the same seeds; both packages
draw from numpy `RandomState`s, so actions, hidden states, noise and
episode switches must agree exactly (f32 arithmetic in the same order):
`LSTMCEMPolicy`, `RegressionPolicy`, `SequentialRegressionPolicy`,
`OUNoiseProcess`, `boundary_schedule_value`, `OUExploreRegressionPolicy`,
`ScheduledExplorationRegressionPolicy` and `PerEpisodeSwitchPolicy`.
"""

import numpy as np
import pytest

from tensor2robot_tpu.policies import policies as jax_policies
from tensor2robot_tpu_torch.policies import policies


class _RecurrentCritic:
  """q = base - |a|_1, where base is the hidden state fed back; emits a
  hidden state that counts calls."""

  def __init__(self):
    self.calls = 0
    self.global_step = 7

  def predict(self, features):
    n = features["action/action"].shape[0]
    hidden = features.get("state/hidden_state")
    base = 0.0 if hidden is None else float(hidden[0, 0])
    self.calls += 1
    return {"q_predicted": base - np.abs(
        features["action/action"]).sum(-1, keepdims=True),
            "hidden_state": np.full((n, 1), self.calls, np.float32)}

  def restore(self):
    return True


class _Regressor:
  """An episode-shaped output [B, 3, 2] that depends on the observation;
  `global_step` is settable."""

  def __init__(self, global_step=0):
    self.global_step = global_step

  def predict(self, features):
    obs = features["obs"]  # [B, 3]
    rows = np.arange(6, dtype=np.float32).reshape(1, 3, 2)
    return {"inference_output": rows + obs.sum(-1)[:, None, None]}

  def restore(self):
    return True


class _Flat(_Regressor):

  def predict(self, features):
    return {"inference_output":
            super().predict(features)["inference_output"][:, 0]}


def _obs(seed):
  return {"obs": np.random.RandomState(seed).randn(3).astype(np.float32)}


def _both(name, **kwargs):
  return (getattr(jax_policies, name)(**kwargs),
          getattr(policies, name)(**kwargs))


def test_lstm_cem_policy_matches_jax():
  twins = [cls(predictor=_RecurrentCritic(), action_size=2, cem_samples=16,
               cem_iterations=2, cem_elites=4, seed=0)
           for cls in (jax_policies.LSTMCEMPolicy, policies.LSTMCEMPolicy)]
  for policy in twins:
    policy.reset()
  for step in range(4):
    if step == 2:
      for policy in twins:
        policy.reset()
    want, got = (p.select_action(_obs(step)) for p in twins)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(twins[1]._hidden_state,
                                  twins[0]._hidden_state)
    assert twins[1].last_q_value == twins[0].last_q_value
  assert twins[1]._hidden_state[0, 0] > 1  # threaded through the calls


def test_regression_policies_match_jax():
  for name, predictor in (("RegressionPolicy", _Flat),
                          ("SequentialRegressionPolicy", _Regressor)):
    twins = _both(name, predictor=predictor())
    for step in range(5):
      if step == 4:
        for policy in twins:
          policy.reset()
      want, got = (p.select_action(_obs(step)) for p in twins)
      np.testing.assert_array_equal(got, want)
      assert got.shape == (2,)
  # The sequential policy steps through the rows, the last one past T.
  policy = policies.SequentialRegressionPolicy(predictor=_Regressor())
  zero = {"obs": np.zeros(3, np.float32)}
  assert [policy.select_action(zero).tolist() for _ in range(4)] == [
      [0, 1], [2, 3], [4, 5], [4, 5]]


def test_ou_noise_and_schedule_match_jax():
  twins = _both("OUNoiseProcess", action_size=3, theta=0.2, sigma=0.3,
                seed=4)
  for i in range(12):
    if i == 6:
      for noise in twins:
        noise.reset()
    want, got = (n.sample().copy() for n in twins)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.float32
  boundaries, values = (0, 10, 100), (1.0, 0.5, 0.1)
  for step in (-5, 0, 9, 10, 99, 100, 1000):
    assert policies.boundary_schedule_value(boundaries, values, step) == \
        jax_policies.boundary_schedule_value(boundaries, values, step)


def test_exploration_policies_match_jax():
  twins = _both("OUExploreRegressionPolicy", predictor=_Flat(),
                action_size=2, seed=1)
  for step in range(6):
    explore = 0.5 if step % 2 else 1.0
    want, got = (p.select_action(_obs(step), explore_prob=explore)
                 for p in twins)
    np.testing.assert_array_equal(got, want)
  for global_step in (0, 50, 500):
    twins = _both("ScheduledExplorationRegressionPolicy",
                  predictor=_Flat(global_step), action_size=2, seed=2,
                  schedule_boundaries=(0, 100), schedule_values=(1.0, 0.1))
    for step in range(3):
      want, got = (p.select_action(_obs(step)) for p in twins)
      np.testing.assert_array_equal(got, want)
  with pytest.raises(ValueError, match="align"):
    policies.ScheduledExplorationRegressionPolicy(
        predictor=_Flat(), action_size=2, schedule_boundaries=(0, 1),
        schedule_values=(1.0,))
  with pytest.raises(ValueError, match="action_size"):
    policies.OUExploreRegressionPolicy(predictor=_Flat())


def test_per_episode_switch_matches_jax():
  def twins_of(module):
    return module.PerEpisodeSwitchPolicy(
        explore_policy=module.OUExploreRegressionPolicy(
            predictor=_Flat(3), action_size=2, seed=5),
        greedy_policy=module.RegressionPolicy(predictor=_Flat(11)),
        explore_prob=0.5, seed=3)

  twins = twins_of(jax_policies), twins_of(policies)
  picked = set()
  for episode in range(12):
    for policy in twins:
      policy.reset()
    for step in range(2):
      want, got = (p.select_action(_obs(episode + step), explore_prob=1.0)
                   for p in twins)
      np.testing.assert_array_equal(got, want)
    picked.add(twins[1]._active is twins[1]._explore_policy)
  assert picked == {True, False}
  assert twins[1].global_step == twins[0].global_step == 11
  assert twins[1].restore() and twins[0].restore()
  with pytest.raises(ValueError, match="sub-policies"):
    policies.PerEpisodeSwitchPolicy(greedy_policy=twins[1])
