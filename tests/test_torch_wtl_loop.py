"""Watch-Try-Learn end to end in the port, on the CPU.

The port's counterparts of the JAX package's WTL tests
(`tests/test_wtl_da.py`, whose goal environment, oracle demo and
synthetic task family are reused here): trial and retrial
`WTLStateTrialModel`s trained through `train_eval_model`, served by
`CheckpointPredictor`s behind `WTLPolicy`s, and run through
`run_wtl_env` (watch the oracle demo, try, learn from the trial, retry);
the retrial model reads the prior trial episode and the trial model does
not; on tasks whose target only the trial episode reveals, the retrial
model learns it (held-out loss below 0.05 and below a third of the
trial-only model's after 250 steps of Adam at 3e-3).
"""

import numpy as np
import pytest
import torch

from tensor2robot_tpu_torch import train_eval
from tensor2robot_tpu_torch.data import input_generators
from tensor2robot_tpu_torch.envs import run_meta_env
from tensor2robot_tpu_torch.meta_learning import meta_policies
from tensor2robot_tpu_torch.models import optimizers
from tensor2robot_tpu_torch.parallel import train_step as ts
from tensor2robot_tpu_torch.predictors import predictors
from tensor2robot_tpu_torch.research.vrgripper import models
from tests.test_wtl_da import _GoalEnv, _OracleDemoPolicy, _wtl_batch

torch.set_num_threads(1)

OBS, ACT, T, B = 8, 2, 4, 16
RETRIAL_STEPS = 250


def _tensors(tree):
  return {k: torch.from_numpy(np.asarray(v)) for k, v in tree.items()}


def _model(retrial, **kwargs):
  return models.WTLStateTrialModel(
      obs_size=OBS, action_size=ACT, episode_length=T, retrial=retrial,
      num_condition_episodes=2, num_mixture_components=0, **kwargs)


def test_wtl_protocol_end_to_end(tmp_path):
  env = _GoalEnv()

  def make_model(retrial):
    return models.WTLStateTrialModel(
        obs_size=_GoalEnv.OBS, action_size=2,
        episode_length=_GoalEnv.HORIZON, retrial=retrial,
        num_condition_episodes=2,
        optimizer_fn=lambda: optimizers.create_adam_optimizer(1e-3))

  policies = {}
  for name, retrial in (("trial", False), ("retrial", True)):
    model_dir = str(tmp_path / name)
    train_eval.train_eval_model(
        model=make_model(retrial), model_dir=model_dir, mode="train",
        max_train_steps=2, checkpoint_every_n_steps=2,
        input_generator_train=input_generators.DefaultRandomInputGenerator(
            batch_size=2, seed=0),
        log_every_n_steps=2, device="cpu")
    predictor = predictors.CheckpointPredictor(
        model=make_model(retrial), model_dir=model_dir, device="cpu")
    assert predictor.restore() and predictor.global_step == 2
    policies[name] = meta_policies.WTLPolicy(model=make_model(retrial),
                                             predictor=predictor)
  stats = run_meta_env.run_wtl_env(
      env=env, trial_policy=policies["trial"],
      retrial_policy=policies["retrial"],
      demo_policy=_OracleDemoPolicy(env), num_tasks=2,
      root_dir=str(tmp_path / "wtl_out"))
  assert set(stats) == {f"wtl_eval/{k}" for k in (
      "reward_demo", "reward_trial", "reward_retrial", "retrial_gain")}
  assert stats["wtl_eval/reward_demo"] >= 1.0  # the oracle solves each task
  assert all(np.isfinite(v) for v in stats.values())
  assert (tmp_path / "wtl_out" / "wtl_eval" / "metrics.jsonl").is_file()


@pytest.mark.parametrize("retrial", [True, False])
def test_retrial_reads_the_trial_episode(retrial):
  """Zeroing the trial episode changes the retrial policy's actions and
  leaves the trial-only policy's exactly as they were."""
  features, _ = _wtl_batch(0, 2, OBS, ACT, T)
  mutated = dict(features.items())
  con = np.array(features["condition/features/full_state_pose"])
  con[:, 1] = 0.0
  mutated["condition/features/full_state_pose"] = con
  model = _model(retrial)
  params = model.init_params(torch.Generator().manual_seed(0))
  out1, _ = model.inference_network_fn(params, {}, _tensors(features), "eval")
  out2, _ = model.inference_network_fn(params, {}, _tensors(mutated), "eval")
  delta = float((out1["action"] - out2["action"]).abs().max())
  assert delta > 1e-6 if retrial else delta == 0.0


def test_retrial_beats_trial_only():
  """Fresh tasks every step, evaluated on held-out tasks, so memorising
  the training batch cannot stand in for reading the trial episode."""
  held_f, held_l = _wtl_batch(9999, B, OBS, ACT, T)
  losses = {}
  for retrial in (False, True):
    model = _model(retrial, optimizer_fn=lambda: (
        optimizers.create_adam_optimizer(3e-3)))
    state = ts.create_train_state(model, torch.Generator().manual_seed(0),
                                  "cpu")
    step = ts.make_train_step(model)
    for seed in range(RETRIAL_STEPS):
      f, l = _wtl_batch(seed, B, OBS, ACT, T)
      state, _ = step(state, _tensors(f), _tensors(l))
    losses[retrial] = float(ts.make_eval_step(model)(
        state, _tensors(held_f), _tensors(held_l))["loss"])
  # Only the trial episode reveals the target: the trial-only model can at
  # best regress to the mean (MSE ~ Var(target) = 1/3).
  assert losses[True] < 0.05, losses
  assert losses[True] < losses[False] / 3.0, losses
