"""Meta-learning environment loop: demo conditioning + adaptation trials.

Counterpart of `tensor2robot_tpu.envs.run_meta_env`:

* `run_meta_env` — for each task (the env reset with the task's index as
  its seed): demo episodes from `demo_policy`, `policy.adapt(...)` on
  what `demo_to_condition_fn` makes of them, then trials, with the mean
  reward per trial index;
* `run_wtl_env` — the Watch-Try-Learn protocol: watch one demo, try
  (`trial_policy.adapt([demo])`), learn (`retrial_policy.adapt([demo,
  trial])`) and retry, with the mean demo, trial and retrial rewards and
  the retrial's gain over the trial.
"""

from __future__ import annotations

import logging
import os
from typing import Callable, Dict, List, Optional

import numpy as np

from tensor2robot_tpu_torch.utils import config
from tensor2robot_tpu_torch.utils import summaries as summaries_lib

__all__ = ["run_meta_env", "run_wtl_env"]

_log = logging.getLogger(__name__)


def _write_stats(root_dir: Optional[str], tag: str, global_step: int,
                 stats: Dict[str, float]) -> None:
  if root_dir is not None:
    with summaries_lib.SummaryWriter(os.path.join(root_dir, tag)) as writer:
      writer.write_scalars(global_step, stats)


@config.configurable
def run_meta_env(env=config.REQUIRED,
                 policy=config.REQUIRED,
                 demo_policy=None,
                 num_tasks: int = 5,
                 num_demos_per_task: int = 1,
                 num_trials_per_task: int = 2,
                 demo_to_condition_fn: Optional[Callable] = None,
                 global_step: int = 0,
                 root_dir: Optional[str] = None,
                 tag: str = "meta_eval") -> Dict[str, float]:
  """For each task: demo episodes -> adapt -> trials; returns per-trial
  mean rewards (`<tag>/reward_trial_<i>`) and their mean."""
  if demo_to_condition_fn is None:
    raise ValueError("demo_to_condition_fn is required: maps a list of "
                     "demo episodes to (condition_features, labels).")
  demo_policy = demo_policy or policy
  per_trial_rewards: List[List[float]] = [
      [] for _ in range(num_trials_per_task)]
  for task_idx in range(num_tasks):
    env.reset(seed=task_idx)
    demos = []
    for _ in range(num_demos_per_task):
      episode = []
      done = False
      demo_obs, _ = env.reset(seed=task_idx)
      while not done:
        action = demo_policy.sample_action(demo_obs)
        next_obs, reward, terminated, truncated, info = env.step(action)
        episode.append({"obs": demo_obs, "action": action,
                        "reward": reward, "info": info})
        demo_obs = next_obs
        done = terminated or truncated
      demos.append(episode)
    condition_features, condition_labels = demo_to_condition_fn(demos)
    policy.reset()
    policy.adapt(condition_features, condition_labels)
    for trial in range(num_trials_per_task):
      obs, _ = env.reset(seed=task_idx)
      total, done = 0.0, False
      while not done:
        action = policy.sample_action(obs)
        obs, reward, terminated, truncated, _ = env.step(action)
        total += float(reward)
        done = terminated or truncated
      per_trial_rewards[trial].append(total)
  stats = {
      f"{tag}/reward_trial_{i}": float(np.mean(rs))
      for i, rs in enumerate(per_trial_rewards)}
  stats[f"{tag}/reward_mean"] = float(
      np.mean([r for rs in per_trial_rewards for r in rs]))
  _write_stats(root_dir, tag, global_step, stats)
  _log.info("run_meta_env @%d: %s", global_step, stats)
  return stats


def _run_episode(env, policy, task_seed: int, obs_to_state_fn):
  """One episode; returns (episode_data, total_reward), the entries
  (state, action, reward) tuples."""
  obs, _ = env.reset(seed=task_seed)
  policy.reset()
  episode, total, done = [], 0.0, False
  while not done:
    state = obs_to_state_fn(obs)
    action = policy.sample_action(state)
    obs, reward, terminated, truncated, _ = env.step(action)
    episode.append((state, np.asarray(action), float(reward)))
    total += float(reward)
    done = terminated or truncated
  return episode, total


@config.configurable
def run_wtl_env(env=config.REQUIRED,
                trial_policy=config.REQUIRED,
                retrial_policy=None,
                demo_policy=None,
                num_tasks: int = 5,
                obs_to_state_fn: Optional[Callable] = None,
                global_step: int = 0,
                root_dir: Optional[str] = None,
                tag: str = "wtl_eval") -> Dict[str, float]:
  """Watch-Try-Learn over env tasks: watch one demo episode of
  `demo_policy`; try, `trial_policy.adapt([demo])` and its episode;
  learn, `retrial_policy.adapt([demo, trial])` and its episode. Returns
  the mean demo, trial and retrial rewards and `retrial_gain`, retrial
  minus trial."""
  if obs_to_state_fn is None:
    obs_to_state_fn = lambda obs: obs
  if demo_policy is None:
    raise ValueError("demo_policy is required (the 'watch' phase).")
  if num_tasks < 1:
    raise ValueError("num_tasks must be >= 1.")
  retrial_policy = retrial_policy or trial_policy
  retrial_model = getattr(retrial_policy, "_model", None)
  if getattr(retrial_model, "num_condition_episodes", 2) < 2:
    _log.warning(
        "run_wtl_env: the retrial policy's model conditions on only one "
        "episode, so adapt([demo, trial]) drops the trial episode and "
        "retrial_gain measures sampling noise. Use a model with "
        "num_condition_episodes >= 2 for the 'learn' phase.")
  demo_rewards, trial_rewards, retrial_rewards = [], [], []
  for task_idx in range(num_tasks):
    demo, demo_reward = _run_episode(env, demo_policy, task_idx,
                                     obs_to_state_fn)
    demo_rewards.append(demo_reward)
    if hasattr(trial_policy, "reset_task"):
      trial_policy.reset_task()
    trial_policy.adapt([demo])
    trial, trial_reward = _run_episode(env, trial_policy, task_idx,
                                       obs_to_state_fn)
    trial_rewards.append(trial_reward)
    if hasattr(retrial_policy, "reset_task"):
      retrial_policy.reset_task()
    retrial_policy.adapt([demo, trial])
    _, retrial_reward = _run_episode(env, retrial_policy, task_idx,
                                     obs_to_state_fn)
    retrial_rewards.append(retrial_reward)
  stats = {
      f"{tag}/reward_demo": float(np.mean(demo_rewards)),
      f"{tag}/reward_trial": float(np.mean(trial_rewards)),
      f"{tag}/reward_retrial": float(np.mean(retrial_rewards)),
      f"{tag}/retrial_gain": float(np.mean(retrial_rewards)
                                   - np.mean(trial_rewards)),
  }
  _write_stats(root_dir, tag, global_step, stats)
  _log.info("run_wtl_env @%d: %s", global_step, stats)
  return stats
