"""Generic environment episode loop + continuous collect/eval loop.

Counterpart of `tensor2robot_tpu.envs.run_env`:

* `run_env` — the actor's episode loop: explore schedule, reward and Q
  summaries, replay writing;
* `TFAgentsEnvAdapter` / `run_tfagents_env` — the same loop over a
  TF-Agents-style env (duck-typed: no tf_agents import);
* `collect_eval_loop` — poll the policy for a new version, run collect
  episodes into a replay file, run eval episodes, repeat until
  `max_steps`.

Envs follow the gymnasium 5-tuple step API; policies are
`tensor2robot_tpu_torch.policies` objects (select_action / reset /
restore), whose predictors run on the card unless built with
`device='cpu'`.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from tensor2robot_tpu_torch.data import replay_writer as writer_lib
from tensor2robot_tpu_torch.obs import metrics as obs_metrics
from tensor2robot_tpu_torch.obs import trace as obs_trace
from tensor2robot_tpu_torch.utils import config
from tensor2robot_tpu_torch.utils import summaries as summaries_lib

__all__ = ["run_env", "run_tfagents_env", "TFAgentsEnvAdapter",
           "collect_eval_loop"]

_log = logging.getLogger(__name__)

EpisodeToTransitionsFn = Callable[[List[Dict[str, Any]]], List[Any]]


@config.configurable
def run_env(env=config.REQUIRED,
            policy=config.REQUIRED,
            num_episodes: int = 10,
            explore_schedule: Optional[Callable[[int], float]] = None,
            global_step: int = 0,
            root_dir: Optional[str] = None,
            tag: str = "collect",
            episode_to_transitions_fn: Optional[EpisodeToTransitionsFn] = None,
            replay_writer: Optional[writer_lib.TFRecordReplayWriter] = None,
            max_episode_steps: Optional[int] = None,
            log_stats: bool = True) -> Dict[str, float]:
  """Runs episodes; returns aggregate reward stats.

  An env or policy exception mid-episode still releases the policy's
  serving-side episode state (`Policy.abort_episode`: a session-backed
  policy closes its server-side slot), is counted in
  `env/aborted_episodes`, and then propagates unchanged; a failing
  `abort_episode` is logged and does not mask it. `log_stats=False`
  silences the per-call info log for callers that run one episode per
  call."""
  explore_prob = (explore_schedule(global_step) if explore_schedule
                  else 0.0)
  episode_rewards: List[float] = []
  episode_lengths: List[int] = []
  q_values: List[float] = []
  for episode_idx in range(num_episodes):
    with obs_trace.span("env/episode", cat="env", tag=tag,
                        episode=episode_idx), \
        obs_metrics.histogram("env/episode_ms").time_ms():
      try:
        policy.reset()
        obs, _ = env.reset()
        episode: List[Dict[str, Any]] = []
        total_reward, steps, done = 0.0, 0, False
        while not done:
          action = policy.sample_action(obs, explore_prob=explore_prob)
          q = getattr(policy, "last_q_value", None)
          if q is not None:
            q_values.append(float(q))
          next_obs, reward, terminated, truncated, info = env.step(action)
          episode.append({"obs": obs, "action": action, "reward": reward,
                          "done": terminated or truncated, "info": info})
          total_reward += float(reward)
          obs = next_obs
          steps += 1
          done = terminated or truncated or (
              max_episode_steps is not None and steps >= max_episode_steps)
      except BaseException:
        obs_metrics.counter("env/aborted_episodes").inc()
        abort = getattr(policy, "abort_episode", None)
        if abort is not None:
          try:
            abort()
          except Exception:  # noqa: BLE001 - teardown must not mask the error
            _log.exception("run_env: abort_episode failed")
        raise
      episode_rewards.append(total_reward)
      episode_lengths.append(steps)
      if replay_writer is not None and episode_to_transitions_fn is not None:
        replay_writer.write(episode_to_transitions_fn(episode))
    obs_metrics.counter("env/episodes").inc()
    obs_metrics.counter("env/steps").inc(steps)
  stats = {
      f"{tag}/episode_reward_mean": float(np.mean(episode_rewards)),
      f"{tag}/episode_reward_std": float(np.std(episode_rewards)),
      f"{tag}/episode_length_mean": float(np.mean(episode_lengths)),
      f"{tag}/explore_prob": float(explore_prob),
  }
  if q_values:
    stats[f"{tag}/q_value_mean"] = float(np.mean(q_values))
  if root_dir is not None:
    with summaries_lib.SummaryWriter(os.path.join(root_dir, tag)) as writer:
      writer.write_scalars(global_step, stats)
  if log_stats:
    _log.info("run_env[%s] @%d: %s", tag, global_step, stats)
  return stats


class TFAgentsEnvAdapter:
  """Adapts a TF-Agents `py_environment`-style env (reset/step returning
  TimeStep-like objects with `.observation`, `.reward` and `.last()` or
  `.step_type`) onto the gymnasium 5-tuple API `run_env` consumes. The
  protocol is duck-typed: tf_agents is not imported."""

  def __init__(self, tfagents_env):
    self._env = tfagents_env

  @staticmethod
  def _is_last(timestep) -> bool:
    if hasattr(timestep, "last"):
      return bool(timestep.last())
    # StepType.LAST == 2 in tf_agents.trajectories.time_step.
    return int(getattr(timestep, "step_type")) == 2

  def reset(self):
    timestep = self._env.reset()
    return timestep.observation, {}

  def step(self, action):
    timestep = self._env.step(action)
    reward = float(np.asarray(timestep.reward))
    done = self._is_last(timestep)
    return timestep.observation, reward, done, False, {}

  def __getattr__(self, name):
    return getattr(self._env, name)


@config.configurable
def run_tfagents_env(env=config.REQUIRED, **kwargs) -> Dict[str, float]:
  """`run_env` over a TF-Agents py_environment, wrapped in
  `TFAgentsEnvAdapter`."""
  return run_env(env=TFAgentsEnvAdapter(env), **kwargs)


@config.configurable
def collect_eval_loop(collect_env=config.REQUIRED,
                      eval_env=None,
                      policy=config.REQUIRED,
                      root_dir: str = config.REQUIRED,
                      num_collect_episodes: int = 10,
                      num_eval_episodes: int = 5,
                      max_steps: int = 1,
                      explore_schedule: Optional[Callable] = None,
                      episode_to_transitions_fn=None,
                      poll_interval_secs: float = 1.0,
                      total_timeout_secs: Optional[float] = None
                      ) -> Dict[str, float]:
  """Poll policy artifacts -> collect -> eval -> repeat. One iteration
  per new policy version (its global step); collect episodes go to
  `<root_dir>/policy_collect/episodes_<step>.tfrecord` when
  `episode_to_transitions_fn` is given. Stops when the policy's global
  step reaches `max_steps`, or on timeout."""
  os.makedirs(root_dir, exist_ok=True)
  stats: Dict[str, float] = {}
  last_step = -1
  start = time.time()
  while True:
    if not policy.restore():
      if (total_timeout_secs is not None
          and time.time() - start > total_timeout_secs):
        _log.warning("collect_eval_loop: timed out waiting for policy.")
        return stats
      time.sleep(poll_interval_secs)
      continue
    step = max(policy.global_step, 0)
    if step == last_step:
      if (total_timeout_secs is not None
          and time.time() - start > total_timeout_secs):
        return stats
      if step >= max_steps:
        return stats
      time.sleep(poll_interval_secs)
      continue
    last_step = step
    replay_writer = None
    if episode_to_transitions_fn is not None:
      replay_path = os.path.join(root_dir, "policy_collect",
                                 f"episodes_{step}.tfrecord")
      replay_writer = writer_lib.TFRecordReplayWriter(replay_path)
    try:
      stats.update(run_env(
          env=collect_env, policy=policy, num_episodes=num_collect_episodes,
          explore_schedule=explore_schedule, global_step=step,
          root_dir=root_dir, tag="collect",
          episode_to_transitions_fn=episode_to_transitions_fn,
          replay_writer=replay_writer))
    finally:
      if replay_writer is not None:
        replay_writer.close()
    if eval_env is not None:
      stats.update(run_env(
          env=eval_env, policy=policy, num_episodes=num_eval_episodes,
          global_step=step, root_dir=root_dir, tag="eval"))
    if step >= max_steps:
      return stats
