"""The pose toy environment and the actor loop against the JAX package's.

`envs/pose_env.py`, `envs/run_env.py`, `bin/run_collect_eval.py` and the
port's `configs/collect_random.gin`, on the CPU. Actor data is held
exactly: `PoseToyEnv` episodes and `RandomPolicy` actions bit for bit,
the replay records that `episode_to_transitions` writes byte for byte,
and `run_env`'s stats equal, for the same seeds in both packages. The
transitions are held byte for byte (the PNG bytes, the arrays' bits);
each record against protobuf's deterministic serialization of the JAX
package's record (its writer leaves map entries in upb's hash order,
which is not specified; the port's encoder sorts them). The
abort contract is the JAX suite's (`tests/test_envs.py`
`TestEpisodeTeardown`) run on the port.
"""

import glob
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from tensor2robot_tpu.data import codec as jax_codec
from tensor2robot_tpu.data import example_pb2
from tensor2robot_tpu.data import replay_writer as jax_replay_writer
from tensor2robot_tpu.data import tfrecord as jax_tfrecord
from tensor2robot_tpu.envs import pose_env as jax_pose_env
from tensor2robot_tpu.envs import run_env as jax_run_env
from tensor2robot_tpu.utils import config as jax_config
from tensor2robot_tpu_torch.bin import run_collect_eval
from tensor2robot_tpu_torch.data import (codec, parsing, replay_writer,
                                         tfrecord)
from tensor2robot_tpu_torch.envs import pose_env, run_env
from tensor2robot_tpu_torch.obs import metrics as metrics_lib
from tensor2robot_tpu_torch.obs import trace
from tensor2robot_tpu_torch.policies import policies as policies_lib
from tensor2robot_tpu_torch.specs import SpecStruct, TensorSpec
from tensor2robot_tpu_torch.utils import config

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_CONFIG = os.path.join(REPO, "tensor2robot_tpu_torch", "configs",
                           "collect_random.gin")
JAX_CONFIG = os.path.join(REPO, "tensor2robot_tpu", "research", "pose_env",
                          "configs", "collect_random.gin")


@pytest.fixture(autouse=True)
def _clean_config():
  config.clear_config()
  jax_config.clear_config()
  yield
  config.clear_config()
  jax_config.clear_config()


def _rollout(env, policy, episodes):
  out = []
  for _ in range(episodes):
    obs, info = env.reset()
    done = False
    while not done:
      action = policy.select_action(obs)
      next_obs, reward, terminated, truncated, step_info = env.step(action)
      out.append((obs["image"], int(obs["timestep"]), info["target"],
                  action, reward, step_info["distance"], terminated))
      obs, done = next_obs, terminated or truncated
  return out


@pytest.mark.parametrize("episode_length", [1, 3])
def test_episodes_bit_for_bit(episode_length):
  got = _rollout(pose_env.PoseToyEnv(seed=4, episode_length=episode_length),
                 pose_env.RandomPolicy(seed=5), 25)
  want = _rollout(jax_pose_env.PoseToyEnv(seed=4,
                                          episode_length=episode_length),
                  jax_pose_env.RandomPolicy(seed=5), 25)
  assert len(got) == len(want) == 25 * episode_length
  for g, w in zip(got, want):
    for a, b in zip(g, w):
      a, b = np.asarray(a), np.asarray(b)
      assert a.dtype == b.dtype and np.array_equal(a, b)


def test_reset_with_a_seed_and_a_perfect_action():
  env = pose_env.PoseToyEnv(seed=0)
  obs, info = env.reset(seed=11)
  _, want_info = jax_pose_env.PoseToyEnv(seed=3).reset(seed=11)
  np.testing.assert_array_equal(info["target"], want_info["target"])
  assert obs["image"].shape == (32, 32, 1) and obs["image"].max() == 255
  _, reward, terminated, truncated, _ = env.step(info["target"])
  assert reward == pytest.approx(0.0, abs=1e-6)
  assert terminated and not truncated


def _collect(pkg_env, pkg_run_env, pkg_writer, path, episodes=12):
  with pkg_writer.TFRecordReplayWriter(path) as writer:
    return pkg_run_env.run_env(
        env=pkg_env.PoseToyEnv(seed=0, episode_length=2),
        policy=pkg_env.RandomPolicy(seed=1), num_episodes=episodes,
        episode_to_transitions_fn=pkg_env.episode_to_transitions,
        replay_writer=writer, explore_schedule=lambda step: 0.25,
        global_step=7)


def _same_records(got_path, want_path):
  """The port's records against the JAX package's, byte for byte after
  protobuf's deterministic serialization of each (the JAX writer leaves
  map entries in upb's hash order; the message is the same)."""
  got = tfrecord.read_records(got_path)
  want = [example_pb2.Example.FromString(r).SerializeToString(
      deterministic=True) for r in jax_tfrecord.read_records(want_path)]
  assert len(got) == len(want) > 0
  assert got == want


def test_transitions_byte_for_byte():
  episode = []
  env, policy = pose_env.PoseToyEnv(seed=6, episode_length=3), \
      pose_env.RandomPolicy(seed=7)
  obs, _ = env.reset()
  for _ in range(3):
    action = policy.select_action(obs)
    next_obs, reward, _, _, _ = env.step(action)
    episode.append({"obs": obs, "action": action, "reward": reward})
    obs = next_obs
  got = pose_env.episode_to_transitions(episode)
  want = jax_pose_env.episode_to_transitions(episode)
  assert len(got) == len(want) == 3
  for g, w in zip(got, want):
    assert list(g) == list(w)
    assert g["state/image"] == w["state/image"]  # the PNG bytes
    for key in ("action/action", "reward"):
      assert g[key].dtype == w[key].dtype
      assert g[key].tobytes() == w[key].tobytes()


def test_replay_records_byte_for_byte(tmp_path):
  got_path, want_path = str(tmp_path / "port.rec"), str(tmp_path / "jax.rec")
  got = _collect(pose_env, run_env, replay_writer, got_path)
  want = _collect(jax_pose_env, jax_run_env, jax_replay_writer, want_path)
  assert got == want
  assert got["collect/explore_prob"] == 0.25
  _same_records(got_path, want_path)
  assert tfrecord.count_records(got_path) == 24


def test_encoder_writes_the_deterministic_serialization():
  rng = np.random.RandomState(8)
  names = [f"{a}/{b}" for a in ("state", "action", "Z", "é") for b in "xyz"]
  for _ in range(20):
    keys = list(rng.choice(names, rng.randint(1, 8), replace=False))
    values = {k: rng.randn(rng.randint(1, 4)).astype(np.float32)
              for k in keys}
    values[keys[0]] = b"\x89PNG"
    want = example_pb2.Example.FromString(jax_codec.encode_example(
        values)).SerializeToString(deterministic=True)
    assert codec.encode_example(values) == want


def test_png_records_parse_back_to_the_rendered_images(tmp_path):
  path = str(tmp_path / "replay.rec")
  env = pose_env.PoseToyEnv(seed=2)
  images = []

  class _Recording(pose_env.RandomPolicy):
    def select_action(self, obs, explore_prob=0.0):
      images.append(obs["image"])
      return super().select_action(obs)

  with replay_writer.TFRecordReplayWriter(path) as writer:
    run_env.run_env(env=env, policy=_Recording(seed=3), num_episodes=5,
                    episode_to_transitions_fn=pose_env.episode_to_transitions,
                    replay_writer=writer)
  spec = SpecStruct({
      "state/image": TensorSpec(shape=(32, 32, 1), dtype=np.uint8,
                                name="state/image", data_format="png"),
      "action/action": TensorSpec(shape=(2,), name="action/action"),
      "reward": TensorSpec(shape=(1,), name="reward"),
  })
  parsed = parsing.create_parse_fn(spec).parse_batch(
      tfrecord.read_records(path))
  np.testing.assert_array_equal(parsed["features/state/image"],
                                np.stack(images))


def test_run_env_writes_stats_and_traces_episodes(tmp_path):
  tracer = trace.get_tracer()
  tracer.clear()
  tracer.enable()
  try:
    stats = run_env.run_env(env=pose_env.PoseToyEnv(seed=0),
                            policy=pose_env.RandomPolicy(seed=0),
                            num_episodes=3, root_dir=str(tmp_path),
                            tag="collect")
  finally:
    tracer.disable()
  episodes = [e for e in tracer.events() if e.get("name") == "env/episode"]
  assert [e["args"]["episode"] for e in episodes] == [0, 1, 2]
  assert stats["collect/episode_reward_mean"] < 0.0
  assert os.path.isfile(tmp_path / "collect" / "metrics.jsonl")


def test_tfagents_adapter():
  steps = iter([SimpleNamespace(observation=1, reward=np.float32(-0.5),
                                step_type=1),
                SimpleNamespace(observation=2, reward=np.float32(-0.25),
                                last=lambda: True)])

  class _Env:
    def reset(self):
      return SimpleNamespace(observation=0)

    def step(self, action):
      return next(steps)

  stats = run_env.run_tfagents_env(env=_Env(),
                                   policy=pose_env.RandomPolicy(seed=0),
                                   num_episodes=1)
  assert stats["collect/episode_reward_mean"] == -0.75
  assert stats["collect/episode_length_mean"] == 2.0


def test_collect_random_config_through_the_cli(tmp_path):
  port_root, jax_root = str(tmp_path / "port"), str(tmp_path / "jax")
  got = run_collect_eval.main([
      "--config_files", PORT_CONFIG,
      "--config", f"collect_eval_loop.root_dir = '{port_root}'",
      "--config", "collect/PoseToyEnv.seed = 0",
      "--config", "eval/PoseToyEnv.seed = 1",
      "--config", "RandomPolicy.seed = 2"])
  jax_config.parse_config_files_and_bindings(
      [JAX_CONFIG], [f"collect_eval_loop.root_dir = '{jax_root}'",
                     "collect/PoseToyEnv.seed = 0",
                     "eval/PoseToyEnv.seed = 1", "RandomPolicy.seed = 2"])
  want = jax_run_env.collect_eval_loop()
  assert got == want
  assert "eval/episode_reward_mean" in got
  replays = glob.glob(os.path.join(port_root, "policy_collect", "*"))
  assert [os.path.basename(p) for p in replays] == ["episodes_0.tfrecord"]
  _same_records(replays[0], os.path.join(jax_root, "policy_collect",
                                         "episodes_0.tfrecord"))
  assert tfrecord.count_records(replays[0]) == 3


# -- the abort contract (tests/test_envs.py TestEpisodeTeardown) -----------


class _CrashingEnv:
  """Raises on step `crash_at_step`: an env failure mid-episode."""

  def __init__(self, crash_at_step=1):
    self._crash_at = crash_at_step
    self._t = 0

  def reset(self, seed=None):
    self._t = 0
    return {"x": np.zeros(2, np.float32)}, {}

  def step(self, action):
    self._t += 1
    if self._t >= self._crash_at:
      raise RuntimeError("simulator died mid-episode")
    return ({"x": np.zeros(2, np.float32)}, 0.0, False, False, {})


class _SessionPredictorSpy:
  """The session surface, counting open and close."""

  def __init__(self):
    self.open_sessions = set()
    self.next_sid = 1
    self.closed = []

  def open(self):
    sid = self.next_sid
    self.next_sid += 1
    self.open_sessions.add(sid)
    return sid

  def step(self, sid, features):
    assert sid in self.open_sessions
    return {"inference_output": np.zeros((2,), np.float32)}

  def close_session(self, sid):
    self.open_sessions.discard(sid)
    self.closed.append(sid)


class TestEpisodeTeardown:

  def test_env_crash_calls_abort_episode_and_propagates(self):
    aborts = []

    class _SpyPolicy(pose_env.RandomPolicy):
      def abort_episode(self):
        aborts.append(True)

    error = RuntimeError("simulator died mid-episode")
    env = _CrashingEnv()
    env.step = lambda action: (_ for _ in ()).throw(error)
    with metrics_lib.isolated() as registry:
      with pytest.raises(RuntimeError) as raised:
        run_env.run_env(env=env, policy=_SpyPolicy(seed=0), num_episodes=3)
      snap = registry.snapshot()
    assert raised.value is error  # the same object, unchanged
    assert aborts == [True]
    assert snap["counter/env/aborted_episodes"] == 1

  def test_session_policy_crash_frees_server_slot(self):
    predictor = _SessionPredictorSpy()
    policy = policies_lib.SessionRegressionPolicy(predictor=predictor)
    with pytest.raises(RuntimeError, match="simulator died"):
      run_env.run_env(env=_CrashingEnv(), policy=policy, num_episodes=1)
    assert predictor.open_sessions == set()
    assert len(predictor.closed) == 1
    assert policy.session_id is None

  def test_abort_failure_does_not_mask_env_error(self):
    class _BrokenAbortPolicy(pose_env.RandomPolicy):
      def abort_episode(self):
        raise ValueError("teardown exploded too")

    with pytest.raises(RuntimeError, match="simulator died"):
      run_env.run_env(env=_CrashingEnv(),
                      policy=_BrokenAbortPolicy(seed=0), num_episodes=1)

  def test_policy_crash_is_aborted_too(self):
    aborts = []

    class _CrashingPolicy(pose_env.RandomPolicy):
      def select_action(self, obs, explore_prob=0.0):
        raise KeyError("predictor lost")

      def abort_episode(self):
        aborts.append(True)

    with pytest.raises(KeyError, match="predictor lost"):
      run_env.run_env(env=pose_env.PoseToyEnv(seed=0),
                      policy=_CrashingPolicy(seed=0), num_episodes=2)
    assert aborts == [True]

  def test_completed_episodes_unaffected(self):
    aborts = []

    class _SpyPolicy(pose_env.RandomPolicy):
      def abort_episode(self):
        aborts.append(True)

    stats = run_env.run_env(env=pose_env.PoseToyEnv(seed=0),
                            policy=_SpyPolicy(seed=0), num_episodes=2)
    assert "collect/episode_reward_mean" in stats
    assert aborts == []
