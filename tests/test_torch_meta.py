"""The meta-learning data, policies and loops against the JAX package's.

On the CPU, the same inputs through both packages:

* `meta_learning/preprocessors.py`: `MAMLPreprocessor` and
  `FixedLenMetaExamplePreprocessor` (specs and batches, exactly);
* `meta_learning/meta_example.py`: `make_meta_example`'s bytes against
  protobuf's deterministic serialization of the JAX package's;
* `meta_learning/task_data.py`: `MetaTaskRecordInputGenerator` batches
  from the same per-task files and seed, in train and eval mode, exactly;
* `meta_learning/meta_policies.py` on numpy stub predictors (the same
  actions for the same seeds);
* `envs/run_meta_env.py`: `run_meta_env` and `run_wtl_env` on numpy stub
  policies (the same stats), and `bin/run_meta_collect_eval.py`;
* the port's train -> serve -> adapt -> act run of
  `tests/test_meta_subsystem.py` (MAML over the mock through
  `train_eval_model`, `CheckpointPredictor`, `MAMLRegressionPolicy`), and
  the pose MAML served inside `run_meta_env` on the toy env.
"""

import numpy as np
import pytest
import torch

from tensor2robot_tpu.data import codec as jax_codec
from tensor2robot_tpu.data import example_pb2
from tensor2robot_tpu.data import parsing as jax_parsing
from tensor2robot_tpu.envs import pose_env as jax_pose_env
from tensor2robot_tpu.envs import run_meta_env as jax_run_meta_env
from tensor2robot_tpu.meta_learning import maml as jax_maml
from tensor2robot_tpu.meta_learning import meta_example as jax_meta_example
from tensor2robot_tpu.meta_learning import meta_policies as jax_policies
from tensor2robot_tpu.meta_learning import preprocessors as jax_pre
from tensor2robot_tpu.meta_learning import task_data as jax_task_data
from tensor2robot_tpu.preprocessors import NoOpPreprocessor as JaxNoOp
from tensor2robot_tpu.specs import SpecStruct as JaxSpecStruct
from tensor2robot_tpu.specs import TensorSpec as JaxTensorSpec
from tensor2robot_tpu.utils import config as jax_config
from tensor2robot_tpu.utils import mocks as jax_mocks
from tensor2robot_tpu_torch import train_eval
from tensor2robot_tpu_torch.bin import run_meta_collect_eval
from tensor2robot_tpu_torch.data import codec, input_generators, parsing
from tensor2robot_tpu_torch.data import tfrecord
from tensor2robot_tpu_torch.envs import pose_env, run_meta_env
from tensor2robot_tpu_torch.meta_learning import (maml, meta_example,
                                                  meta_policies,
                                                  preprocessors, task_data)
from tensor2robot_tpu_torch.predictors import predictors
from tensor2robot_tpu_torch.preprocessors.base import NoOpPreprocessor
from tensor2robot_tpu_torch.research.pose_env import models as pose_models
from tensor2robot_tpu_torch.specs import SpecStruct, TensorSpec
from tensor2robot_tpu_torch.utils import config, mocks

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _clean_config():
  config.clear_config()
  jax_config.clear_config()
  yield
  config.clear_config()
  jax_config.clear_config()


def _specs(spec_struct, tensor_spec):
  return (spec_struct({"x": tensor_spec(shape=(3,), name="x")}),
          spec_struct({"y": tensor_spec(shape=(1,), name="y")}))


def _noop(jax_side: bool):
  f, l = _specs(JaxSpecStruct, JaxTensorSpec) if jax_side else _specs(
      SpecStruct, TensorSpec)
  cls = JaxNoOp if jax_side else NoOpPreprocessor
  return cls(model_feature_specification_fn=lambda m: f,
             model_label_specification_fn=lambda m: l)


def _spec_dicts(spec):
  return {k: {f: x for f, x in v.to_dict().items() if f != "sharding"}
          for k, v in spec.items()}


def _same_values(got, want):
  got, want = dict(got.items()), dict(want.items())
  assert sorted(got) == sorted(want)
  for key, value in want.items():
    got_value = got[key]
    if isinstance(got_value, torch.Tensor):
      got_value = got_value.numpy()
    np.testing.assert_array_equal(got_value, np.asarray(value), err_msg=key)
    assert got_value.dtype == np.asarray(value).dtype, key


class TestPreprocessors:

  def test_maml_preprocessor(self):
    kwargs = dict(num_condition_samples_per_task=4,
                  num_inference_samples_per_task=2)
    want_pre = jax_pre.MAMLPreprocessor(base_preprocessor=_noop(True),
                                        **kwargs)
    pre = preprocessors.MAMLPreprocessor(base_preprocessor=_noop(False),
                                         **kwargs)
    for getter in ("get_in_feature_specification",
                   "get_in_label_specification",
                   "get_out_feature_specification",
                   "get_out_label_specification"):
      assert _spec_dicts(getattr(pre, getter)("train")) == _spec_dicts(
          getattr(want_pre, getter)("train")), getter
    rng = np.random.RandomState(0)
    batch = {"condition/features/x": rng.randn(5, 4, 3).astype(np.float32),
             "condition/labels/y": rng.randn(5, 4, 1).astype(np.float32),
             "inference/features/x": rng.randn(5, 2, 3).astype(np.float32)}
    labels = {"y": rng.randn(5, 2, 1).astype(np.float32)}
    want_f, want_l = want_pre.preprocess(JaxSpecStruct(batch),
                                         JaxSpecStruct(labels), "train")
    got_f, got_l = pre.preprocess(
        SpecStruct({k: torch.from_numpy(v) for k, v in batch.items()}),
        SpecStruct({k: torch.from_numpy(v) for k, v in labels.items()}),
        "train")
    _same_values(got_f, want_f)
    _same_values(got_l, want_l)

  def test_meta_example_through_the_fixed_length_preprocessor(self):
    episodes_c = [{"x": np.full(3, i, np.float32),
                   "y": np.array([i], np.float32)} for i in range(2)]
    episode_i = {"x": np.full(3, 9, np.float32),
                 "y": np.array([9], np.float32)}
    record = meta_example.make_meta_example(
        [codec.encode_example(e) for e in episodes_c],
        [codec.encode_example(episode_i)])
    want_record = jax_meta_example.make_meta_example(
        [jax_codec.encode_example(e) for e in episodes_c],
        [jax_codec.encode_example(episode_i)])
    assert record == example_pb2.Example.FromString(
        want_record).SerializeToString(deterministic=True)
    kwargs = dict(num_condition_episodes=2, num_inference_episodes=1)
    want_pre = jax_pre.FixedLenMetaExamplePreprocessor(
        base_preprocessor=_noop(True), **kwargs)
    pre = preprocessors.FixedLenMetaExamplePreprocessor(
        base_preprocessor=_noop(False), **kwargs)
    for getter in ("get_in_feature_specification",
                   "get_in_label_specification",
                   "get_out_feature_specification",
                   "get_out_label_specification"):
      assert _spec_dicts(getattr(pre, getter)("train")) == _spec_dicts(
          getattr(want_pre, getter)("train")), getter
    want_parsed = jax_parsing.ParseFn(
        want_pre.get_in_feature_specification("train"),
        want_pre.get_in_label_specification("train")).parse_batch(
            [want_record])
    parsed = parsing.ParseFn(
        pre.get_in_feature_specification("train"),
        pre.get_in_label_specification("train")).parse_batch([record])
    want_f, want_l = want_pre.preprocess(want_parsed["features"],
                                         want_parsed["labels"], "train")
    got_f, got_l = pre.preprocess(parsed["features"], parsed["labels"],
                                  "train")
    _same_values(got_f, want_f)
    _same_values(got_l, want_l)
    assert got_f["condition/features/x"].shape == (1, 2, 3)
    assert float(got_f["condition/features/x"][0, 1, 0]) == 1.0
    assert float(got_f["inference/features/x"][0, 0, 0]) == 9.0


def _write_task_files(tmp_path, tasks=5, per_task=7):
  rng = np.random.RandomState(1)
  paths = []
  for t in range(tasks):
    path = str(tmp_path / f"task_{t}.tfrecord")
    with tfrecord.RecordWriter(path) as writer:
      for _ in range(per_task):
        writer.write(codec.encode_example({
            "measured_position": rng.randn(3).astype(np.float32),
            "valid_position": rng.rand(1).astype(np.float32)}))
    paths.append(path)
  return str(tmp_path / "task_*.tfrecord")


@pytest.mark.parametrize("mode", ["train", "eval"])
def test_task_record_generator_batches(tmp_path, mode):
  pattern = _write_task_files(tmp_path)
  kwargs = dict(num_condition_samples_per_task=2,
                num_inference_samples_per_task=1)
  jax_model = jax_maml.MAMLModel(
      base_model=jax_mocks.MockT2RModel(device_type="cpu"), **kwargs)
  model = maml.MAMLModel(base_model=mocks.MockT2RModel(), **kwargs)
  gen_kwargs = dict(file_patterns=pattern, batch_size=2,
                    num_train_samples_per_task=2, num_val_samples_per_task=1,
                    shuffle_buffer_size=4, seed=3)
  want_gen = jax_task_data.MetaTaskRecordInputGenerator(**gen_kwargs)
  want_gen.set_specification_from_model(jax_model, mode)
  gen = task_data.MetaTaskRecordInputGenerator(**gen_kwargs)
  gen.set_specification_from_model(model, mode)
  want = list(_take(want_gen.create_dataset(mode), 6))
  got = list(_take(gen.create_dataset(mode), 6))
  # Eval: one pass of 5 files x 2 groups of 3, in batches of 2 tasks.
  assert len(got) == len(want) == (6 if mode == "train" else 5)
  for g, w in zip(got, want):
    _same_values(g["features"], w["features"])
    _same_values(g["labels"], w["labels"])
  assert got[0]["features"]["condition/features/x"].shape == (2, 2, 3)


def _take(stream, n):
  for i, item in enumerate(stream):
    if i == n:
      return
    yield item


class _FakeMetaPredictor:
  """Returns the mean of the condition labels as the action, and a q
  that peaks there: checks that the condition buffer reaches the
  predictor."""

  def predict(self, features):
    cond_y = np.asarray(features["condition/labels/y"])  # [task, n, 1]
    mean = cond_y.mean(axis=1, keepdims=True)
    out = {}
    if "inference/features/action/action" in features:
      actions = np.asarray(features["inference/features/action/action"])
      out["conditioned_output/q_predicted"] = -np.abs(
          actions - mean).sum(-1, keepdims=True)
    else:
      n = np.asarray(features["inference/features/x"]).shape[1]
      action = np.tile(mean, (1, n, 1)).astype(np.float32)
      out["conditioned_output/inference_output"] = np.concatenate(
          [action, action], axis=-1)
    return out

  def restore(self):
    return True

  global_step = 5


def _adapted(policy):
  policy.adapt({"x": np.zeros((4, 3), np.float32)},
               {"y": np.full((4, 1), 0.5, np.float32)})
  return policy


class TestMetaPolicies:

  def test_regression_policy_uses_the_condition_buffer(self):
    policy = _adapted(meta_policies.MAMLRegressionPolicy(
        predictor=_FakeMetaPredictor(), num_inference_samples=3))
    np.testing.assert_allclose(policy.select_action(
        {"x": np.zeros(3, np.float32)}), [0.5, 0.5])
    policy.reset()
    with pytest.raises(ValueError, match="adapt"):
      policy.select_action({"x": np.zeros(3, np.float32)})

  def test_cem_policy_matches_the_jax_package(self):
    got = _adapted(meta_policies.MAMLCEMPolicy(
        predictor=_FakeMetaPredictor(), action_size=1, seed=4))
    want = _adapted(jax_policies.MAMLCEMPolicy(
        predictor=_FakeMetaPredictor(), action_size=1, seed=4))
    for _ in range(3):
      obs = {"x": np.zeros(3, np.float32)}
      a, b = got.select_action(obs), want.select_action(obs)
      np.testing.assert_array_equal(a, b)
    assert abs(float(a[0]) - 0.5) < 0.2

  def test_scheduled_exploration_matches_the_jax_package(self):
    kwargs = dict(action_size=2, schedule_boundaries=(0, 3),
                  schedule_values=(1.0, 0.1), seed=6)
    got = _adapted(meta_policies.ScheduledExplorationMAMLRegressionPolicy(
        predictor=_FakeMetaPredictor(), **kwargs))
    want = _adapted(jax_policies.ScheduledExplorationMAMLRegressionPolicy(
        predictor=_FakeMetaPredictor(), **kwargs))
    for _ in range(3):
      obs = {"x": np.zeros(3, np.float32)}
      (a, info), (b, _) = got.sample_action(obs), want.sample_action(obs)
      np.testing.assert_array_equal(a, b)
      assert info == {"is_demo": False}
    got.reset()  # per episode: the condition data survives
    got.select_action({"x": np.zeros(3, np.float32)})
    got.reset_task()
    with pytest.raises(ValueError, match="adapt"):
      got.select_action({"x": np.zeros(3, np.float32)})

  def test_fixed_length_sequential_policy_walks_the_rows(self):
    class _Trajectory(_FakeMetaPredictor):
      def predict(self, features):
        rows = np.arange(3, dtype=np.float32)[:, None] * np.ones(2)
        return {"conditioned_output/inference_output": rows[None, None]}

    policy = _adapted(meta_policies.FixedLengthSequentialRegressionPolicy(
        predictor=_Trajectory()))
    actions = [policy.select_action({"x": np.zeros(3)})[0]
               for _ in range(4)]
    assert actions == [0.0, 1.0, 2.0, 2.0]

  def test_wtl_policy_uses_model_layout_features(self):
    seen = []

    class _Model:
      num_condition_episodes = 2

      def pack_features(self, obs, prev_episode_data, timestep):
        return {"condition/episodes": np.full((1, len(prev_episode_data)),
                                              timestep, np.float32)}

    class _Predictor:
      def predict_preprocessed(self, features):
        seen.append(features["condition/episodes"].copy())
        return {"inference_output": np.arange(8, dtype=np.float32).reshape(
            1, 1, 4, 2)}

    policy = meta_policies.WTLPolicy(model=_Model(), predictor=_Predictor())
    with pytest.raises(ValueError, match="adapt"):
      policy.select_action({})
    policy.adapt([["demo"], ["trial"]])
    first = policy.select_action({})
    second = policy.select_action({})
    np.testing.assert_array_equal(first, [0, 1])
    np.testing.assert_array_equal(second, [2, 3])
    assert [s.tolist() for s in seen] == [[[0, 0]], [[1, 1]]]
    bare = meta_policies.WTLPolicy(model=_Model(), predictor=object())
    bare.adapt([])
    with pytest.raises(TypeError, match="predict_preprocessed"):
      bare.select_action({})


def _oracle_loop(pkg_pose_env, pkg_run_meta_env, pkg_policies, tmp_path):
  env = pkg_pose_env.PoseToyEnv(seed=0)

  class _Demo:
    def sample_action(self, obs, explore_prob=0.0):
      return env._target.copy()

    def reset(self):
      pass

  class _AdaptToTarget(pkg_policies.MetaLearningPolicy):
    def select_action(self, obs, explore_prob=0.0):
      return self._condition_labels["action"].mean(axis=0)

  def demo_to_condition(demos):
    actions = np.stack([s["action"] for e in demos for s in e])
    obs = np.stack([s["obs"]["image"].ravel()[:3] for e in demos
                    for s in e]).astype(np.float32)
    return {"obs": obs}, {"action": actions}

  return pkg_run_meta_env.run_meta_env(
      env=env, policy=_AdaptToTarget(), demo_policy=_Demo(), num_tasks=4,
      num_demos_per_task=2, num_trials_per_task=2,
      demo_to_condition_fn=demo_to_condition, root_dir=str(tmp_path))


def test_run_meta_env_matches_the_jax_package(tmp_path):
  got = _oracle_loop(pose_env, run_meta_env, meta_policies, tmp_path / "p")
  want = _oracle_loop(jax_pose_env, jax_run_meta_env, jax_policies,
                      tmp_path / "j")
  assert got == want
  assert got["meta_eval/reward_mean"] > -0.05
  assert (tmp_path / "p" / "meta_eval" / "metrics.jsonl").is_file()
  with pytest.raises(ValueError, match="demo_to_condition_fn"):
    run_meta_env.run_meta_env(env=pose_env.PoseToyEnv(), policy=None)


def _wtl_loop(pkg_pose_env, pkg_run_meta_env, retrial_conditions):
  env = pkg_pose_env.PoseToyEnv(seed=0)

  class _Demo:
    def sample_action(self, obs, explore_prob=0.0):
      return env._target.copy()

    def reset(self):
      pass

  class _Stub:
    """Acts at the mean action of the episodes it adapted to, shifted
    by 0.3 per missing episode: the retrial, with the trial, does
    better."""

    def __init__(self, episodes):
      self._model = type("M", (), {"num_condition_episodes": episodes})()
      self._actions = None

    def reset(self):
      pass

    def reset_task(self):
      self._actions = None

    def adapt(self, episodes):
      self._actions = [np.asarray(a) for e in episodes for (_, a, _) in e]
      self._missing = self._model.num_condition_episodes - len(episodes)

    def sample_action(self, state, explore_prob=0.0):
      return np.mean(self._actions, axis=0) + 0.3 * (
          self._missing + 1) * np.float32(state["image"].mean() > 0)

  return pkg_run_meta_env.run_wtl_env(
      env=env, trial_policy=_Stub(2), retrial_policy=_Stub(retrial_conditions),
      demo_policy=_Demo(), num_tasks=3)


@pytest.mark.parametrize("retrial_conditions", [1, 2])
def test_run_wtl_env_matches_the_jax_package(retrial_conditions):
  got = _wtl_loop(pose_env, run_meta_env, retrial_conditions)
  want = _wtl_loop(jax_pose_env, jax_run_meta_env, retrial_conditions)
  assert got == want
  assert set(got) == {f"wtl_eval/{k}" for k in (
      "reward_demo", "reward_trial", "reward_retrial", "retrial_gain")}
  assert got["wtl_eval/reward_demo"] == pytest.approx(0.0, abs=1e-6)
  with pytest.raises(ValueError, match="demo_policy"):
    run_meta_env.run_wtl_env(env=pose_env.PoseToyEnv(), trial_policy=None)


def test_meta_cli_runs_the_bound_loop(tmp_path):
  env = pose_env.PoseToyEnv(seed=0)

  class _Adapted(meta_policies.MetaLearningPolicy):
    def select_action(self, obs, explore_prob=0.0):
      return self._condition_labels["action"].mean(axis=0)

  config.bind("run_meta_env", "env", env)
  config.bind("run_meta_env", "policy", _Adapted())
  config.bind("run_meta_env", "demo_policy",
              type("D", (), {"sample_action": lambda s, o: env._target.copy(),
                             "reset": lambda s: None})())
  config.bind("run_meta_env", "demo_to_condition_fn", lambda demos: (
      {}, {"action": np.stack([s["action"] for e in demos for s in e])}))
  stats = run_meta_collect_eval.main([
      "--config", "run_meta_env.num_tasks = 2",
      "--config", f"run_meta_env.root_dir = '{tmp_path}'"])
  assert stats["meta_eval/reward_mean"] == pytest.approx(0.0, abs=1e-6)
  assert (tmp_path / "meta_eval" / "metrics.jsonl").is_file()


def _mock_maml():
  return maml.MAMLModel(
      base_model=mocks.MockT2RModel(use_batch_norm=False),
      num_inner_loop_steps=1, inner_learning_rate=0.5,
      num_condition_samples_per_task=4, num_inference_samples_per_task=2)


def test_maml_train_serve_adapt_act(tmp_path):
  """Train a MAML model, serve it through a checkpoint predictor, adapt
  on demo data, select actions (tests/test_meta_subsystem.py:180)."""
  model_dir = str(tmp_path / "m")
  train_eval.train_eval_model(
      model=_mock_maml(), model_dir=model_dir, mode="train",
      max_train_steps=10, checkpoint_every_n_steps=10, log_every_n_steps=10,
      input_generator_train=input_generators.DefaultRandomInputGenerator(
          batch_size=4), device="cpu")
  predictor = predictors.CheckpointPredictor(model=_mock_maml(),
                                             model_dir=model_dir,
                                             device="cpu")
  assert predictor.restore() and predictor.global_step == 10
  policy = meta_policies.MAMLRegressionPolicy(
      predictor=predictor, action_key="prediction", num_inference_samples=2)
  rng = np.random.RandomState(0)
  policy.adapt({"x": rng.randn(4, 3).astype(np.float32)},
               {"y": (rng.rand(4, 1) > 0.5).astype(np.float32)})
  action = policy.select_action({"x": np.zeros(3, np.float32)})
  assert action.shape == (1,)
  assert np.isfinite(action).all()


def test_pose_maml_served_in_the_meta_loop():
  """The pose MAML (image 16) served by `CheckpointPredictor` ->
  `MAMLRegressionPolicy` inside `run_meta_env` on toy-env tasks, with an
  oracle demo: every action adapts on the demo's images and actions."""
  size, demos = 16, 3
  model = maml.MAMLModel(
      base_model=pose_models.PoseEnvRegressionModel(image_size=size),
      num_inner_loop_steps=1, inner_learning_rate=0.05,
      num_condition_samples_per_task=demos, num_inference_samples_per_task=2)
  predictor = predictors.CheckpointPredictor(model=model, device="cpu")
  predictor.init_randomly(seed=0)
  env = pose_env.PoseToyEnv(image_size=size, seed=0)

  class _Oracle:
    def sample_action(self, obs, explore_prob=0.0):
      return env._target.copy()

    def reset(self):
      pass

  class _StateEnv:
    """The toy env's observation under the model's `state/` keys."""

    def reset(self, seed=None):
      obs, info = env.reset(seed=seed)
      return {"state/image": obs["image"]}, info

    def step(self, action):
      obs, *rest = env.step(action)
      return ({"state/image": obs["image"]}, *rest)

  def demo_to_condition(episodes):
    steps = [s for e in episodes for s in e]
    return ({"state/image": np.stack([s["obs"]["state/image"]
                                      for s in steps])},
            {"target_pose": np.stack([s["action"] for s in steps])})

  policy = meta_policies.MAMLRegressionPolicy(predictor=predictor,
                                              num_inference_samples=2)
  stats = run_meta_env.run_meta_env(
      env=_StateEnv(), policy=policy, demo_policy=_Oracle(), num_tasks=2,
      num_demos_per_task=demos, num_trials_per_task=1,
      demo_to_condition_fn=demo_to_condition)
  assert np.isfinite(stats["meta_eval/reward_mean"])
  assert predictor.global_step == 0
