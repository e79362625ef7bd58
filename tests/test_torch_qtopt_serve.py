"""Serving the QT-Opt critic in the port against the JAX package, on the
CPU.

The small critic (GraspingCNN at 32x32, action 4, f32, EMA: the
`flagship.make_flagship_model('cpu')` of both packages) with the JAX
predictor's random state carried across by `bridge.train_state_from_jax`:

* `BucketedEngine` over `CheckpointPredictor`, port against JAX, over a
  seeded request-size sweep that pads and chunks: q within 1e-5 relative
  (max |err| / max |ref|; both sum in float32 in other orders).
* `CEMPolicy` over `MicroBatcher` + `BucketedEngine`, both packages
  seeded alike (the numpy CEM draws the same samples): the same action
  within 1e-6 and `last_q_value` within 1e-5.
* The device CEM with the JAX function's normals injected as `draws`:
  action and score within 1e-5. `DeviceCEMPolicy` draws from its own
  generator: each call new normals, a fresh policy with the same seed
  the same action bit for bit.
* The restore-warms-then-serves path from a checkpoint the port's
  `train_eval_model` wrote (a Grasping44 small enough for the CPU, with
  its batch-norm statistics): `Policy.restore()` warms every rung, the
  engine serves the restored state's eval-mode forward, and both CEM
  policies return in-bounds actions scored by it.
"""

import functools
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensor2robot_tpu import serving as jax_serving
from tensor2robot_tpu.policies import device_cem as jax_device_cem
from tensor2robot_tpu.policies import policies as jax_policies
from tensor2robot_tpu.predictors import predictors as jax_predictors
from tensor2robot_tpu.research.qtopt import flagship as jax_flagship
from tensor2robot_tpu_torch import bridge
from tensor2robot_tpu_torch import checkpoints
from tensor2robot_tpu_torch import serving
from tensor2robot_tpu_torch import specs
from tensor2robot_tpu_torch import train_eval
from tensor2robot_tpu_torch.data import input_generators
from tensor2robot_tpu_torch.policies import device_cem
from tensor2robot_tpu_torch.policies import policies
from tensor2robot_tpu_torch.predictors import predictors
from tensor2robot_tpu_torch.research.qtopt import flagship
from tensor2robot_tpu_torch.research.qtopt import models

# The port's tests run in the same worker processes as the JAX suite;
# one torch thread keeps torch from starting its OpenMP and MKL thread
# pools beside XLA's CPU threads.
torch.set_num_threads(1)

Q_RTOL = 1e-5
ACTION_ATOL = 1e-6
DEVICE_CEM_ATOL = 1e-5
ACTION_SIZE = 4


def _rel(got, want):
  got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
  return float(np.abs(got - want).max() / np.abs(want).max())


@functools.lru_cache(maxsize=None)
def _jax_predictor():
  predictor = jax_predictors.CheckpointPredictor(
      model=jax_flagship.make_flagship_model("cpu"),
      model_dir="/nonexistent")
  predictor.init_randomly()
  return predictor


def _port_predictor():
  """A port predictor serving the JAX predictor's state."""
  state = bridge.train_state_from_jax(_jax_predictor()._state)
  predictor = predictors.CheckpointPredictor(
      model=flagship.make_flagship_model("cpu"), device="cpu")
  predictor.load_params(state.params, state.ema_params,
                        global_step=state.step,
                        mutable_state=state.mutable_state)
  assert predictor.restore()
  return predictor


def _request(rows, seed):
  return dict(specs.make_random_numpy(
      flagship.make_flagship_model("cpu").get_feature_specification(
          "predict"), batch_size=rows, seed=seed))


def _observation(seed):
  return {"image": _request(1, seed)["state/image"][0]}


def test_engine_matches_jax_over_a_size_sweep():
  jax_engine = jax_serving.BucketedEngine(predictor=_jax_predictor(),
                                          max_batch_size=8)
  engine = serving.BucketedEngine(predictor=_port_predictor(),
                                  max_batch_size=8)
  jax_engine.warmup()
  engine.warmup()
  assert engine.warm_count == jax_engine.compile_count == 4
  rng = np.random.RandomState(0)
  for i in range(12):
    rows = int(rng.randint(1, 20))
    request = _request(rows, seed=100 + i)
    want = jax_engine.predict(request)["q_predicted"]
    got = engine.predict(request)["q_predicted"]
    assert got.shape == want.shape == (rows, 1)
    assert _rel(got, want) <= Q_RTOL, rows
  assert engine.warm_count == 4


@pytest.mark.parametrize("seed", [0, 1])
def test_cem_policy_matches_jax(seed):
  jax_engine = jax_serving.BucketedEngine(predictor=_jax_predictor(),
                                          max_batch_size=16)
  engine = serving.BucketedEngine(predictor=_port_predictor(),
                                  max_batch_size=16)
  obs = _observation(seed=20 + seed)
  with jax_serving.MicroBatcher(backend=jax_engine, max_batch_size=16,
                                max_delay_ms=2.0) as jax_batcher, \
      serving.MicroBatcher(backend=engine, max_batch_size=16,
                           max_delay_ms=2.0) as batcher:
    want_policy = jax_policies.CEMPolicy(predictor=jax_batcher,
                                         action_size=ACTION_SIZE, seed=seed)
    got_policy = policies.CEMPolicy(predictor=batcher,
                                    action_size=ACTION_SIZE, seed=seed)
    for _ in range(2):  # the second action draws on from the same stream
      want = want_policy.select_action(obs)
      got = got_policy.select_action(obs)
      np.testing.assert_allclose(got, want, rtol=0, atol=ACTION_ATOL)
      assert got_policy.last_q_value == pytest.approx(
          want_policy.last_q_value, rel=Q_RTOL)
      assert np.all(np.abs(got) <= 1.0)


def _jax_draws(key, iterations=3, samples=64):
  draws = []
  for _ in range(iterations):
    key, sample_key = jax.random.split(key)
    draws.append(np.asarray(jax.random.normal(sample_key,
                                              (samples, ACTION_SIZE))))
  return torch.from_numpy(np.stack(draws))


@pytest.mark.parametrize("seed", [0, 5])
def test_device_cem_matches_jax_on_its_draws(seed):
  jax_model = jax_flagship.make_flagship_model("cpu")
  model = flagship.make_flagship_model("cpu")
  obs = _observation(seed=30 + seed)
  key = jax.random.PRNGKey(seed)
  want_action, want_score = jax_device_cem.make_device_cem_fn(
      jax_model, ACTION_SIZE)(_jax_predictor()._state,
                              {k: jnp.asarray(v) for k, v in obs.items()},
                              key)
  state = bridge.train_state_from_jax(_jax_predictor()._state)
  action, score = device_cem.make_device_cem_fn(model, ACTION_SIZE)(
      state, {k: torch.from_numpy(v) for k, v in obs.items()},
      draws=_jax_draws(key))
  np.testing.assert_allclose(action.numpy(), np.asarray(want_action),
                             rtol=0, atol=DEVICE_CEM_ATOL)
  assert float(score) == pytest.approx(float(want_score),
                                       abs=DEVICE_CEM_ATOL)


def test_device_cem_policy_draws_from_its_generator():
  model = flagship.make_flagship_model("cpu")
  state = bridge.train_state_from_jax(_jax_predictor()._state)
  obs = _observation(seed=40)
  policy = device_cem.DeviceCEMPolicy(model=model, state=state,
                                      action_size=ACTION_SIZE, seed=3,
                                      device="cpu")
  assert policy.restore() and policy.global_step == 0
  first = policy.select_action(obs)
  first_q = policy.last_q_value
  second = policy.select_action(obs)
  assert not np.array_equal(first, second), "the second call drew nothing new"
  # The policy's actions are the device CEM's on the generator's normals.
  generator = torch.Generator().manual_seed(3)
  select = device_cem.make_device_cem_fn(model, ACTION_SIZE)
  obs_tree = {k: torch.from_numpy(v) for k, v in obs.items()}
  for want in (first, second):
    draws = torch.stack([torch.randn((64, ACTION_SIZE), generator=generator)
                         for _ in range(3)])
    action, _ = select(state, obs_tree, draws=draws)
    np.testing.assert_array_equal(action.numpy(), want)
  fresh = device_cem.DeviceCEMPolicy(model=model, state=state,
                                     action_size=ACTION_SIZE, seed=3,
                                     device="cpu")
  np.testing.assert_array_equal(fresh.select_action(obs), first)
  assert fresh.last_q_value == first_q
  with pytest.raises(ValueError, match="No state set"):
    device_cem.DeviceCEMPolicy(model=model, action_size=ACTION_SIZE,
                               device="cpu").select_action(obs)


BLOCKS = {"world_vector": (0, 3), "vertical_rotation": (3, 2)}


class _TinyCritic(models.QTOptModel):
  """Grasping44 at 108 px with filters 16 and one conv per stage."""

  def __init__(self):
    super().__init__(image_size=108, action_size=5, network="grasping44",
                     grasp_param_names=BLOCKS, ema_decay=0.5)

  def create_module(self):
    return models.Grasping44(108, 3, 5, num_convs=(1, 1, 1), filters=16,
                             grasp_param_names=BLOCKS)


def test_policy_restore_warms_and_serves_a_trained_checkpoint(tmp_path):
  train_eval.train_eval_model(
      model=_TinyCritic(), model_dir=str(tmp_path), device="cpu",
      mode="train", max_train_steps=3, checkpoint_every_n_steps=3,
      log_every_n_steps=3, seed=0,
      input_generator_train=input_generators.DefaultRandomInputGenerator(
          batch_size=4, seed=0))
  predictor = predictors.CheckpointPredictor(
      model=_TinyCritic(), model_dir=str(tmp_path), device="cpu")
  engine = serving.BucketedEngine(predictor=predictor, max_batch_size=4)
  state = checkpoints.CheckpointManager(
      str(tmp_path / "checkpoints")).restore()
  model = predictor.model
  image = specs.make_random_numpy(model.get_feature_specification("predict"),
                                  batch_size=1, seed=8)["state/image"]
  with serving.MicroBatcher(backend=engine, max_batch_size=4,
                            max_delay_ms=2.0) as batcher:
    policy = policies.CEMPolicy(predictor=batcher, action_size=5,
                                cem_samples=8, cem_iterations=2,
                                cem_elites=3, seed=0)
    assert engine.warm_count == 0
    assert policy.restore()
    assert engine.warm_count == len(engine.buckets) == 3
    assert policy.global_step == 3
    # Coalesced 1-row probes from threads, each the eval-mode forward of
    # the restored state.
    actions = np.random.RandomState(1).uniform(-1, 1, (6, 5)).astype(
        np.float32)
    results = {}

    def probe(i):
      results[i] = batcher.predict({"state/image": image,
                                    "action/action": actions[i:i + 1]})

    threads = [threading.Thread(target=probe, args=(i,)) for i in range(6)]
    for t in threads:
      t.start()
    for t in threads:
      t.join(timeout=30.0)
    assert not any(t.is_alive() for t in threads)
    features, _ = model.preprocessor.preprocess(
        {"state/image": torch.from_numpy(np.repeat(image, 6, axis=0)),
         "action/action": torch.from_numpy(actions)},
        specs.SpecStruct(), "predict")
    with torch.no_grad():
      want, _ = model.inference_network_fn(state.ema_params,
                                           state.mutable_state, features,
                                           "predict")
    got = np.concatenate([results[i]["q_predicted"] for i in range(6)])
    assert _rel(got, want["q_predicted"].numpy()) <= Q_RTOL
    action = policy.select_action({"image": image[0]})
    assert action.shape == (5,) and np.all(np.abs(action) <= 1.0)
    assert engine.warm_count == 3

  device_policy = device_cem.DeviceCEMPolicy(
      model=model, state=predictor.state, action_size=5, cem_samples=8,
      cem_iterations=2, cem_elites=3, device="cpu")
  device_action = device_policy.select_action({"image": image[0]})
  assert np.all(np.abs(device_action) <= 1.0)
  rescored = predictor.predict({"state/image": image,
                                "action/action": device_action[None]})
  assert device_policy.last_q_value == pytest.approx(
      float(rescored["q_predicted"][0, 0]), rel=Q_RTOL)
