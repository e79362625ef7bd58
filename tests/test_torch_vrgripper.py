"""The VRGripper models in the port against the JAX package, on the CPU.

`research/vrgripper/models.py`, flax's parameters (redrawn, 0.3 x N(0,
1)) carried across by `bridge.py`, one train-mode forward, loss and
gradient on each side:

* `VRGripperRegressionModel`: the MSE head with and without
  `gripper_pose`, the MDN head; `WTLTrialModel` (its trial frames
  ignored); `VRGripperTECModel` with a `task_id` (the triplet term);
  `VRGripperDomainAdaptiveModel`'s outer forward (its learned-loss and
  condition-pose parameters get zero gradients, as in JAX);
* `WTLStateTrialModel`: trial and retrial, 'temporal', 'final' and
  'mean', without the embedding, and the MDN head;
  `WTLVisionTrialModel` with 1 and 2 condition episodes;
* `VRGripperPreprocessor` on the JAX package's own draws (train and
  eval); the learned loss's even-width SAME conv1d at T = 8;
* `pack_wtl_meta_features`, `make_fixed_length`,
  `episode_to_transitions` and the action binning, exactly equal;
* `configs/train_vrgripper_mdn.gin` through the trainer CLI at image 16,
  served by `CheckpointPredictor` bit for bit against the eval forward.

Tolerances, of max(1, max |ref|): float64 (JAX under `jax.enable_x64`)
1e-10 for values and gradients; float32 1e-5 for values, 1e-4 x max(1,
max |g|) for gradients; preprocessed images 1e-6 absolute. The JAX
spatial softmax and MDN head round to float32 even under x64; the
float64 cases widen those casts (`widen_float32_casts`). An MDN head's
`action` (the argmax component's mean) is compared only on rows whose
two largest logits are at least 1e-3 apart, where no rounding can pick
another component; its parameters, the NLL and the gradients are
compared on every row.
"""

import pathlib

import flax.linen as flax_nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensor2robot_tpu.layers import mdn as jax_mdn
from tensor2robot_tpu.layers import spatial_softmax as jax_spatial_softmax
from tensor2robot_tpu.research.vrgripper import models as jax_models
from tensor2robot_tpu.specs import SpecStruct as JaxSpecStruct
from tensor2robot_tpu_torch.bin import run_t2r_trainer
from tensor2robot_tpu_torch.layers import flax_layers
from tensor2robot_tpu_torch.predictors import predictors
from tensor2robot_tpu_torch.research.vrgripper import models
from tensor2robot_tpu_torch.specs import SpecStruct
from tensor2robot_tpu_torch.utils import config
from tests import torch_model_parity as parity

torch.set_num_threads(1)

F64_TOL = 1e-10
F32_TOL = 1e-5
GRAD_TOL = 1e-4
IMAGE_TOL = 1e-6
MODE_GAP = 1e-3
B, T, IMAGE = 2, 3, 16
REPO = pathlib.Path(__file__).resolve().parent.parent


def _images(rng, *lead):
  return rng.rand(*lead, IMAGE, IMAGE, 3)


def _episode_batch(rng, pose=True, trial=False, action=7):
  features = {"image": _images(rng, B, T)}
  if pose:
    features["gripper_pose"] = rng.randn(B, T, 7)
  if trial:
    features["trial_frames"] = _images(rng, B, T)
    features["trial_rewards"] = rng.rand(B, T, 1)
  return features, {"action": rng.randn(B, T, action)}


def _tec_batch(rng):
  features = {"demo_frames": rng.randn(4, 5, 6),
              "observation": rng.randn(4, 6)}
  return features, {"action": rng.randn(4, 3),
                    "task_id": np.array([0, 0, 1, 1], np.int64)}


def _wtl_state_batch(rng, episodes, obs=6, action=3):
  features = {
      "condition/features/full_state_pose": rng.randn(B, episodes, T, obs),
      "condition/labels/action": rng.randn(B, episodes, T, action),
      "condition/labels/success": (rng.rand(B, episodes, T, 1) > 0.5
                                   ).astype(np.float64),
      "inference/features/full_state_pose": rng.randn(B, 1, T, obs)}
  return features, {"action": rng.randn(B, 1, T, action),
                    "success": np.ones((B, 1, T, 1))}


def _wtl_vision_batch(rng, episodes, action=3):
  features = {
      "condition/features/image": _images(rng, B, episodes, T),
      "condition/features/gripper_pose": rng.randn(B, episodes, T, 7),
      "condition/labels/action": rng.randn(B, episodes, T, action),
      "condition/labels/success": (rng.rand(B, episodes, T, 1) > 0.5
                                   ).astype(np.float64),
      "inference/features/image": _images(rng, B, 1, T),
      "inference/features/gripper_pose": rng.randn(B, 1, T, 7)}
  return features, {"action": rng.randn(B, 1, T, action),
                    "success": np.ones((B, 1, T, 1))}


EPISODE = dict(episode_length=T, image_size=IMAGE)
STATE = dict(obs_size=6, action_size=3, episode_length=T, fc_embed_size=8)
VISION = dict(image_size=IMAGE, action_size=3, episode_length=T,
              fc_embed_size=8, num_feature_points=8, embed_fc_layers=(12, 10))

# name -> (JAX model class, kwargs, the port's extra kwargs, batch fn)
CASES = {
    "mse": ("VRGripperRegressionModel", EPISODE, {},
            lambda rng: _episode_batch(rng, pose=False)),
    "mse_pose": ("VRGripperRegressionModel", EPISODE,
                 {"use_gripper_pose": True}, _episode_batch),
    "mdn": ("VRGripperRegressionModel",
            dict(EPISODE, num_mixture_components=3),
            {"use_gripper_pose": True}, _episode_batch),
    "wtl_trial_model": ("WTLTrialModel", dict(EPISODE, trial_length=T), {},
                        lambda rng: _episode_batch(rng, pose=False,
                                                   trial=True)),
    "tec_task_id": ("VRGripperTECModel",
                    dict(demo_length=5, obs_size=6, action_size=3,
                         embedding_size=8), {}, _tec_batch),
    "domain_adaptive": ("VRGripperDomainAdaptiveModel",
                        dict(EPISODE, action_size=2), {},
                        lambda rng: _episode_batch(rng, action=2)),
    "state_trial_temporal": ("WTLStateTrialModel", STATE, {},
                             lambda rng: _wtl_state_batch(rng, 1)),
    "state_trial_final": ("WTLStateTrialModel",
                          dict(STATE, embed_type="final"), {},
                          lambda rng: _wtl_state_batch(rng, 1)),
    "state_retrial_temporal": ("WTLStateTrialModel",
                               dict(STATE, retrial=True), {},
                               lambda rng: _wtl_state_batch(rng, 2)),
    "state_retrial_final": ("WTLStateTrialModel",
                            dict(STATE, retrial=True, embed_type="final"),
                            {}, lambda rng: _wtl_state_batch(rng, 2)),
    "state_retrial_mean": ("WTLStateTrialModel",
                           dict(STATE, retrial=True, embed_type="mean"),
                           {}, lambda rng: _wtl_state_batch(rng, 2)),
    "state_retrial_no_embedding": ("WTLStateTrialModel",
                                   dict(STATE, retrial=True,
                                        ignore_embedding=True), {},
                                   lambda rng: _wtl_state_batch(rng, 2)),
    "state_retrial_mdn": ("WTLStateTrialModel",
                          dict(STATE, retrial=True,
                               num_mixture_components=3), {},
                          lambda rng: _wtl_state_batch(rng, 2)),
    "vision_1_episode": ("WTLVisionTrialModel", VISION, {},
                         lambda rng: _wtl_vision_batch(rng, 1)),
    "vision_2_episodes": ("WTLVisionTrialModel",
                          dict(VISION, num_condition_episodes=2), {},
                          lambda rng: _wtl_vision_batch(rng, 2)),
}
# float32 on the JAX package's own (unwidened) path; the domain-adaptive
# network runs float32 in tests/test_torch_vrgripper_maml.py.
F32_CASES = ("mse_pose", "mdn", "tec_task_id", "state_retrial_temporal",
             "state_retrial_mdn", "vision_1_episode")


def _models(name):
  cls, kwargs, port_kwargs, batch_fn = CASES[name]
  jax_model = getattr(jax_models, cls)(device_type="cpu", **kwargs)
  model = getattr(models, cls)(**kwargs, **port_kwargs)
  return jax_model, model, batch_fn


def _cast(tree, dtype):
  return {k: v.astype(dtype) if v.dtype.kind == "f" else v
          for k, v in tree.items()}


def _split_mode_rows(outputs_got, outputs_want):
  """Pops `action` and `inference_output` of an MDN model from both and
  returns (got, want) on the rows whose top two logits are MODE_GAP
  apart."""
  logits = outputs_want["mdn_params/logits"]
  top2 = np.sort(logits, axis=-1)[..., -2:]
  keep = (top2[..., 1] - top2[..., 0]) >= MODE_GAP
  assert keep.mean() >= 0.75, keep
  got = parity.np64(outputs_got.pop("action"))[keep]
  want = parity.np64(outputs_want.pop("action"))[keep]
  outputs_got.pop("inference_output")
  outputs_want.pop("inference_output")
  return got, want


def _check_case(name, dtype, monkeypatch):
  jax_model, model, batch_fn = _models(name)
  features, labels = batch_fn(np.random.RandomState(7))
  variables = parity.init_variables(jax_model, _cast(features, np.float32))
  params = parity.randomized(variables["params"], 11)
  if dtype == torch.float64:
    parity.widen_float32_casts(monkeypatch, jax_spatial_softmax, jax_mdn)
    jdt, np_dt, tol, grad_tol = jnp.float64, np.float64, F64_TOL, F64_TOL
  else:
    jdt, np_dt, tol, grad_tol = jnp.float32, np.float32, F32_TOL, GRAD_TOL
  features, labels = _cast(features, np_dt), _cast(labels, np_dt)
  want = parity.jax_train(jax_model, {"params": params}, features, labels,
                          jdt)
  got = parity.port_train(model, parity.bridged(params), {}, features,
                          labels, dtype)
  mode_errs = {}
  if "mdn_params/logits" in want[1]:
    g, w = _split_mode_rows(got[1], want[1])
    mode_errs["mode_action"] = parity.scaled_err(g, w)
  errs = parity.compare_train(got, want, tol, grad_tol)
  assert all(v <= tol for v in mode_errs.values()), mode_errs
  return got, want, errs


@pytest.mark.parametrize("name", sorted(CASES))
def test_train_step_float64(name, monkeypatch):
  got, want, _ = _check_case(name, torch.float64, monkeypatch)
  assert np.isfinite(float(got[0]))
  if name == "domain_adaptive":  # the outer BC loss reaches no ll_ / pose_
    unused = [k for k in got[3] if k.startswith(("ll_", "pose_"))]
    assert unused and all(not got[3][k].any() for k in unused)
    assert all(not want[3][k].any() for k in unused)
  if name == "tec_task_id":
    assert "embedding_triplet" in got[2] and float(
        got[2]["embedding_triplet"]) > 0.0


@pytest.mark.parametrize("name", F32_CASES)
def test_train_step_float32(name, monkeypatch):
  _check_case(name, torch.float32, monkeypatch)


def test_gripper_pose_flag_must_match_the_batch():
  model = models.VRGripperRegressionModel(**EPISODE)
  features, labels = _episode_batch(np.random.RandomState(0))
  params = model.init_params(torch.Generator().manual_seed(0))
  tensors = SpecStruct({k: torch.from_numpy(v).float()
                        for k, v in features.items()})
  with pytest.raises(ValueError, match="use_gripper_pose"):
    model.inference_network_fn(params, {}, tensors, "train")


def test_wtl_retrial_requires_two_condition_episodes():
  model = models.WTLStateTrialModel(obs_size=4, action_size=2,
                                    episode_length=3, retrial=True)
  spec = model.get_feature_specification("train")
  assert spec["condition/features/full_state_pose"].shape[0] == 2
  with pytest.raises(ValueError, match="embed_type"):
    models.WTLStateTrialModel(embed_type="max").module


# -- the preprocessor ------------------------------------------------------------


class _InjectedDraws(models.VRGripperPreprocessor):
  """The port's preprocessor fed the JAX package's draws for its key."""

  seeds = ()

  def draws(self, seed, image_shape, is_training):
    self.seeds += (seed,)
    if not is_training:
      return {}
    b, h, w, _ = image_shape
    key_crop, key_dist = jax.random.split(jax.random.PRNGKey(seed))
    key_top, key_left = jax.random.split(key_crop)
    th, tw = self._input_size
    out = {"tops": jax.random.randint(key_top, (b,), 0, h - th + 1),
           "lefts": jax.random.randint(key_left, (b,), 0, w - tw + 1)}
    keys = jax.random.split(key_dist, 5)
    uniform = lambda k, lo, hi: jax.random.uniform(k, (b, 1, 1, 1),
                                                   minval=lo, maxval=hi)
    out["brightness"] = uniform(keys[0], -0.125, 0.125)
    out["saturation"] = uniform(keys[1], 0.5, 1.5)
    out["hue"] = jax.random.uniform(keys[2], (b,), minval=-0.2 * jnp.pi,
                                    maxval=0.2 * jnp.pi)
    out["contrast"] = uniform(keys[3], 0.5, 1.5)
    return {k: torch.from_numpy(np.array(v)) for k, v in out.items()}


@pytest.mark.parametrize("mode", ["train", "eval"])
def test_preprocessor_with_injected_draws(mode):
  kwargs = dict(input_size=(20, 20), model_size=(IMAGE, IMAGE), seed=3)
  jax_model = jax_models.VRGripperRegressionModel(device_type="cpu",
                                                  **EPISODE)
  model = models.VRGripperRegressionModel(**EPISODE)
  jax_pre = jax_models.VRGripperPreprocessor(
      model_feature_specification_fn=jax_model.get_feature_specification,
      model_label_specification_fn=jax_model.get_label_specification,
      **kwargs)
  pre = _InjectedDraws(
      model_feature_specification_fn=model.get_feature_specification,
      model_label_specification_fn=model.get_label_specification, **kwargs)
  assert pre.get_in_feature_specification(mode)["image"].shape == (
      T, 20, 20, 3)
  rng = np.random.RandomState(5)
  image = rng.randint(0, 256, (B, T, 20, 20, 3)).astype(np.uint8)
  labels = {"action": rng.randn(B, T, 7).astype(np.float32)}
  for call in (1, 2):  # each call keys on seed + its count
    want, _ = jax_pre.preprocess(JaxSpecStruct({"image": image}),
                                 JaxSpecStruct(labels), mode)
    got, got_labels = pre.preprocess(
        SpecStruct({"image": torch.from_numpy(image)}),
        SpecStruct({k: torch.from_numpy(v) for k, v in labels.items()}),
        mode)
    assert got["image"].dtype == torch.float32
    assert got["image"].shape == (B, T, IMAGE, IMAGE, 3)
    assert float(np.abs(parity.np64(got["image"])
                        - parity.np64(want["image"])).max()) <= IMAGE_TOL
    assert torch.equal(got_labels["action"],
                       torch.from_numpy(labels["action"]))
  assert pre.seeds == (4, 5)


# -- the learned loss's conv1d ---------------------------------------------------


def test_even_width_same_conv1d_at_t8():
  """kernel 10 'SAME' pads 4 before and 5 after; putting the 5 first (or
  a symmetric 5) would shift the output a frame and still be finite."""
  rng = np.random.RandomState(2)
  x = rng.randn(2, 8, 5)
  conv = flax_nn.Conv(4, kernel_size=(10,), use_bias=False, padding="SAME")
  params = parity.randomized(
      conv.init(jax.random.PRNGKey(0), jnp.zeros((2, 8, 5)))["params"], 3)
  with jax.enable_x64(True):
    want = np.asarray(conv.apply(
        {"params": parity.cast_tree(params, jnp.float64)}, jnp.asarray(x)))
  layer = torch.nn.Conv1d(5, 4, 10, bias=False).double()
  layer.weight.data = parity.bridged({"conv": params})["conv.weight"]
  got = flax_layers.conv1d_same(torch.from_numpy(x), layer.weight)
  assert got.shape == (2, 8, 4)
  assert parity.scaled_err(got, want) <= 1e-12
  # torch's own 'same' pads the same way ...
  same = torch.nn.functional.conv1d(torch.from_numpy(x).transpose(1, 2),
                                    layer.weight, padding="same")
  assert parity.scaled_err(same.transpose(1, 2), want) <= 1e-12
  # ... and the 5-first padding does not.
  shifted = torch.nn.functional.conv1d(
      torch.nn.functional.pad(torch.from_numpy(x).transpose(1, 2), (5, 4)),
      layer.weight).transpose(1, 2)
  assert parity.scaled_err(shifted, want) > 1e-2


# -- numpy helpers ---------------------------------------------------------------


class _Obs:
  pass


def _obs(rng, vision):
  obs = _Obs()
  if vision:
    obs.image = rng.randint(0, 256, (8, 8, 3)).astype(np.uint8)
    obs.pose = rng.randn(7).astype(np.float32)
  else:
    obs.full_state_pose = rng.randn(6).astype(np.float32)
  return obs


@pytest.mark.parametrize("vision", [False, True])
@pytest.mark.parametrize("episodes", [1, 2])
def test_pack_wtl_meta_features_equals_jax(vision, episodes):
  rng = np.random.RandomState(episodes + 2 * vision)
  demo = [(_obs(rng, vision), rng.randn(2), 1.0) for _ in range(7)]
  trial = [(_obs(rng, vision), rng.randn(2), 0.0) for _ in range(3)]
  state = _obs(rng, vision)
  prev = [demo, trial][:episodes]
  want = jax_models.pack_wtl_meta_features(state, prev, 0, 4, 2,
                                           vision=vision)
  got = models.pack_wtl_meta_features(state, prev, 0, 4, 2, vision=vision)
  assert set(got) == set(want)
  for key in want:
    assert got[key].dtype == want[key].dtype, key
    np.testing.assert_array_equal(got[key], want[key])


def test_make_fixed_length_equals_jax():
  data = list(range(10))
  for n, length in ((10, 4), (2, 5), (10, 10), (3, 7)):
    assert (models.make_fixed_length(data[:n], length)
            == jax_models.make_fixed_length(data[:n], length))
    assert (models.make_fixed_length(data[:n], length, randomized=True,
                                     rng=np.random.RandomState(n))
            == jax_models.make_fixed_length(data[:n], length,
                                            randomized=True,
                                            rng=np.random.RandomState(n)))
  with pytest.raises(ValueError):
    models.make_fixed_length([], 4)


@pytest.mark.parametrize("steps", [3, 5, 8])
def test_episode_to_transitions_equals_jax(steps):
  rng = np.random.RandomState(steps)
  episode = [{"obs": {"image": rng.randint(0, 256, (4, 4, 3)).astype(
      np.uint8)}, "action": rng.randn(2)} for _ in range(steps)]
  want = jax_models.episode_to_transitions(episode, episode_length=5)
  got = models.episode_to_transitions(episode, episode_length=5)
  for key in ("image", "action"):
    assert got[key].dtype == want[key].dtype
    np.testing.assert_array_equal(got[key], want[key])


def test_discretize_actions_equal_jax():
  actions = np.array([[-1.5, -1.0, -0.3, 0.0, 0.49, 0.999, 1.0, 2.0]],
                     np.float32)
  want_bins = np.asarray(jax_models.discretize_actions(
      jnp.asarray(actions), num_bins=10))
  bins = models.discretize_actions(torch.from_numpy(actions), num_bins=10)
  np.testing.assert_array_equal(bins.numpy(), want_bins)
  assert bins.dtype == torch.int32
  np.testing.assert_array_equal(
      models.undiscretize_actions(bins, num_bins=10).numpy(),
      np.asarray(jax_models.undiscretize_actions(jnp.asarray(want_bins),
                                                 num_bins=10)))


# -- the config ------------------------------------------------------------------


def test_mdn_config_trains_and_serves(tmp_path):
  try:
    metrics = run_t2r_trainer.main([
        "--config_files", str(REPO / "tensor2robot_tpu_torch" / "configs"
                              / "train_vrgripper_mdn.gin"),
        "--config", f"train_eval_model.model_dir = '{tmp_path}'",
        "--config", "train_eval_model.device = 'cpu'",
        "--config", "train_eval_model.max_train_steps = 3",
        "--config", "train_eval_model.checkpoint_every_n_steps = 3",
        "--config", f"VRGripperRegressionModel.episode_length = {T}",
        "--config", f"VRGripperRegressionModel.image_size = {IMAGE}",
        "--config", "DefaultRandomInputGenerator.batch_size = 2"])
  finally:
    config.clear_config()
  assert np.isfinite(metrics["loss"]) and "nll" in metrics
  model = models.VRGripperRegressionModel(num_mixture_components=5,
                                          **EPISODE)
  predictor = predictors.CheckpointPredictor(model=model,
                                             model_dir=str(tmp_path),
                                             device="cpu")
  assert predictor.restore() and predictor.global_step == 3
  request = {"image": np.random.RandomState(3).rand(1, T, IMAGE, IMAGE, 3)
             .astype(np.float32)}
  served = predictor.predict(request)
  assert served["action"].shape == (1, T, 7)
  assert served["mdn_params/means"].shape == (1, T, 5, 7)
  with torch.no_grad():
    forward, _ = model.inference_network_fn(
        predictor.state.eval_params(), predictor.state.mutable_state,
        SpecStruct({"image": torch.from_numpy(request["image"])}), "predict")
  for key, value in served.items():
    np.testing.assert_array_equal(value, forward[key].numpy())
