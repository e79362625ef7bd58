"""BC-Z in the port against the JAX package, on the CPU.

`research/bcz/models.py`:

* `BCZPreprocessor` with the JAX package's own draws injected (train:
  random crop, antialiased resize, photometric chain; eval: center crop),
  gripper binarization, mixup with numpy's `lam` (exact) and its switch
  off under discrete conditioning;
* `BCZModel` train steps, flax's parameters carried across by
  `bridge.py`: the FiLM-ResNet trunk with language conditioning, residual
  components (`_absolute` outputs), stop and stop-state heads, in float64
  (the new batch statistics too); the spatial-softmax trunk under every
  conditioning mode (none, language, one-hot subtask with an id out of
  range, language with the JAX package's noise draw injected, the ignored
  embedding, user embeddings), past frames through the GRU encoder, loss
  clipping; the eval metrics with gripper metrics; the bf16 forward; one
  whole JAX train step (Adam) carried across and repeated;
* `configs/train_bcz.gin` through the trainer CLI at image 32, then
  `CheckpointPredictor` and `xyz_action_trajectory` on its checkpoint.

Tolerances, of max(1, max |ref|): float64 (JAX under `jax.enable_x64`)
1e-10, values and gradients; float32 1e-5 for values, 1e-4 x max(1, max
|g|) for gradients; preprocessed images 1e-6 absolute; bf16 forward
max(1e-2, 4x JAX's bf16 distance from its f32 forward). The spatial
softmax runs float32 in JAX even under x64, and flax's GRU scan refuses
float64: their cases run in float32.
"""

import functools
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensor2robot_tpu import modes as jax_modes
from tensor2robot_tpu.parallel import train_step as jax_train_step
from tensor2robot_tpu.research.bcz import models as jax_models
from tensor2robot_tpu.specs import SpecStruct as JaxSpecStruct
from tensor2robot_tpu_torch import bridge
from tensor2robot_tpu_torch.bin import run_t2r_trainer
from tensor2robot_tpu_torch.parallel import train_step
from tensor2robot_tpu_torch.predictors import predictors
from tensor2robot_tpu_torch.research.bcz import models
from tensor2robot_tpu_torch.specs import SpecStruct
from tensor2robot_tpu_torch.utils import config
from tests import torch_model_parity as parity

torch.set_num_threads(1)

F64_TOL = 1e-10
F32_TOL = 1e-5
GRAD_TOL = 1e-4
IMAGE_TOL = 1e-6
BF16_FLOOR = 1e-2
BF16_FACTOR = 4.0
BATCH = 4
WAYPOINTS = 3
ADAM_LR = 1e-4  # both packages' default optimizer
REPO = pathlib.Path(__file__).resolve().parent.parent


# -- the preprocessor ----------------------------------------------------------

class _InjectedDraws(models.BCZPreprocessor):
  """The port's preprocessor fed the JAX package's draws for its key."""

  seeds = ()

  def draws(self, seed, image_shape, is_training):
    self.seeds += (seed,)
    if not is_training:
      return {}
    b, h, w, c = image_shape
    key_crop, key_dist = jax.random.split(jax.random.PRNGKey(seed))
    key_top, key_left = jax.random.split(key_crop)
    th, tw = self._crop_size
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


PRE_KW = dict(input_size=(30, 30), crop_size=(24, 24), model_size=(16, 16))


def _preprocessors(model_kw=None, **kwargs):
  model_kw = dict(image_size=16, num_waypoints=WAYPOINTS, **(model_kw or {}))
  jax_model = jax_models.BCZModel(device_type="cpu", **model_kw)
  model = models.BCZModel(**model_kw)
  jax_pre = jax_models.BCZPreprocessor(
      model_feature_specification_fn=jax_model.get_feature_specification,
      model_label_specification_fn=jax_model.get_label_specification,
      **PRE_KW, **kwargs)
  pre = _InjectedDraws(
      model_feature_specification_fn=model.get_feature_specification,
      model_label_specification_fn=model.get_label_specification,
      **PRE_KW, **kwargs)
  return jax_pre, pre


def _wire_batch(seed, condition=True, subtask=False):
  rng = np.random.RandomState(seed)
  features = {"image": rng.randint(0, 256, (BATCH, 30, 30, 3)).astype(
      np.uint8)}
  if condition:
    features["condition_embedding"] = rng.randn(BATCH, 6).astype(np.float32)
  if subtask:
    features["subtask_id"] = rng.randint(0, 3, (BATCH, 1)).astype(np.int64)
  labels = {name: rng.rand(BATCH, WAYPOINTS, size).astype(np.float32)
            for name, size, _ in models.POSE_COMPONENTS}
  labels["stop"] = (rng.rand(BATCH, WAYPOINTS) > 0.5).astype(np.float32)
  return features, labels


def _preprocess_both(jax_pre, pre, features, labels, mode):
  want_f, want_l = jax_pre.preprocess(JaxSpecStruct(features),
                                      JaxSpecStruct(labels), mode)
  got_f, got_l = pre.preprocess(
      SpecStruct({k: torch.from_numpy(v) for k, v in features.items()}),
      SpecStruct({k: torch.from_numpy(v) for k, v in labels.items()}), mode)
  assert set(got_f) == set(want_f) and set(got_l) == set(want_l)
  return got_f, got_l, want_f, want_l


def _image_err(got, want) -> float:
  return float(np.abs(parity.np64(got) - parity.np64(want)).max())


@pytest.mark.parametrize("mode", ["train", "eval"])
def test_preprocessor_with_injected_draws(mode):
  jax_pre, pre = _preprocessors(dict(condition_size=6))
  for call in (1, 2):  # the call counter seeds each call anew
    features, labels = _wire_batch(call)
    got_f, got_l, want_f, want_l = _preprocess_both(jax_pre, pre, features,
                                                    labels, mode)
    assert got_f["image"].shape == (BATCH, 16, 16, 3)
    assert got_f["image"].dtype == torch.float32
    assert _image_err(got_f["image"], want_f["image"]) <= IMAGE_TOL
    assert set(np.unique(got_l["gripper"].numpy())) <= {0.0, 1.0}
    for key in want_l:
      np.testing.assert_array_equal(got_l[key].numpy(), want_l[key])
  assert pre.seeds == (1, 2)  # seed + calls


def test_mixup_uses_numpy_s_lam_exactly():
  jax_pre, pre = _preprocessors(dict(condition_size=6), mixup_alpha=0.4,
                                seed=3)
  features, labels = _wire_batch(5)
  got_f, got_l, want_f, want_l = _preprocess_both(jax_pre, pre, features,
                                                  labels, "train")
  assert _image_err(got_f["image"], want_f["image"]) <= IMAGE_TOL
  np.testing.assert_array_equal(got_f["condition_embedding"].numpy(),
                                want_f["condition_embedding"])
  for key in want_l:
    np.testing.assert_array_equal(got_l[key].numpy(), want_l[key])
  # The blend happened: the embedding is no longer the wire's.
  assert not np.array_equal(want_f["condition_embedding"],
                            features["condition_embedding"])


def test_discrete_conditioning_disables_mixup():
  jax_pre, pre = _preprocessors(
      dict(condition_mode="onehot_taskid", num_subtasks=3), mixup_alpha=0.4)
  features, labels = _wire_batch(6, condition=False, subtask=True)
  got_f, got_l, want_f, want_l = _preprocess_both(jax_pre, pre, features,
                                                  labels, "train")
  np.testing.assert_array_equal(got_l["xyz"].numpy(), labels["xyz"])
  np.testing.assert_array_equal(got_l["xyz"].numpy(), want_l["xyz"])


def test_preprocessor_in_specs_rewrite_the_image():
  _, pre = _preprocessors(dict(condition_size=6))
  spec = pre.get_in_feature_specification("train")["image"]
  assert spec.shape == (30, 30, 3) and spec.dtype == np.uint8
  assert pre.get_out_feature_specification("train")["image"].shape == (
      16, 16, 3)


# -- the model -------------------------------------------------------------------

def _models(**kwargs):
  kw = dict(num_waypoints=WAYPOINTS, **kwargs)
  return jax_models.BCZModel(device_type="cpu", **kw), models.BCZModel(**kw)


def _features(seed, image, dtype, condition_size=0, subtasks=0, users=0,
              past=0, present=()):
  rng = np.random.RandomState(seed)
  f = {"image": rng.rand(BATCH, image, image, 3).astype(dtype)}
  if condition_size:
    f["condition_embedding"] = rng.randn(BATCH, condition_size).astype(dtype)
  if subtasks:  # one id past the vocabulary: a zero one-hot row
    f["subtask_id"] = np.array([[0], [2], [subtasks], [1]], np.int64)
  if users:
    f["user_id"] = rng.randint(0, users, (BATCH,)).astype(np.int64)
  if past:
    f["past_frames"] = rng.rand(BATCH, past, image, image, 3).astype(dtype)
  for name, size in present:
    f[f"present_{name}"] = rng.randn(BATCH, size).astype(dtype)
  return f


def _labels(seed, components, dtype, stop_state=False, scale=1.0):
  rng = np.random.RandomState(seed)
  labels = {name: (scale * rng.randn(BATCH, WAYPOINTS, size)).astype(dtype)
            for name, size, _, _ in models.normalize_components(components)}
  stop = np.zeros((BATCH, WAYPOINTS), dtype)
  stop[0, 1:] = 1.0
  stop[2, 2:] = 1.0
  labels["stop"] = stop
  if stop_state:
    labels["stop_state"] = np.array([0, 2, 1, 5], np.int64)  # 5 is clipped
  return labels


def _variables(jax_model, features, seed=0):
  return parity.init_variables(jax_model, features, seed)


def _port_variables(model, variables):
  params = bridge.state_dict_from_flax(variables["params"])
  buffers = bridge.mutable_state_from_flax(variables.get("batch_stats", {}))
  assert set(params) == set(dict(model.module.named_parameters()))
  assert set(buffers) == set(dict(model.module.named_buffers()))
  return params, buffers


def _train_parity(jax_model, model, features, labels, dtype, rng=None):
  variables = _variables(jax_model, {
      k: v.astype(np.float32) if v.dtype == np.float64 else v
      for k, v in features.items()})
  jdtype, tdtype, tol, grad_tol = (
      (jnp.float64, torch.float64, F64_TOL, F64_TOL) if dtype == np.float64
      else (jnp.float32, torch.float32, F32_TOL, GRAD_TOL))
  want = parity.jax_train(jax_model, variables, features, labels, jdtype,
                          rng=rng)
  got = parity.port_train(model, *_port_variables(model, variables),
                          features, labels, tdtype)
  return parity.compare_train(got, want, tol, grad_tol), got


def test_resnet_film_language_residual_stop_state_float64():
  kw = dict(image_size=32, condition_size=6,
            components=models.REFERENCE_ACTION_COMPONENTS,
            predict_stop_state=True)
  jax_model, model = _models(**kw)
  features = _features(0, 32, np.float64, condition_size=6,
                       present=[("xyz", 3)])
  labels = _labels(1, models.REFERENCE_ACTION_COMPONENTS, np.float32,
                   stop_state=True)
  errs, got = _train_parity(jax_model, model, features, labels, np.float64)
  outputs = got[1]
  assert outputs["xyz_absolute"].shape == (BATCH, WAYPOINTS, 3)
  np.testing.assert_allclose(
      outputs["xyz_absolute"].numpy(),
      (outputs["xyz"] + torch.from_numpy(features["present_xyz"])[:, None])
      .numpy(), rtol=0, atol=1e-12)
  assert outputs["stop_state"].shape == (BATCH, WAYPOINTS, 3)
  assert {"loss/xyz", "loss/quaternion", "loss/target_close", "loss/stop",
          "loss/stop_state"} == set(got[2])
  assert any(k.startswith("state/resnet.layer4") for k in errs)
  # The stop head trains only its own layers; the stop-state head's rest
  # logits see detached features.
  assert any(k.startswith("resnet.film_generator") for k in got[3])


CONDITIONING = {
    "none": dict(),
    "language": dict(condition_size=5),
    "onehot_taskid": dict(condition_mode="onehot_taskid", num_subtasks=3),
    "ignored": dict(condition_size=5, ignore_task_embedding=True),
    "users": dict(condition_size=5, num_users=3),
}


@pytest.mark.parametrize("mode", sorted(CONDITIONING))
def test_spatial_softmax_trunk_conditioning(mode):
  kw = dict(image_size=20, network="spatial_softmax", **CONDITIONING[mode])
  jax_model, model = _models(**kw)
  features = _features(2, 20, np.float32,
                       condition_size=kw.get("condition_size", 0),
                       subtasks=kw.get("num_subtasks", 0),
                       users=kw.get("num_users", 0))
  labels = _labels(3, models.POSE_COMPONENTS, np.float32)
  _train_parity(jax_model, model, features, labels, np.float32)
  film = any(k.startswith("tower.film_") for k in
             dict(model.module.named_parameters()))
  assert film == (mode not in ("none", "ignored"))


def test_task_embedding_noise_injected(monkeypatch):
  kw = dict(image_size=20, network="spatial_softmax", condition_size=5,
            task_embedding_noise_std=0.3)
  jax_model, model = _models(**kw)
  features = _features(4, 20, np.float32, condition_size=5)
  labels = _labels(5, models.POSE_COMPONENTS, np.float32)
  # A JAX draw stands in for the one flax's `make_rng('dropout')` makes
  # inside the jitted step; both sides get it.
  noise = np.asarray(jax.random.normal(jax.random.PRNGKey(11), (BATCH, 5)))
  draws = []

  def injected(key, shape=(), dtype=jnp.float32, *args, **kwargs):
    draws.append(tuple(shape))
    return jnp.asarray(noise, dtype)

  monkeypatch.setattr(jax.random, "normal", injected)
  model.module.noise_fn = lambda shape, dtype, device: torch.tensor(
      noise, dtype=dtype, device=device)
  _train_parity(jax_model, model, features, labels, np.float32,
                rng=jax.random.PRNGKey(11))
  # The noise reaches the loss: without it the loss differs.
  params = model.init_params(torch.Generator().manual_seed(0))
  noisy = parity.port_train(model, params, {}, features, labels,
                            torch.float32)[0]
  model.module.noise_fn = lambda shape, dtype, device: torch.zeros(
      shape, dtype=dtype, device=device)
  clean = parity.port_train(model, params, {}, features, labels,
                            torch.float32)[0]
  assert float(clean) != float(noisy)
  assert draws and set(draws) == {(BATCH, 5)}  # init and the step
  # Without injection the port draws from its own seeded generator, anew
  # each call, and a fresh model repeats the sequence.
  port = models.BCZModel(**kw).module
  a = port._draw_noise((2, 3), torch.float32, torch.device("cpu"))
  b = port._draw_noise((2, 3), torch.float32, torch.device("cpu"))
  c = models.BCZModel(**kw).module._draw_noise(
      (2, 3), torch.float32, torch.device("cpu"))
  assert not torch.equal(a, b) and torch.equal(a, c)
  with pytest.raises(ValueError, match="remat"):
    models.BCZModel(**kw, remat=True)


def test_past_frames_through_the_gru_encoder():
  kw = dict(image_size=16, network="spatial_softmax", num_past_frames=2)
  jax_model, model = _models(**kw)
  features = _features(6, 16, np.float32, past=2)
  labels = _labels(7, models.POSE_COMPONENTS, np.float32)
  errs, _ = _train_parity(jax_model, model, features, labels, np.float32)
  assert any(k.startswith("past_encoder.GRUCell_0") for k in
             dict(model.module.named_parameters()))


def test_loss_clipping():
  kw = dict(image_size=16, network="spatial_softmax", loss_clip_threshold=0.2,
            predict_stop=False)
  jax_model, model = _models(**kw)
  features = _features(8, 16, np.float32)
  labels = _labels(9, models.POSE_COMPONENTS, np.float32, scale=5.0)
  del labels["stop"]
  _, got = _train_parity(jax_model, model, features, labels, np.float32)
  # Every component's raw huber mean is above 1: all are clipped.
  assert all(float(v) < 0.3 for v in got[2].values())


def test_eval_metrics_with_gripper_metrics():
  kw = dict(image_size=16, network="spatial_softmax",
            gripper_metrics_component="gripper", predict_stop_state=True)
  jax_model, model = _models(**kw)
  features = _features(10, 16, np.float32)
  features["present_gripper"] = np.array([[0.1], [0.9], [0.5], [0.2]],
                                         np.float32)
  labels = _labels(11, models.POSE_COMPONENTS, np.float32, stop_state=True)
  variables = _variables(jax_model, features)
  outputs, _ = jax_model.inference_network_fn(
      variables, JaxSpecStruct(features), jax_modes.EVAL)
  want = jax_model.model_eval_fn(JaxSpecStruct(features),
                                 JaxSpecStruct(labels), outputs)
  params, buffers = _port_variables(model, variables)
  tf = parity.port_inputs(features, torch.float32)
  got_outputs, _ = model.inference_network_fn(params, buffers, tf, "eval")
  got = model.model_eval_fn(tf, parity.port_inputs(labels, torch.float32),
                            got_outputs)
  assert set(got) == set(want)
  assert "gripper/closing_precision" in got and "stop_state_accuracy" in got
  for key in want:
    assert parity.scaled_err(got[key], want[key]) <= F32_TOL, key


def test_bfloat16_forward():
  kw = dict(image_size=32, condition_size=6)
  jax_model, _ = _models(**kw)
  jax16, model16 = _models(use_bfloat16=True, **kw)
  features = _features(12, 32, np.float32, condition_size=6)
  variables = _variables(jax_model, features)
  f32, _ = jax_model.inference_network_fn(variables, JaxSpecStruct(features),
                                          jax_modes.EVAL)
  bf16_features = JaxSpecStruct({k: jnp.asarray(v, jnp.bfloat16)
                                 for k, v in features.items()})
  bf16, _ = jax16.inference_network_fn(variables, bf16_features,
                                       jax_modes.EVAL)
  params, buffers = _port_variables(model16, variables)
  got, _ = model16.inference_network_fn(
      params, buffers, model16.cast_features_for_compute(
          parity.port_inputs(features, torch.float32)), "eval")
  for key in ("xyz", "axis_angle", "gripper", "stop"):
    assert got[key].dtype == torch.bfloat16
    limit = max(BF16_FLOOR,
                BF16_FACTOR * parity.scaled_err(bf16[key], f32[key]))
    assert parity.scaled_err(got[key], f32[key]) <= limit, key


def test_a_whole_jax_train_step_carried_across():
  kw = dict(image_size=16, network="spatial_softmax", condition_size=4,
            predict_stop_state=True)
  jax_model, model = _models(**kw)
  features = _features(13, 16, np.float32, condition_size=4)
  labels = _labels(14, models.POSE_COMPONENTS, np.float32, stop_state=True)
  jax_state, _ = jax_train_step.create_train_state(
      jax_model, jax.random.PRNGKey(3), JaxSpecStruct(features))
  state = bridge.train_state_from_jax(jax_state)
  port_features = parity.port_inputs(features, torch.float32)
  port_labels = parity.port_inputs(labels, torch.float32)
  _, _, grads, _ = train_step.loss_and_grads(
      model, state.params, port_features, port_labels, state.mutable_state)
  jax_state, jax_metrics = jax_train_step.make_train_step(
      jax_model, donate=False)(jax_state, JaxSpecStruct(features),
                               JaxSpecStruct(labels))
  state, metrics = train_step.make_train_step(model)(state, port_features,
                                                    port_labels)
  assert set(metrics) == set(jax_metrics)
  for key in metrics:
    assert parity.scaled_err(metrics[key], jax_metrics[key]) <= F32_TOL, key
  want = bridge.state_dict_from_flax(jax.tree_util.tree_map(
      np.asarray, jax_state.params))
  assert set(want) == set(state.params)
  for name, value in want.items():
    # Adam's first step moves each parameter by lr g / (|g| + eps): 1e-6
    # where |g| >= 1e-6; where |g| nears eps the float32 rounding of g
    # moves that ratio, and only Adam's own bound (lr) holds.
    diff = (state.params[name] - value).abs()
    steady = grads[name].abs() >= 1e-6
    assert float(torch.where(steady, diff, 0.0).max()) <= 1e-6, name
    assert float(diff.max()) <= ADAM_LR, name


@pytest.mark.parametrize("kw", [
    dict(network="resnet_film", condition_size=6, num_users=3,
         num_past_frames=2, predict_stop_state=True),
    dict(network="spatial_softmax", condition_mode="onehot_taskid",
         num_subtasks=4)])
def test_fresh_parameters_have_flax_s_names_and_shapes(kw):
  jax_model, model = _models(image_size=16, **kw)
  features = _features(15, 16, np.float32, condition_size=kw.get(
      "condition_size", 0), subtasks=kw.get("num_subtasks", 0),
                       users=kw.get("num_users", 0),
                       past=kw.get("num_past_frames", 0))
  want = bridge.state_dict_from_flax(_variables(jax_model,
                                                features)["params"])
  got = model.init_params(torch.Generator().manual_seed(0))
  assert {k: tuple(v.shape) for k, v in got.items()} == {
      k: tuple(v.shape) for k, v in want.items()}
  if "num_users" in kw:  # flax's Embed init: N(0, 1 / features)
    assert abs(float(got["user_embed.weight"].std()) - 8 ** -0.5) < 0.3


def test_specs_match():
  for kw in (dict(condition_size=6, gripper_metrics_component="gripper",
                  predict_stop_state=True),
             dict(condition_mode="onehot_taskid", num_subtasks=2,
                  num_users=3, num_past_frames=2,
                  components=models.REFERENCE_ACTION_COMPONENTS)):
    jax_model, model = _models(**kw)
    for getter in ("get_feature_specification", "get_label_specification"):
      want = getattr(jax_model, getter)("train")
      got = getattr(model, getter)("train")
      assert {k: v.to_dict() for k, v in got.items()} == {
          k: v.to_dict() for k, v in want.items()}


def test_present_pose_needs_the_flag():
  model = models.BCZModel(image_size=16, network="spatial_softmax",
                          num_waypoints=WAYPOINTS)
  features = parity.port_inputs(_features(16, 16, np.float32), torch.float32)
  params = model.init_params(torch.Generator().manual_seed(0))
  features["present_pose"] = torch.zeros(BATCH, 7)
  with pytest.raises(ValueError, match="use_present_pose"):
    model.inference_network_fn(params, {}, features, "eval")
  posed = models.BCZModel(image_size=16, network="spatial_softmax",
                          num_waypoints=WAYPOINTS, use_present_pose=True)
  params = posed.init_params(torch.Generator().manual_seed(0))
  assert params["decoder.head0_fc0.weight"].shape == (256, 64 + 7)
  out, _ = posed.inference_network_fn(params, {}, features, "eval")
  assert out["xyz"].shape == (BATCH, WAYPOINTS, 3)


def test_pipelined_trunk_waits_for_item_14():
  """The ported pipelined trunk (the raise this test once pinned is
  gone): `network='pipelined_berkeley'` with user conditioning and the
  `pipeline_*` knobs, one train-mode loss and gradient against JAX's
  sequential schedule."""
  kw = dict(image_size=20, network="pipelined_berkeley", condition_size=5,
            num_users=3, pipeline_filters=(6, 4), pipeline_kernel_sizes=(5, 3),
            pipeline_strides=(2, 1), pipeline_microbatches=2)
  jax_model, model = _models(**kw)
  features = _features(6, 20, np.float32, condition_size=5, users=3)
  labels = _labels(7, models.POSE_COMPONENTS, np.float32)
  _, got = _train_parity(jax_model, model, features, labels, np.float32)
  assert "tower.pp_stages" in got[3]


def test_helpers_match():
  x = np.linspace(-3, 3, 13)
  with jax.enable_x64(True):
    want = jax_models.huber(jnp.asarray(x), 1.5)
    want_clip = jax_models.piecewise_scaled_huber(jnp.asarray(x), 0.2, 0.01)
  assert parity.scaled_err(models.huber(torch.tensor(x), 1.5),
                           want) <= F64_TOL
  assert parity.scaled_err(models.piecewise_scaled_huber(
      torch.tensor(x), 0.2, 0.01), want_clip) <= F64_TOL
  outputs = {"xyz": np.ones((1, 2, 3)), "xyz_absolute": np.full((1, 2, 3), 2.),
             "quaternion": np.zeros((1, 2, 4))}
  got = models.xyz_action_trajectory(outputs)
  np.testing.assert_array_equal(
      got.numpy(), np.asarray(jax_models.xyz_action_trajectory(outputs)))
  assert models.normalize_components(models.POSE_COMPONENTS)[0] == (
      "xyz", 3, False, 1.0)
  with pytest.raises(KeyError):
    models.xyz_action_trajectory({"xyz": np.ones((1, 2, 3))})


# -- the config ------------------------------------------------------------------

def test_config_trains_and_serves_at_image_32(tmp_path):
  try:
    metrics = run_t2r_trainer.main([
        "--config_files",
        str(REPO / "tensor2robot_tpu_torch" / "configs" / "train_bcz.gin"),
        "--config", f"train_eval_model.model_dir = '{tmp_path}'",
        "--config", "train_eval_model.device = 'cpu'",
        "--config", "train_eval_model.max_train_steps = 3",
        "--config", "train_eval_model.eval_steps = 1",
        "--config", "train_eval_model.eval_every_n_steps = 3",
        "--config", "train_eval_model.checkpoint_every_n_steps = 3",
        "--config", "BCZModel.image_size = 32",
        "--config", "BCZPreprocessor.input_size = (48, 48)",
        "--config", "BCZPreprocessor.crop_size = (40, 40)",
        "--config", "BCZPreprocessor.model_size = (32, 32)",
        "--config", "DefaultRandomInputGenerator.batch_size = 2"])
  finally:
    config.clear_config()
  assert np.isfinite(metrics["loss"]) and np.isfinite(metrics["eval/loss"])
  assert (tmp_path / "checkpoints" / "3").is_dir()
  model = models.BCZModel(
      image_size=32, condition_size=32, use_bfloat16=True,
      preprocessor_cls=functools.partial(
          models.BCZPreprocessor, input_size=(48, 48), crop_size=(40, 40),
          model_size=(32, 32)))
  predictor = predictors.CheckpointPredictor(model=model,
                                             model_dir=str(tmp_path),
                                             device="cpu")
  assert predictor.restore() and predictor.global_step == 3
  rng = np.random.RandomState(17)
  features = {"image": rng.randint(0, 256, (1, 48, 48, 3)).astype(np.uint8),
              "condition_embedding": rng.randn(1, 32).astype(np.float32)}
  served = predictor.predict(features)
  trajectory = models.xyz_action_trajectory(served)
  assert trajectory.shape == (1, 10, 6)
  prepared, _ = model.preprocessor.preprocess(
      SpecStruct({k: torch.from_numpy(v) for k, v in features.items()}),
      None, "predict")
  assert prepared["image"].shape == (1, 32, 32, 3)
  with torch.no_grad():
    forward, _ = model.inference_network_fn(
        predictor.state.eval_params(), predictor.state.mutable_state,
        prepared, "predict")
  np.testing.assert_array_equal(served["xyz"], forward["xyz"].float().numpy())
