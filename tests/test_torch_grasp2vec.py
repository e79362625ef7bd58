"""Grasp2Vec in the port against the JAX package, on the CPU.

`research/grasp2vec/{losses,models,visualization}.py`:

* every loss and helper, with its gradients, in float64;
* `Grasp2VecModel` with the conv tower under all five objectives (and
  with the TY loss), and with the resnet tower (its batch statistics
  updated twice per step, pregrasp then postgrasp): outputs, loss,
  scalars, every gradient and the new batch statistics, flax's
  parameters carried across by `bridge.py`;
* the eval metrics (retrieval accuracy, keypoint accuracy and CE), the
  bf16 forward, the fresh parameters' names and shapes;
* the heatmap PNGs byte for byte against the JAX package's writer;
* `train_eval_model` runs the conv tower a few steps on the CPU.

Tolerances, of max(1, max |ref|): float64 (JAX under `jax.enable_x64`,
float images in [0, 1]) 1e-10 for values and gradients; float32 1e-5 for
values and 1e-4 x max(1, max |g|) for gradients; bf16 forward max(1e-2,
4x JAX's bf16 distance from its f32 forward).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensor2robot_tpu import modes as jax_modes
from tensor2robot_tpu.research.grasp2vec import losses as jax_losses
from tensor2robot_tpu.research.grasp2vec import models as jax_models
from tensor2robot_tpu.research.grasp2vec import visualization as jax_vis
from tensor2robot_tpu.specs import SpecStruct as JaxSpecStruct
from tensor2robot_tpu_torch import bridge
from tensor2robot_tpu_torch import train_eval
from tensor2robot_tpu_torch.data import input_generators
from tensor2robot_tpu_torch.research.grasp2vec import losses
from tensor2robot_tpu_torch.research.grasp2vec import models
from tensor2robot_tpu_torch.research.grasp2vec import visualization
from tests import torch_model_parity as parity

torch.set_num_threads(1)

F64_TOL = 1e-10
F32_TOL = 1e-5
GRAD_TOL = 1e-4
BF16_FLOOR = 1e-2
BF16_FACTOR = 4.0
IMAGE = 24
BATCH = 4


# -- losses ------------------------------------------------------------------

def _embeddings(seed, n=5, d=4):
  rng = np.random.RandomState(seed)
  return rng.randn(n, d), rng.randn(n, d), rng.randn(n, d)


def _both_f64(jax_fn, port_fn, arrays):
  """(port value, JAX value, port grads, JAX grads) of a scalar function
  in float64, grads with respect to every array."""
  with jax.enable_x64(True):
    want, want_grads = jax.value_and_grad(
        jax_fn, argnums=tuple(range(len(arrays))))(
            *[jnp.asarray(a) for a in arrays])
  tensors = [torch.tensor(a, requires_grad=True) for a in arrays]
  got = port_fn(*tensors)
  grads = torch.autograd.grad(got, tensors, allow_unused=True)
  grads = [torch.zeros_like(t) if g is None else g
           for g, t in zip(grads, tensors)]
  return got, want, grads, want_grads


def _check_f64(jax_fn, port_fn, arrays):
  got, want, grads, want_grads = _both_f64(jax_fn, port_fn, arrays)
  assert parity.scaled_err(got, want) <= F64_TOL
  for g, w in zip(grads, want_grads):
    assert parity.scaled_err(g, w) <= F64_TOL
  return got


MASK = np.array([1.0, 0.0, 1.0, 1.0, 0.0])


@pytest.mark.parametrize("name", ["l2_arithmetic_loss",
                                  "cosine_arithmetic_loss"])
@pytest.mark.parametrize("masked", [False, True])
def test_arithmetic_losses(name, masked):
  mask = MASK if masked else None
  _check_f64(
      lambda a, b, c: getattr(jax_losses, name)(
          a, b, c, None if mask is None else jnp.asarray(mask)),
      lambda a, b, c: getattr(losses, name)(
          a, b, c, None if mask is None else torch.tensor(mask)),
      _embeddings(0))


def test_empty_mask_gives_zero():
  pre, goal, post = (torch.tensor(a) for a in _embeddings(1))
  assert float(losses.l2_arithmetic_loss(pre, goal, post,
                                         torch.zeros(5))) == 0.0


def test_triplet_loss():
  pre, goal, post = _embeddings(2, n=6)
  got = _check_f64(lambda a, b, c: jax_losses.triplet_loss(a, b, c)[0],
                   lambda a, b, c: losses.triplet_loss(a, b, c)[0],
                   (pre, goal, post))
  assert float(got.detach()) > 0
  _, pairs, labels = losses.triplet_loss(*(torch.tensor(a) for a in
                                           (pre, goal, post)))
  assert pairs.shape == (12, 4)
  assert labels.tolist() == list(range(6)) * 2


@pytest.mark.parametrize("non_negative", [False, True])
def test_npairs_bidirectional(non_negative):
  _check_f64(
      lambda a, b, c: jax_losses.npairs_loss_bidirectional(
          a, b, c, non_negativity_constraint=non_negative),
      lambda a, b, c: losses.npairs_loss_bidirectional(
          a, b, c, non_negativity_constraint=non_negative),
      _embeddings(3))


def test_npairs_multilabel():
  success = np.array([[1.0], [0.0], [1.0], [0.0], [1.0]])
  _check_f64(
      lambda a, b, c: jax_losses.npairs_loss_multilabel(
          a, b, c, jnp.asarray(success)),
      lambda a, b, c: losses.npairs_loss_multilabel(
          a, b, c, torch.tensor(success)),
      _embeddings(4))


def test_keypoint_accuracy():
  keypoints = np.random.RandomState(5).uniform(-1, 1, (8, 2))
  labels = np.array([0, 1, 2, 3, 3, 2, 1, 0])
  with jax.enable_x64(True):
    want_acc, want_ce = jax_losses.keypoint_accuracy(jnp.asarray(keypoints),
                                                     jnp.asarray(labels))
  acc, ce = losses.keypoint_accuracy(torch.tensor(keypoints),
                                     torch.tensor(labels))
  assert float(acc) == float(want_acc)
  assert 0 < float(acc) < 1
  assert parity.scaled_err(ce, want_ce) <= F64_TOL


@pytest.mark.parametrize("masked", [False, True])
def test_send_to_zero(masked):
  mask = MASK if masked else None
  _check_f64(
      lambda a: jax_losses.send_to_zero_loss(
          a, None if mask is None else jnp.asarray(mask)),
      lambda a: losses.send_to_zero_loss(
          a, None if mask is None else torch.tensor(mask)),
      (_embeddings(6)[0],))


def test_match_norms_detaches_the_anchor():
  anchor, paired, _ = _embeddings(7)
  _, _, grads, _ = _both_f64(jax_losses.match_norms_loss,
                             losses.match_norms_loss, (anchor, paired))
  assert not grads[0].any() and grads[1].any()
  _check_f64(jax_losses.match_norms_loss, losses.match_norms_loss,
             (anchor, paired))


def _spatial(seed, b=3, h=4, w=5, d=6):
  rng = np.random.RandomState(seed)
  return rng.randn(b, h, w, d), rng.randn(b, h, w, d), rng.randn(b, d)


def test_softmax_response():
  pre, _, goal = _spatial(8)
  for index in (0, 1):
    _check_f64(
        lambda g, s: jax_losses.get_softmax_response(g, s)[index].sum(),
        lambda g, s: losses.get_softmax_response(g, s)[index].sum(),
        (goal, pre))


def test_ty_loss():
  _check_f64(jax_losses.ty_loss, losses.ty_loss, _spatial(9))


def test_heatmap_keypoints():
  heatmap = np.random.RandomState(10).randn(3, 4, 7) * 3
  _check_f64(lambda h: (jax_losses.heatmap_keypoints(h) ** 2).sum(),
             lambda h: (losses.heatmap_keypoints(h) ** 2).sum(), (heatmap,))
  # x runs along the width: a peak at column 6 of 7, row 1 of 4.
  peak = torch.full((1, 4, 7), -1e4, dtype=torch.float64)
  peak[0, 1, 6] = 0.0
  np.testing.assert_allclose(losses.heatmap_keypoints(peak).numpy(),
                             [[1.0, -1.0 / 3.0]], atol=1e-12)


# -- the model ---------------------------------------------------------------

def _images(seed, dtype):
  """Three image batches: uint8 (float32 runs) or floats in [0, 1]."""
  rng = np.random.RandomState(seed)
  raw = rng.randint(0, 256, (3, BATCH, IMAGE, IMAGE, 3)).astype(np.uint8)
  if dtype == np.float64:
    raw = raw.astype(np.float64) / 255.0
  return dict(zip(("pregrasp_image", "postgrasp_image", "goal_image"), raw))


def _labels(seed, loss_type):
  rng = np.random.RandomState(seed)
  labels = {}
  if loss_type in ("npairs_multilabel", "l2_arithmetic",
                   "cosine_arithmetic"):
    labels["grasp_success"] = np.array([[1.0], [0.0], [1.0], [1.0]],
                                       np.float32)
  labels["keypoint_quadrant"] = rng.randint(0, 4, (BATCH,)).astype(np.int64)
  return labels


def _models(**kwargs):
  kw = dict(image_size=IMAGE, embedding_size=8, filters=(4, 6), **kwargs)
  return (jax_models.Grasp2VecModel(device_type="cpu", **kw),
          models.Grasp2VecModel(**kw))


def _variables(jax_model, features, seed=0):
  return parity.init_variables(jax_model, {
      k: v.astype(np.float32) / (255.0 if v.dtype == np.uint8 else 1.0)
      for k, v in features.items()}, seed)


def _port_variables(model, variables):
  params = bridge.state_dict_from_flax(variables["params"])
  buffers = bridge.mutable_state_from_flax(variables.get("batch_stats", {}))
  assert set(params) == set(dict(model.module.named_parameters()))
  assert set(buffers) == set(dict(model.module.named_buffers()))
  return params, buffers


LOSS_TYPES = models.Grasp2VecModel.LOSS_TYPES


@pytest.mark.parametrize("loss_type", LOSS_TYPES)
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_conv_tower_train_step(loss_type, dtype):
  jax_model, model = _models(loss_type=loss_type)
  features, labels = _images(11, dtype), _labels(12, loss_type)
  variables = _variables(jax_model, features)
  jdtype = jnp.float64 if dtype == np.float64 else jnp.float32
  tdtype = torch.float64 if dtype == np.float64 else torch.float32
  want = parity.jax_train(jax_model, variables, features, labels, jdtype)
  params, buffers = _port_variables(model, variables)
  got = parity.port_train(model, params, buffers, features, labels, tdtype)
  tol, grad_tol = ((F64_TOL, F64_TOL) if dtype == np.float64
                   else (F32_TOL, GRAD_TOL))
  errs = parity.compare_train(got, want, tol, grad_tol)
  assert "out/heatmap" in errs and "out/keypoints" in errs
  assert float(got[0]) > 0


def test_ty_loss_term():
  jax_model, model = _models(ty_loss_weight=0.5)
  features, labels = _images(13, np.float64), _labels(14, "npairs")
  variables = _variables(jax_model, features)
  want = parity.jax_train(jax_model, variables, features, labels,
                          jnp.float64)
  got = parity.port_train(model, *_port_variables(model, variables),
                          features, labels, torch.float64)
  assert set(got[2]) == {"embed_loss", "ty_loss"}
  parity.compare_train(got, want, F64_TOL, F64_TOL)


def test_resnet_tower_train_step_and_twice_updated_stats():
  jax_model, model = _models(tower="resnet", loss_type="triplet")
  features, labels = _images(15, np.float64), _labels(16, "triplet")
  variables = _variables(jax_model, features)
  params, buffers = _port_variables(model, variables)
  assert any(k.startswith("scene.resnet.layer4") for k in buffers)
  want = parity.jax_train(jax_model, variables, features, labels,
                          jnp.float64)
  got = parity.port_train(model, params, buffers, features, labels,
                          torch.float64)
  errs = parity.compare_train(got, want, F64_TOL, F64_TOL)
  assert any(k.startswith("state/scene.resnet") for k in errs)
  assert any(k.startswith("state/goal.resnet") for k in errs)


@pytest.mark.parametrize("tower", ["conv", "resnet"])
def test_eval_metrics(tower):
  jax_model, model = _models(tower=tower)
  features, labels = _images(17, np.float32), _labels(18, "npairs")
  variables = _variables(jax_model, features)
  outputs, _ = jax_model.inference_network_fn(
      variables, JaxSpecStruct(features), jax_modes.EVAL)
  want = jax_model.model_eval_fn(JaxSpecStruct(features),
                                 JaxSpecStruct(labels), outputs)
  params, buffers = _port_variables(model, variables)
  got_outputs, _ = model.inference_network_fn(
      params, buffers, parity.port_inputs(features, torch.float32), "eval")
  got = model.model_eval_fn(parity.port_inputs(features, torch.float32),
                            parity.port_inputs(labels, torch.float32),
                            got_outputs)
  assert set(got) == set(want) == {"loss", "retrieval_accuracy",
                                   "embed_loss", "keypoint_accuracy",
                                   "keypoint_ce"}
  assert float(got["retrieval_accuracy"]) == float(
      want["retrieval_accuracy"])
  assert float(got["keypoint_accuracy"]) == float(want["keypoint_accuracy"])
  for key in ("loss", "embed_loss", "keypoint_ce"):
    assert parity.scaled_err(got[key], want[key]) <= F32_TOL, key


def test_retrieval_takes_the_first_of_tied_maxima():
  _, model = _models()
  outputs = {"pregrasp_embedding": torch.ones(3, 2),
             "postgrasp_embedding": torch.zeros(3, 2),
             "goal_embedding": torch.ones(3, 2),
             "arithmetic_embedding": torch.ones(3, 2)}
  metrics = model.model_eval_fn({}, {}, outputs)
  assert float(metrics["retrieval_accuracy"]) == pytest.approx(1.0 / 3.0)


def test_bfloat16_forward():
  jax_model, _ = _models()
  jax16, model16 = _models(use_bfloat16=True)
  features = _images(19, np.float32)
  variables = _variables(jax_model, features)
  f32, _ = jax_model.inference_network_fn(variables, JaxSpecStruct(features),
                                          jax_modes.EVAL)
  bf16, _ = jax16.inference_network_fn(variables, JaxSpecStruct(features),
                                       jax_modes.EVAL)
  params, buffers = _port_variables(model16, variables)
  got, _ = model16.inference_network_fn(
      params, buffers, parity.port_inputs(features, torch.float32), "eval")
  for key in ("pregrasp_embedding", "goal_embedding", "heatmap"):
    assert got[key].dtype == torch.bfloat16
    limit = max(BF16_FLOOR, BF16_FACTOR * parity.scaled_err(bf16[key],
                                                            f32[key]))
    assert parity.scaled_err(got[key], f32[key]) <= limit, key


@pytest.mark.parametrize("tower", ["conv", "resnet"])
def test_fresh_parameters_have_flax_s_names_and_shapes(tower):
  jax_model, model = _models(tower=tower)
  variables = _variables(jax_model, _images(20, np.float32))
  want = bridge.state_dict_from_flax(variables["params"])
  got = model.init_params(torch.Generator().manual_seed(0))
  assert {k: tuple(v.shape) for k, v in got.items()} == {
      k: tuple(v.shape) for k, v in want.items()}


def test_pipelined_tower_waits_for_item_14():
  """The ported pipelined towers (the raise this test once pinned is
  gone): `tower='pipelined_conv'`'s fresh parameters have flax's names
  and shapes, and its eval outputs match JAX's sequential schedule; an
  unknown tower still raises."""
  jax_model, model = _models(tower="pipelined_conv")
  features = _images(22, np.float32)
  variables = _variables(jax_model, features)
  params, buffers = _port_variables(model, variables)
  assert {k for k in params if k.endswith("pp_stages")} == {
      "scene.tower.pp_stages", "goal.tower.pp_stages"}
  fresh = model.init_params(torch.Generator().manual_seed(0))
  assert {k: tuple(v.shape) for k, v in fresh.items()} == {
      k: tuple(v.shape) for k, v in params.items()}
  want, _ = jax_model.inference_network_fn(
      variables, JaxSpecStruct(features), jax_modes.EVAL)
  got, _ = model.inference_network_fn(
      params, buffers, parity.port_inputs(features, torch.float32), "eval")
  for key in ("pregrasp_embedding", "goal_embedding", "heatmap"):
    assert parity.scaled_err(got[key], want[key]) <= F32_TOL, key
  with pytest.raises(ValueError, match="tower"):
    models.Grasp2VecModel(tower="mlp")


def test_specs_match():
  jax_model, model = _models()
  for getter in ("get_feature_specification", "get_label_specification"):
    want = getattr(jax_model, getter)("train")
    got = getattr(model, getter)("train")
    assert {k: v.to_dict() for k, v in got.items()} == {
        k: v.to_dict() for k, v in want.items()}


# -- visualization -----------------------------------------------------------

def test_heatmap_pngs_are_byte_identical(tmp_path):
  rng = np.random.RandomState(21)
  images = rng.rand(3, 24, 24, 3).astype(np.float32)
  heatmaps = rng.randn(3, 3, 3).astype(np.float32)
  want = jax_vis.save_heatmap_summaries(str(tmp_path / "jax"), 7, images,
                                        heatmaps, max_images=2)
  got = visualization.save_heatmap_summaries(str(tmp_path / "port"), 7,
                                             images, heatmaps, max_images=2)
  assert [os.path.basename(p) for p in got] == [
      os.path.basename(p) for p in want] == ["heatmap_7_0.png",
                                             "heatmap_7_1.png"]
  for g, w in zip(got, want):
    with open(g, "rb") as fg, open(w, "rb") as fw:
      assert fg.read() == fw.read()
  overlay = visualization.render_heatmap_overlay(images[0][..., :1],
                                                 heatmaps[0])
  assert overlay.shape == (24, 24, 3) and overlay.dtype == np.uint8


# -- training ----------------------------------------------------------------

def test_train_eval_model_runs_the_conv_tower(tmp_path):
  model = models.Grasp2VecModel(image_size=IMAGE, embedding_size=8,
                                filters=(4, 6))
  metrics = train_eval.train_eval_model(
      model=model, model_dir=str(tmp_path), mode="train_and_evaluate",
      max_train_steps=4, eval_steps=1, eval_every_n_steps=4,
      checkpoint_every_n_steps=4,
      input_generator_train=input_generators.DefaultRandomInputGenerator(
          batch_size=4),
      input_generator_eval=input_generators.DefaultRandomInputGenerator(
          batch_size=4, seed=1),
      device="cpu")
  assert np.isfinite(metrics["eval/loss"])
  assert 0.0 <= metrics["eval/retrieval_accuracy"] <= 1.0
