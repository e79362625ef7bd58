"""The VRGripper models under MAML in the port against the JAX package, on
the CPU.

`MAMLModel` over `VRGripperDomainAdaptiveModel` (2 tasks, 2 + 2 samples,
episodes of 3 frames at 16 x 16, 1 inner step at 0.01): the meta-step's
loss, the conditioned and unconditioned outputs, the inner losses and
the meta-gradient of every parameter (the learned loss's `ll_conv_*` and
`ll_ln_*` included, which reach the outer loss only through the second
order term), second and first order, and with the caller's module kwargs
(`inner=True` for every forward); the first-order meta-gradient of the
learned loss is zero in both packages. The domain-adaptive model's inner
forward ignores the pose exactly and the outer one does not;
`predict_con_gripper_pose`; `inner_loop_loss_fn` is the learned loss.
`MAMLModel` over `VRGripperTECModel` with `task_id` labels (the triplet
term in the outer loss).

Tolerances, of max(1, max |ref|): float64 (JAX under `jax.enable_x64`,
its spatial softmax's float32 cast widened) 1e-10 for values and
gradients; float32 1e-5 for values, 1e-4 x max(1, max |g|) for
gradients.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensor2robot_tpu import modes as jax_modes
from tensor2robot_tpu.layers import mdn as jax_mdn
from tensor2robot_tpu.layers import spatial_softmax as jax_spatial_softmax
from tensor2robot_tpu.meta_learning import maml as jax_maml
from tensor2robot_tpu.research.vrgripper import models as jax_models
from tensor2robot_tpu.specs import SpecStruct as JaxSpecStruct
from tensor2robot_tpu_torch.meta_learning import maml
from tensor2robot_tpu_torch.parallel import train_step as ts
from tensor2robot_tpu_torch.research.vrgripper import models
from tensor2robot_tpu_torch.specs import SpecStruct
from tests import torch_model_parity as parity

torch.set_num_threads(1)

F64_TOL = 1e-10
F32_TOL = 1e-5
GRAD_TOL = 1e-4
TASKS, COND, INF, T, IMAGE, ACTION = 2, 2, 2, 3, 16, 2
DA = dict(episode_length=T, image_size=IMAGE, action_size=ACTION)
META = dict(num_inner_loop_steps=1, inner_learning_rate=0.01,
            num_condition_samples_per_task=COND,
            num_inference_samples_per_task=INF)


def _da_batch(seed):
  rng = np.random.RandomState(seed)
  features = {}
  for split, n in (("condition", COND), ("inference", INF)):
    features[f"{split}/features/image"] = rng.rand(TASKS, n, T, IMAGE,
                                                   IMAGE, 3)
    features[f"{split}/features/gripper_pose"] = rng.randn(TASKS, n, T, 7)
  features["condition/labels/action"] = rng.randn(TASKS, COND, T, ACTION)
  return features, {"action": rng.randn(TASKS, INF, T, ACTION)}


def _tec_batch(seed):
  rng = np.random.RandomState(seed)
  features = {}
  for split, n in (("condition", COND), ("inference", INF)):
    features[f"{split}/features/demo_frames"] = rng.randn(TASKS, n, 5, 6)
    features[f"{split}/features/observation"] = rng.randn(TASKS, n, 6)
  features["condition/labels/action"] = rng.randn(TASKS, COND, 3)
  # Distinct ids inside a task's condition split (no positive pair, so the
  # inner triplet term is 0); one id per task in the outer labels.
  features["condition/labels/task_id"] = np.arange(TASKS * COND).reshape(
      TASKS, COND).astype(np.int64)
  labels = {"action": rng.randn(TASKS, INF, 3),
            "task_id": np.repeat(np.arange(TASKS), INF).reshape(
                TASKS, INF).astype(np.int64)}
  return features, labels


def _cast(tree, dtype):
  return {k: v.astype(dtype) if v.dtype.kind == "f" else v
          for k, v in tree.items()}


def _models(base, **kwargs):
  if base == "da":
    jax_base = jax_models.VRGripperDomainAdaptiveModel(device_type="cpu",
                                                       **DA)
    port_base = models.VRGripperDomainAdaptiveModel(**DA)
    batch = _da_batch
  else:
    tec = dict(demo_length=5, obs_size=6, action_size=3, embedding_size=8)
    jax_base = jax_models.VRGripperTECModel(device_type="cpu", **tec)
    port_base = models.VRGripperTECModel(**tec)
    batch = _tec_batch
  return (jax_maml.MAMLModel(base_model=jax_base, **META, **kwargs),
          maml.MAMLModel(base_model=port_base, **META, **kwargs), batch)


def _meta_step(base, dtype, monkeypatch, seed=0, **kwargs):
  jax_model, model, batch = _models(base, **kwargs)
  features, labels = batch(seed)
  params = parity.randomized(parity.init_variables(
      jax_model, _cast(features, np.float32))["params"], seed + 5)
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
  parity.compare_train(got, want, tol, grad_tol)
  return got, want


@pytest.mark.parametrize("order", ["second", "first"])
def test_domain_adaptive_meta_step_float64(order, monkeypatch):
  got, want = _meta_step("da", torch.float64, monkeypatch,
                         first_order=order == "first")
  learned = sorted(k for k in want[3] if k.startswith(("ll_conv_", "ll_ln_")))
  assert learned == ["ll_conv_0.weight", "ll_conv_1.weight",
                     "ll_conv_out.bias", "ll_conv_out.weight",
                     "ll_ln_0.bias", "ll_ln_0.weight", "ll_ln_1.bias",
                     "ll_ln_1.weight"]
  if order == "first":  # the learned loss reaches the outer loss only
    for key in learned:  # through the second-order term
      assert not want[3][key].any() and not got[3][key].any(), key
  else:
    for key in learned:
      assert float(want[3][key].abs().max()) > 0, key
  inner = got[1]["inner_losses"]
  assert inner.shape == (TASKS, 2) and torch.isfinite(inner).all()


def test_domain_adaptive_meta_step_float32(monkeypatch):
  _meta_step("da", torch.float32, monkeypatch, seed=1)


def test_caller_module_kwargs_reach_every_forward(monkeypatch):
  """`inner=True` from the caller: the inference forwards run it too (JAX
  passes the caller's kwargs to every forward)."""
  jax_model, model, batch = _models("da")
  features, _ = batch(2)
  params = parity.randomized(parity.init_variables(
      jax_model, _cast(features, np.float32))["params"], 9)
  parity.widen_float32_casts(monkeypatch, jax_spatial_softmax, jax_mdn)
  with jax.enable_x64(True):
    forward = jax.jit(lambda p, f: dict(jax_model.inference_network_fn(
        {"params": p}, JaxSpecStruct(f), jax_modes.TRAIN,
        inner=True)[0].items()))
    want = parity.flat_outputs(forward(
        parity.cast_tree(params, jnp.float64),
        {k: jnp.asarray(v) for k, v in features.items()}))
  got, _ = model.inference_network_fn(
      parity.bridged(params), {}, parity.port_inputs(features, torch.float64),
      "train", inner=True)
  assert set(got) == set(want)
  for key in want:
    assert parity.scaled_err(got[key], want[key]) <= F64_TOL, key
  # The pose is zeroed in the inference forwards too.
  moved = dict(features)
  moved["inference/features/gripper_pose"] = (
      features["inference/features/gripper_pose"] + 1.0)
  again, _ = model.inference_network_fn(
      parity.bridged(params), {}, parity.port_inputs(moved, torch.float64),
      "train", inner=True)
  assert torch.equal(again["conditioned_output/action"],
                     got["conditioned_output/action"])


def test_tec_meta_step_with_task_id(monkeypatch):
  got, want = _meta_step("tec", torch.float64, monkeypatch, seed=3)
  assert "embedding_triplet" in got[2]
  assert float(got[2]["embedding_triplet"]) > 0.0


# -- the domain-adaptive model's inner and outer forwards ------------------------


def _da_single(seed=0, **kwargs):
  model = models.VRGripperDomainAdaptiveModel(**DA, **kwargs)
  rng = np.random.RandomState(seed)
  features = SpecStruct({
      "image": torch.from_numpy(rng.rand(2, T, IMAGE, IMAGE, 3)).float(),
      "gripper_pose": torch.from_numpy(rng.randn(2, T, 7)).float()})
  params = model.init_params(torch.Generator().manual_seed(seed))
  return model, params, features


def test_inner_forward_ignores_gripper_pose():
  model, params, features = _da_single()
  moved = SpecStruct(dict(features.items()))
  moved["gripper_pose"] = features["gripper_pose"] + 1.0
  run = lambda f, **kw: model.inference_network_fn(params, {}, f, "eval",
                                                   **kw)[0]
  assert torch.equal(run(features, inner=True)["action"],
                     run(moved, inner=True)["action"])
  assert float((run(features)["action"]
                - run(moved)["action"]).abs().max()) > 1e-6


def test_predict_con_gripper_pose_matches_jax(monkeypatch):
  kwargs = dict(DA, predict_con_gripper_pose=True)
  jax_model = jax_models.VRGripperDomainAdaptiveModel(device_type="cpu",
                                                      **kwargs)
  model = models.VRGripperDomainAdaptiveModel(**kwargs)
  rng = np.random.RandomState(4)
  features = {"image": rng.rand(2, T, IMAGE, IMAGE, 3),
              "gripper_pose": rng.randn(2, T, 7)}
  params = parity.randomized(parity.init_variables(
      jax_model, _cast(features, np.float32))["params"], 4)
  parity.widen_float32_casts(monkeypatch, jax_spatial_softmax, jax_mdn)
  with jax.enable_x64(True):
    want = jax.jit(lambda p, f: dict(jax_model.inference_network_fn(
        {"params": p}, JaxSpecStruct(f), jax_modes.EVAL,
        inner=True)[0].items()))(
            parity.cast_tree(params, jnp.float64),
            {k: jnp.asarray(v) for k, v in features.items()})
  got, _ = model.inference_network_fn(
      parity.bridged(params), {}, parity.port_inputs(features, torch.float64),
      "eval", inner=True)
  for key in ("action", "predicted_pose", "learned_loss"):
    assert parity.scaled_err(got[key], np.asarray(want[key])) <= F64_TOL
  # the predicted pose, not the real one, reaches the inner action
  moved = dict(features, gripper_pose=features["gripper_pose"] + 1.0)
  again, _ = model.inference_network_fn(
      parity.bridged(params), {}, parity.port_inputs(moved, torch.float64),
      "eval", inner=True)
  assert torch.equal(again["action"], got["action"])


def test_learned_loss_is_the_inner_objective():
  model, params, features = _da_single(1)
  labels = {"action": torch.randn(2, T, ACTION,
                                  generator=torch.Generator().manual_seed(1))}
  outputs, _ = model.inference_network_fn(params, {}, features, "train",
                                          inner=True)
  inner = model.inner_loop_loss_fn(features, labels, outputs, "train")
  assert inner is outputs["learned_loss"] and inner.ndim == 0
  assert float(inner) >= 0.0
  bc, _ = model.model_train_fn(features, labels, outputs, "train")
  assert abs(float(inner) - float(bc)) > 1e-8
  assert model.inner_loop_forward_kwargs == {"inner": True}
  # every parameter is in the dict, whichever forward ran
  assert {"pose_fc.weight", "pose_out.weight", "ll_conv_0.weight",
          "ll_conv_out.bias"} <= set(params)


def test_domain_adaptive_meta_steps_train():
  """Three meta-steps through the train step: finite, the learned loss's
  parameters move."""
  model = maml.MAMLModel(base_model=models.VRGripperDomainAdaptiveModel(**DA),
                         **META)
  features, labels = _da_batch(6)
  features = {k: torch.from_numpy(v).float() for k, v in features.items()}
  labels = {k: torch.from_numpy(v).float() for k, v in labels.items()}
  state = ts.create_train_state(model, torch.Generator().manual_seed(0), "cpu")
  before = state.params["ll_conv_0.weight"].clone()
  step = ts.make_train_step(model)
  for _ in range(3):
    state, metrics = step(state, features, labels)
    assert np.isfinite(float(metrics["loss"]))
  assert float((state.params["ll_conv_0.weight"] - before).abs().max()) > 0


@pytest.mark.parametrize("base", ["da", "tec"])
def test_learned_inner_rates_bridge_by_name(base):
  """`learn_inner_lr`: the JAX `{"base", "inner_lr"}` tree crosses the
  bridge onto exactly the port's parameter names, the 1-D convs' rates
  included, and one meta-step on it is finite."""
  jax_model, model, batch = _models(base, learn_inner_lr=True)
  features, labels = batch(4)
  variables = parity.init_variables(jax_model, _cast(features, np.float32))
  assert set(variables["params"]) == {"base", "inner_lr"}
  bridged = parity.bridged(variables["params"])
  fresh = model.init_params(torch.Generator().manual_seed(0))
  assert set(bridged) == set(fresh)
  assert all(bridged[k].shape == fresh[k].shape for k in fresh)
  if base == "da":
    assert "inner_lr.ll_conv_0.weight" in bridged
  loss, _, grads, _ = ts.loss_and_grads(
      model, {k: v.float() for k, v in bridged.items()},
      parity.port_inputs(features, torch.float32),
      parity.port_inputs(labels, torch.float32))
  assert np.isfinite(float(loss))
  assert all(torch.isfinite(g).all() for g in grads.values())
