"""MAML in the port against the JAX package's, on the CPU.

`meta_learning/maml.py` and `meta_learning/batch_utils.py`: the same
numpy meta batch and the same flax-initialised parameters (carried across
by `bridge.py`, the `{"base", "inner_lr"}` nesting included) go through
the JAX MAMLModel and the port's, over the mock base (with batch norm,
whose statistics the inner loop keeps frozen) and the pose regression
base (image 16): 1 and 2 inner steps, second and first order, learned
inner learning rates. Held: the conditioned and unconditioned outputs,
the inner losses and the outer loss (1e-5 of max(1, max |ref|)), and the
meta-gradient of the outer loss, the port's `torch.autograd.grad`
through `torch.func.grad` inside `torch.func.vmap` against `jax.grad`
(1e-4 x max(1, max |g|)), inner learning rates' included. Also the
predict path under the predictor's `torch.no_grad`, two steps under
`multi_steps` accumulation, and the meta specs.
"""

import jax
import numpy as np
import pytest
import torch

from tensor2robot_tpu import modes as jax_modes
from tensor2robot_tpu.meta_learning import batch_utils as jax_batch_utils
from tensor2robot_tpu.meta_learning import maml as jax_maml
from tensor2robot_tpu.parallel import train_step as jax_ts
from tensor2robot_tpu.research.pose_env import models as jax_pose
from tensor2robot_tpu.specs import SpecStruct as JaxSpecStruct
from tensor2robot_tpu.utils import mocks as jax_mocks
from tensor2robot_tpu_torch import bridge
from tensor2robot_tpu_torch.meta_learning import batch_utils, maml
from tensor2robot_tpu_torch.parallel import train_step as ts
from tensor2robot_tpu_torch.predictors import predictors
from tensor2robot_tpu_torch.bin import maml_end_task
from tensor2robot_tpu_torch.research.pose_env import meta_tasks
from tensor2robot_tpu_torch.research.pose_env import models as pose
from tensor2robot_tpu_torch.specs import SpecStruct
from tensor2robot_tpu_torch.utils import mocks

torch.set_num_threads(1)

F32_TOL = 1e-5
GRAD_TOL = 1e-4
SIZE = 16


def _err(got, want) -> float:
  got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got,
                   np.float64)
  want = np.asarray(want, np.float64)
  assert got.shape == want.shape, (got.shape, want.shape)
  return float(np.abs(got - want).max() / max(1.0, np.abs(want).max()))


def mock_batch(seed, tasks=3, cond=4, inf=2):
  """Each task: y = [x . w_task > 0], w_task random."""
  rng = np.random.RandomState(seed)
  features, ys = {}, []
  xs_c, ys_c, xs_i = [], [], []
  for _ in range(tasks):
    w = rng.randn(3).astype(np.float32)
    x = rng.uniform(-1, 1, (cond + inf, 3)).astype(np.float32)
    y = (x @ w > 0).astype(np.float32)[:, None]
    xs_c.append(x[:cond])
    ys_c.append(y[:cond])
    xs_i.append(x[cond:])
    ys.append(y[cond:])
  features["condition/features/x"] = np.stack(xs_c)
  features["condition/labels/y"] = np.stack(ys_c)
  features["inference/features/x"] = np.stack(xs_i)
  return features, {"y": np.stack(ys)}


def pose_batch(seed, tasks=2, cond=3, inf=2, size=SIZE):
  return meta_tasks.offset_reach_batch(np.random.RandomState(seed), tasks,
                                       cond, inf, size)


def _models(base: str, **kwargs):
  if base == "mock":
    jax_base = jax_mocks.MockT2RModel(device_type="cpu")
    port_base = mocks.MockT2RModel()
    counts = dict(num_condition_samples_per_task=4,
                  num_inference_samples_per_task=2)
  else:
    jax_base = jax_pose.PoseEnvRegressionModel(image_size=SIZE,
                                               device_type="cpu")
    port_base = pose.PoseEnvRegressionModel(image_size=SIZE)
    counts = dict(num_condition_samples_per_task=3,
                  num_inference_samples_per_task=2)
  kwargs = {**counts, **kwargs}
  return (jax_maml.MAMLModel(base_model=jax_base, **kwargs),
          maml.MAMLModel(base_model=port_base, **kwargs))


def _batch(base: str, seed: int):
  return mock_batch(seed) if base == "mock" else pose_batch(seed)


def _torch(tree):
  return SpecStruct({k: torch.from_numpy(v) for k, v in tree.items()})


def _port_state(variables, learn_inner_lr):
  return (bridge.state_dict_from_flax(variables["params"]),
          bridge.mutable_state_from_flax(
              variables.get("batch_stats", {}),
              prefix="base" if learn_inner_lr else ""))


def _jax_outer(model, variables, features, labels):
  features, labels = JaxSpecStruct(features), JaxSpecStruct(labels)
  rest = {k: v for k, v in variables.items() if k != "params"}

  def loss_fn(params):
    outputs, _ = model.inference_network_fn({"params": params, **rest},
                                            features, jax_modes.TRAIN,
                                            train=True)
    loss, scalars = model.model_train_fn(features, labels, outputs,
                                         jax_modes.TRAIN)
    return loss, (outputs, scalars)

  (loss, (outputs, scalars)), grads = jax.jit(jax.value_and_grad(
      loss_fn, has_aux=True))(variables["params"])
  return loss, outputs, scalars, grads


CASES = [
    ("mock", dict(num_inner_loop_steps=1, inner_learning_rate=0.5)),
    ("mock", dict(num_inner_loop_steps=2, inner_learning_rate=0.5)),
    ("mock", dict(num_inner_loop_steps=2, inner_learning_rate=0.5,
                  first_order=True)),
    ("mock", dict(num_inner_loop_steps=1, learn_inner_lr=True,
                  inner_learning_rate=0.3)),
    ("pose", dict(num_inner_loop_steps=1, inner_learning_rate=0.05)),
    ("pose", dict(num_inner_loop_steps=2, inner_learning_rate=0.2)),
    ("pose", dict(num_inner_loop_steps=1, inner_learning_rate=0.2,
                  first_order=True)),
    ("pose", dict(num_inner_loop_steps=2, inner_learning_rate=0.2,
                  learn_inner_lr=True, first_order=True)),
]
IDS = ["mock-1", "mock-2", "mock-2-first_order", "mock-1-learned_lr",
       "pose-1", "pose-2", "pose-1-first_order",
       "pose-2-first_order-learned_lr"]


@pytest.mark.parametrize("base,kwargs", CASES, ids=IDS)
def test_meta_step_matches(base, kwargs):
  jax_model, model = _models(base, **kwargs)
  features, labels = _batch(base, 0)
  variables = jax_model.init_variables(jax.random.PRNGKey(0),
                                       JaxSpecStruct(features))
  loss, outputs, scalars, grads = _jax_outer(jax_model, variables, features,
                                             labels)
  learn = kwargs.get("learn_inner_lr", False)
  params, state = _port_state(variables, learn)
  module = model.module
  assert set(params) == set(dict(module.named_parameters()))
  assert set(state) == set(dict(module.named_buffers()))

  got_outputs, new_state = model.inference_network_fn(
      params, state, _torch(features), "train", train=True)
  assert new_state == {}
  steps = kwargs["num_inner_loop_steps"]
  assert got_outputs["inner_losses"].shape == (len(labels[next(iter(
      labels))]), steps + 1)
  for key in ("conditioned_output", "unconditioned_output"):
    for leaf, want in jax_batch_utils.flatten_batch_examples(
        dict(outputs[key].items())).items():
      got = batch_utils.flatten_batch_examples(
          got_outputs[f"{key}/{leaf}"])
      assert _err(got, want) <= F32_TOL, (key, leaf)
  assert _err(got_outputs["inner_losses"], outputs["inner_losses"]) \
      <= F32_TOL

  got_loss, got_scalars, got_grads, _ = ts.loss_and_grads(
      model, params, _torch(features), _torch(labels), state)
  assert _err(got_loss, loss) <= F32_TOL
  assert set(got_scalars) == set(scalars)
  for name in scalars:
    assert _err(got_scalars[name], scalars[name]) <= F32_TOL, name
  want_grads = bridge.state_dict_from_flax(
      jax.tree_util.tree_map(np.asarray, grads))
  assert set(got_grads) == set(want_grads) == set(params)
  for name, want in want_grads.items():
    scale = max(1.0, float(want.abs().max()))
    assert float((got_grads[name] - want).abs().max()) <= GRAD_TOL * scale, \
        name
  if learn:  # the inner rates learn
    assert any(float(got_grads[k].abs()) > 0 for k in got_grads
               if k.startswith("inner_lr."))


def test_second_order_terms_reach_the_meta_gradient():
  _, second = _models("pose", num_inner_loop_steps=1,
                      inner_learning_rate=0.2)
  _, first = _models("pose", num_inner_loop_steps=1,
                     inner_learning_rate=0.2, first_order=True)
  features, labels = _batch("pose", 1)
  params = second.init_params(torch.Generator().manual_seed(0))
  grads = [ts.loss_and_grads(m, params, _torch(features), _torch(labels))[2]
           for m in (second, first)]
  assert max(float((grads[0][k] - grads[1][k]).abs().max())
             for k in params) > 1e-6


@pytest.mark.parametrize("base", ["mock", "pose"])
def test_predict_adapts_under_no_grad(base):
  _, model = _models(base, num_inner_loop_steps=2, inner_learning_rate=0.3)
  features, labels = _batch(base, 2)
  predictor = predictors.CheckpointPredictor(model=model, device="cpu")
  predictor.init_randomly(seed=3)
  state = predictor.state
  with torch.no_grad():  # the predict fn's own no_grad, nested
    got = predictor.predict(features)
  want, _ = model.inference_network_fn(state.params, state.mutable_state,
                                       _torch(features), "predict")
  for key, value in got.items():
    np.testing.assert_allclose(value, want[key].detach().numpy(),
                               rtol=1e-6, atol=1e-6)
  # Adaptation moved the output off the unconditioned one.
  key = next(k for k in got if k.startswith("conditioned_output/"))
  other = key.replace("conditioned_output", "unconditioned_output")
  assert np.abs(got[key] - got[other]).max() > 1e-6


def test_accumulated_meta_steps_match():
  """Two meta-steps with the base's gradient_accumulation_steps = 2:
  MultiSteps in JAX, `multi_steps` around the outer optimizer in the
  port; one update after the second step."""
  jax_base = jax_mocks.MockT2RModel(device_type="cpu", use_batch_norm=False,
                                    gradient_accumulation_steps=2)
  jax_model = jax_maml.MAMLModel(base_model=jax_base,
                                 num_condition_samples_per_task=4,
                                 num_inference_samples_per_task=2,
                                 inner_learning_rate=0.5)
  port_base = mocks.MockT2RModel(use_batch_norm=False,
                                 gradient_accumulation_steps=2)
  model = maml.MAMLModel(base_model=port_base,
                         num_condition_samples_per_task=4,
                         num_inference_samples_per_task=2,
                         inner_learning_rate=0.5)
  assert model.gradient_accumulation_steps == 2
  batches = [mock_batch(s) for s in (10, 11)]
  state, _ = jax_ts.create_train_state(jax_model, jax.random.PRNGKey(0),
                                       JaxSpecStruct(batches[0][0]))
  params = bridge.state_dict_from_flax(
      jax.tree_util.tree_map(np.asarray, state.params))
  port_state = ts.init_train_state(model, params)
  jax_step = jax_ts.make_train_step(jax_model)
  port_step = ts.make_train_step(model)
  for features, labels in batches:
    state, metrics = jax_step(state, JaxSpecStruct(features),
                              JaxSpecStruct(labels))
    port_state, port_metrics = port_step(port_state, _torch(features),
                                         _torch(labels))
    assert _err(port_metrics["loss"], metrics["loss"]) <= F32_TOL
  want = bridge.state_dict_from_flax(
      jax.tree_util.tree_map(np.asarray, state.params))
  moved = 0.0
  for name, value in want.items():
    assert _err(port_state.params[name], value) <= F32_TOL, name
    moved = max(moved, float((port_state.params[name] - params[name])
                             .abs().max()))
  assert moved > 1e-3  # the accumulated update was applied
  assert port_state.opt_state["mini_step"] == 0
  assert port_state.opt_state["gradient_step"] == 1


def test_meta_specs_match():
  jax_model, model = _models("pose", num_inner_loop_steps=1)
  for getter in ("get_feature_specification", "get_label_specification"):
    want = getattr(jax_model, getter)("train")
    got = getattr(model, getter)("train")
    assert {k: v.to_dict() for k, v in got.items()} == {
        k: {f: x for f, x in v.to_dict().items() if f != "sharding"}
        for k, v in want.items()}
  spec = model.get_feature_specification("train")
  assert spec["condition/features/state/image"].shape == (3, SIZE, SIZE, 1)
  assert spec["condition/labels/target_pose"].shape == (3, 2)
  assert spec["inference/features/state/image"].shape == (2, SIZE, SIZE, 1)
  assert spec["condition/labels/reward"].is_optional
  assert spec["inference/features/state/image"].without_batch().shape == (
      SIZE, SIZE, 1)


def test_learned_inner_rates_are_parameters():
  _, model = _models("mock", learn_inner_lr=True, inner_learning_rate=0.3)
  params = model.init_params(torch.Generator().manual_seed(0))
  names = set(dict(model.module.named_parameters()))
  assert set(params) == names
  rates = {k: v for k, v in params.items() if k.startswith("inner_lr.")}
  assert len(rates) == len(params) // 2
  assert all(v.shape == () and float(v) == pytest.approx(0.3)
             for v in rates.values())
  assert set(dict(model.module.named_buffers())) == {
      f"base.bn_{i}.running_{s}" for i in (0, 1) for s in ("mean", "var")}


class TestBatchUtils:

  def test_flatten_unflatten_roundtrip(self):
    tree = {"a": torch.ones(4, 3, 2), "b": np.zeros((4, 3))}
    flat = batch_utils.flatten_batch_examples(tree)
    assert flat["a"].shape == (12, 2) and flat["b"].shape == (12,)
    back = batch_utils.unflatten_batch_examples(flat, (4, 3))
    assert back["a"].shape == (4, 3, 2) and back["b"].shape == (4, 3)

  def test_rank_check(self):
    with pytest.raises(ValueError, match="rank"):
      batch_utils.flatten_batch_examples({"a": torch.ones(4)})

  def test_multi_batch_apply_and_split(self):
    out = batch_utils.multi_batch_apply(lambda x: x.sum(-1), 2,
                                        torch.ones(2, 3, 5))
    assert out.shape == (2, 3) and bool((out == 5).all())
    train, val = batch_utils.split_train_val(
        SpecStruct({"a": torch.arange(12).reshape(2, 6)}), 4)
    assert train["a"].shape == (2, 4) and val["a"].shape == (2, 2)
    assert isinstance(train, SpecStruct)


def test_offset_reach_batch_is_the_jax_end_task():
  """`meta_tasks.offset_reach_batch` at image 16 draws the meta batch of
  `tests/test_convergence.py` (`TestMAMLEndTaskLearns`), copied here."""
  rng = np.random.RandomState(0)
  f_c, l_c, f_i, l_i = [], [], [], []
  for _ in range(4):
    offset = rng.uniform(-0.5, 0.5, 2).astype(np.float32)
    images, targets = [], []
    for _ in range(12):
      image = np.zeros((16, 16, 1), np.uint8)
      y, x = rng.randint(2, 14, 2)
      image[y - 1:y + 2, x - 1:x + 2] = 255
      dot = np.array([x / 8.0 - 1.0, y / 8.0 - 1.0], np.float32)
      images.append(image)
      targets.append(dot + offset)
    images, targets = np.stack(images), np.stack(targets)
    f_c.append(images[:6])
    l_c.append(targets[:6])
    f_i.append(images[6:])
    l_i.append(targets[6:])
  features, labels = meta_tasks.offset_reach_batch(np.random.RandomState(0),
                                                   4, 6, 6, 16)
  for key, want in (("condition/features/state/image", f_c),
                    ("condition/labels/target_pose", l_c),
                    ("inference/features/state/image", f_i)):
    np.testing.assert_array_equal(features[key], np.stack(want))
  np.testing.assert_array_equal(labels["target_pose"], np.stack(l_i))


def test_end_task_sweep_reads_each_length(tmp_path, monkeypatch):
  monkeypatch.setattr(maml_end_task, "OUTPUT",
                      str(tmp_path / "maml_end_task.json"))
  monkeypatch.setattr(maml_end_task, "EVAL_SEEDS", (123,))
  rows = maml_end_task.main(["--inits", "0-1", "--steps", "1,2",
                             "--device", "cpu"])
  assert [row["init"] for row in rows] == [0, 1]
  for row in rows:
    assert sorted(row["reads"]) == [1, 2]
    for read in row["reads"].values():
      assert np.isfinite(read["ratio"]) and read["unconditioned_mae"] > 0
  assert (tmp_path / "maml_end_task.json").is_file()


def test_bridge_maps_the_maml_nesting():
  jax_model, model = _models("pose", learn_inner_lr=True,
                             inner_learning_rate=0.3)
  features, _ = _batch("pose", 3)
  variables = jax_model.init_variables(jax.random.PRNGKey(0),
                                       JaxSpecStruct(features))
  params = bridge.state_dict_from_flax(variables["params"])
  base = bridge.state_dict_from_flax(variables["params"]["base"])
  assert set(params) == {f"base.{k}" for k in base} | {
      f"inner_lr.{k}" for k in base}
  assert "inner_lr.torso.conv_0.weight" in params
  for name, value in base.items():
    assert torch.equal(params[f"base.{name}"], value)
    assert params[f"inner_lr.{name}"].shape == ()
    assert float(params[f"inner_lr.{name}"]) == pytest.approx(0.3)
  with pytest.raises(ValueError, match="inner rate"):
    bridge.state_dict_from_flax({"base": {"d": {"kernel": np.ones((2, 2))}},
                                 "inner_lr": {"d": {"weights": 0.1}}})
