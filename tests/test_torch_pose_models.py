"""The pose models against the JAX package's, on the CPU.

`research/pose_env/models.py`: `PoseEnvRegressionModel` (with and without
the success-weighting `reward` label) and `PoseEnvContinuousMCModel`, at
image 16. The same numpy batch goes through the JAX model (flax init,
carried across by `bridge.state_dict_from_flax`) and the port's: outputs,
losses, eval metrics and the gradients of the loss. Also the models'
`pack_features` and their fresh parameters (names and shapes as flax's,
the pinned constants exactly).

Tolerances: f32 outputs, losses and metrics 1e-5 relative (of max(1,
max |ref|)); gradients 1e-4 x max(1, max |g|).
"""

import pathlib

import jax
import numpy as np
import pytest
import torch

from tensor2robot_tpu import modes as jax_modes
from tensor2robot_tpu.research.pose_env import models as jax_models
from tensor2robot_tpu.specs import SpecStruct as JaxSpecStruct
from tensor2robot_tpu_torch import bridge
from tensor2robot_tpu_torch.parallel import train_step as ts
from tensor2robot_tpu_torch.research.pose_env import models
from tensor2robot_tpu_torch.specs import SpecStruct

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


def _batch(seed: int, critic: bool, reward: bool, n: int = 6):
  rng = np.random.RandomState(seed)
  features = {"state/image": rng.randint(0, 256, (n, SIZE, SIZE, 1))
              .astype(np.uint8)}
  labels = {}
  if critic:
    features["action/action"] = rng.uniform(-1, 1, (n, 2)).astype(np.float32)
    labels["reward"] = -rng.rand(n, 1).astype(np.float32)
  else:
    labels["target_pose"] = rng.uniform(-1, 1, (n, 2)).astype(np.float32)
    if reward:  # both sides of the -0.25 success threshold
      labels["reward"] = np.linspace(-0.6, 0.1, n, dtype=np.float32)[:, None]
  return features, labels


def _torch(tree):
  return SpecStruct({k: torch.from_numpy(v) for k, v in tree.items()})


def _models(critic: bool):
  if critic:
    return (jax_models.PoseEnvContinuousMCModel(image_size=SIZE,
                                                device_type="cpu"),
            models.PoseEnvContinuousMCModel(image_size=SIZE))
  return (jax_models.PoseEnvRegressionModel(image_size=SIZE,
                                            device_type="cpu"),
          models.PoseEnvRegressionModel(image_size=SIZE))


def _jax_loss_and_grads(model, params, features, labels):
  features, labels = JaxSpecStruct(features), JaxSpecStruct(labels)

  def loss_fn(p):
    outputs, _ = model.inference_network_fn({"params": p}, features,
                                            jax_modes.TRAIN, train=True)
    loss, scalars = model.model_train_fn(features, labels, outputs,
                                         jax_modes.TRAIN)
    return loss, (outputs, scalars)

  (loss, (outputs, scalars)), grads = jax.value_and_grad(
      loss_fn, has_aux=True)(params)
  return loss, outputs, scalars, grads


CASES = [(False, False), (False, True), (True, False)]
IDS = ["regression", "regression_weighted", "critic"]


@pytest.mark.parametrize("critic,reward", CASES, ids=IDS)
def test_train_step_matches(critic, reward):
  jax_model, model = _models(critic)
  features, labels = _batch(0, critic, reward)
  variables = jax_model.init_variables(jax.random.PRNGKey(0),
                                       JaxSpecStruct(features))
  loss, outputs, scalars, grads = _jax_loss_and_grads(
      jax_model, variables["params"], features, labels)
  params = bridge.state_dict_from_flax(variables["params"])
  got_outputs, _ = model.inference_network_fn(params, {}, _torch(features),
                                              "train", train=True)
  key = "q_predicted" if critic else "inference_output"
  assert _err(got_outputs[key], outputs[key]) <= F32_TOL
  got_loss, got_scalars, got_grads, _ = ts.loss_and_grads(
      model, params, _torch(features), _torch(labels))
  assert _err(got_loss, loss) <= F32_TOL
  assert set(got_scalars) == set(scalars)
  for name in scalars:
    assert _err(got_scalars[name], scalars[name]) <= F32_TOL, name
  want_grads = bridge.state_dict_from_flax(jax.tree_util.tree_map(
      np.asarray, grads))
  assert set(got_grads) == set(want_grads)
  for name, want in want_grads.items():
    scale = max(1.0, float(want.abs().max()))
    assert float((got_grads[name] - want).abs().max()) <= GRAD_TOL * scale, \
        name


@pytest.mark.parametrize("critic,reward", CASES, ids=IDS)
def test_eval_metrics_match(critic, reward):
  jax_model, model = _models(critic)
  features, labels = _batch(1, critic, reward)
  variables = jax_model.init_variables(jax.random.PRNGKey(1),
                                       JaxSpecStruct(features))
  outputs, _ = jax_model.inference_network_fn(
      variables, JaxSpecStruct(features), jax_modes.EVAL)
  want = jax_model.model_eval_fn(JaxSpecStruct(features),
                                 JaxSpecStruct(labels), outputs)
  params = bridge.state_dict_from_flax(variables["params"])
  got_outputs, _ = model.inference_network_fn(params, {}, _torch(features),
                                              "eval")
  got = model.model_eval_fn(_torch(features), _torch(labels), got_outputs)
  assert set(got) == set(want)
  for name in want:
    assert _err(got[name], want[name]) <= F32_TOL, name


@pytest.mark.parametrize("critic", [False, True])
def test_fresh_parameters(critic):
  jax_model, model = _models(critic)
  features, _ = _batch(2, critic, False)
  variables = jax_model.init_variables(jax.random.PRNGKey(2),
                                       JaxSpecStruct(features))
  want = bridge.state_dict_from_flax(variables["params"])
  got = model.init_params(torch.Generator().manual_seed(0))
  assert {k: tuple(v.shape) for k, v in got.items()} == {
      k: tuple(v.shape) for k, v in want.items()}
  for name, value in want.items():
    # The pinned constants (LayerNorm scale and bias, the 0.01 output
    # bias, zero Dense biases) are identical; kernels are random draws.
    if not name.endswith("weight") or "norm" in name:
      assert torch.equal(got[name], value), name
  if not critic:
    assert torch.equal(got["head.pose.bias"], torch.full((2,), 0.01))
    assert not any(k.startswith("torso.conv_") and k.endswith("bias")
                   for k in got)


def test_regression_pack_features():
  jax_model, model = _models(False)
  image = np.random.RandomState(3).randint(0, 256, (SIZE, SIZE, 1)).astype(
      np.uint8)
  for state in (image, {"image": image, "timestep": np.asarray(0)}):
    want = jax_model.pack_features(state)
    got = model.pack_features(state)
    assert list(got) == list(want) == ["state/image"]
    np.testing.assert_array_equal(got["state/image"], want["state/image"])
    assert got["state/image"].shape == (1, SIZE, SIZE, 1)


def test_critic_pack_features():
  jax_model, model = _models(True)
  image = np.random.RandomState(4).randint(0, 256, (SIZE, SIZE, 1)).astype(
      np.uint8)
  actions = np.random.RandomState(5).uniform(-1, 1, (5, 2))
  want = jax_model.pack_features({"image": image}, actions=actions)
  got = model.pack_features({"image": image}, actions=actions)
  assert sorted(got) == sorted(want)
  for key in want:
    np.testing.assert_array_equal(got[key], want[key])
    assert got[key].dtype == want[key].dtype
  with pytest.raises(ValueError, match="actions"):
    model.pack_features(image)


def test_specs_match():
  for critic in (False, True):
    jax_model, model = _models(critic)
    for getter in ("get_feature_specification", "get_label_specification"):
      want = getattr(jax_model, getter)("train")
      got = getattr(model, getter)("train")
      assert {k: v.to_dict() for k, v in got.items()} == {
          k: v.to_dict() for k, v in want.items()}


# -- the configs -------------------------------------------------------------

REPO = pathlib.Path(__file__).resolve().parent.parent
CONFIG_PAIRS = {
    "train_pose_regression.gin": "research/pose_env/configs",
    "train_pose_mc_critic.gin": "research/pose_env/configs",
    "train_pose_maml.gin": "research/pose_env/configs",
    "collect_random.gin": "research/pose_env/configs",
    "mock_train.gin": "configs",
}


def _bindings(path: pathlib.Path):
  """A config's binding lines: no comments, imports or device_type."""
  lines = []
  for line in path.read_text().splitlines():
    line = line.split("#")[0].strip()
    if line and not line.startswith("import ") and ".device_type" not in line:
      lines.append(line)
  return lines


@pytest.mark.parametrize("name", sorted(CONFIG_PAIRS))
def test_config_keeps_the_jax_recipe(name):
  port = REPO / "tensor2robot_tpu_torch" / "configs" / name
  jax_config = REPO / "tensor2robot_tpu" / CONFIG_PAIRS[name] / name
  assert _bindings(port) == _bindings(jax_config)
  imports = [l for l in port.read_text().splitlines()
             if l.startswith("import ")]
  assert imports and all(
      l.startswith("import tensor2robot_tpu_torch.") for l in imports)


@pytest.mark.parametrize("name", ["train_pose_regression.gin",
                                  "train_pose_mc_critic.gin",
                                  "train_pose_maml.gin", "mock_train.gin"])
def test_config_trains_on_the_cpu(tmp_path, name):
  from tensor2robot_tpu_torch.bin import run_t2r_trainer
  from tensor2robot_tpu_torch.utils import config

  try:
    metrics = run_t2r_trainer.main([
        "--config_files",
        str(REPO / "tensor2robot_tpu_torch" / "configs" / name),
        "--config", f"train_eval_model.model_dir = '{tmp_path}'",
        "--config", "train_eval_model.device = 'cpu'"])
  finally:
    config.clear_config()
  assert np.isfinite(metrics["loss"])
  steps = 100 if name == "mock_train.gin" else 2
  assert (tmp_path / "checkpoints" / str(steps)).is_dir()
  if name == "train_pose_regression.gin":
    assert np.isfinite(metrics["eval/loss"])
  if name == "mock_train.gin":
    assert metrics["eval/accuracy"] > 0.8
