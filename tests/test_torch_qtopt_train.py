"""Training the QT-Opt critic in the port against the JAX package, on the
CPU.

* One `QTOptModel` train step (Grasping44 at 256x256, filters 16,
  num_convs (1, 1, 3), batch 2, f32: exponential-decay momentum, weight
  decay 7e-5 masked to the conv and dense kernels, EMA), from a JAX state
  carried across by `bridge.train_state_from_jax` (batch_stats and the
  masked optax chain state included): loss 1e-5 relative; parameters,
  EMA and the momentum trace 1e-6 absolute (1% of the learning rate);
  batch_stats as in `test_torch_qtopt_models.py` (running variances 1e-6
  relative, running means, which cancel, 2e-5).
* The decay mask selects the conv and dense kernels and nothing else.
* The eval step (EMA parameters with the live batch_stats) against the
  JAX package's, and the eval loop against summed eval steps.
* `train_eval_model(mode='train_and_evaluate')` on GraspingCNN logs the
  same metric keys as the JAX package's; on a small Grasping44 its
  checkpoints carry the batch-norm statistics, a resume continues them
  (the same state as plain train steps on the same batches), 'evaluate'
  averages the eval metrics, and `CheckpointPredictor(model_dir=...)`
  restores them and predicts exactly the eval-mode forward.
* The task heads' losses and metrics against the JAX package's.
"""

import functools
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensor2robot_tpu import train_eval as jax_train_eval
from tensor2robot_tpu.data import input_generators as jax_input_generators
from tensor2robot_tpu.models import heads as jax_heads
from tensor2robot_tpu.parallel import train_step as jax_train_step
from tensor2robot_tpu.research.qtopt import models as jax_models
from tensor2robot_tpu_torch import bridge
from tensor2robot_tpu_torch import checkpoints
from tensor2robot_tpu_torch import train_eval
from tensor2robot_tpu_torch.data import input_generators
from tensor2robot_tpu_torch.models import heads
from tensor2robot_tpu_torch.parallel import train_step
from tensor2robot_tpu_torch.predictors import predictors
from tensor2robot_tpu_torch.research.qtopt import models

# The port's tests run in the same worker processes as the JAX suite;
# one torch thread keeps torch from starting its OpenMP and MKL thread
# pools beside XLA's CPU threads.
torch.set_num_threads(1)

LOSS_RTOL = 1e-5
PARAM_ATOL = 1e-6
STATS_VAR_RTOL = 1e-6
STATS_MEAN_RTOL = 2e-5
EVAL_RTOL = 1e-5
BLOCKS = {"world_vector": (0, 3), "vertical_rotation": (3, 2)}


def _jax_critic(size, filters, num_convs):

  class Critic(jax_models.QTOptModel):

    def create_module(self):
      return jax_models.Grasping44(num_convs=num_convs, filters=filters,
                                   grasp_param_names=BLOCKS)

  return Critic


def _critic(size, filters, num_convs):

  class Critic(models.QTOptModel):

    def create_module(self):
      return models.Grasping44(size, 3, 5, num_convs=num_convs,
                               filters=filters, grasp_param_names=BLOCKS)

  return Critic


def _models(size=256, filters=16, num_convs=(1, 1, 3), **kwargs):
  kwargs = dict(image_size=size, action_size=5, network="grasping44",
                grasp_param_names=BLOCKS, **kwargs)
  return (_jax_critic(size, filters, num_convs)(device_type="cpu", **kwargs),
          _critic(size, filters, num_convs)(**kwargs))


def _batch(model, batch=2, seed=0):
  from tensor2robot_tpu import specs as jax_specs

  features = jax_specs.make_random_numpy(
      model.get_feature_specification("train"), batch_size=batch, seed=seed)
  labels = jax_specs.make_random_numpy(
      model.get_label_specification("train"), batch_size=batch,
      seed=seed + 1)
  return dict(features), dict(labels)


def _torch(tree):
  return {k: torch.from_numpy(np.asarray(v)) for k, v in tree.items()}


def _state_dict(tree):
  return bridge.state_dict_from_flax(bridge._numpy_tree(tree))


def _rel(got, want):
  got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
  return float(np.abs(got - want).max() / np.abs(want).max())


def _assert_close(got_tree, want_tree, atol):
  assert set(got_tree) == set(want_tree)
  for name, want in want_tree.items():
    np.testing.assert_allclose(got_tree[name].numpy(), want.numpy(),
                               atol=atol, rtol=0, err_msg=name)


def _assert_stats_close(got, jax_mutable):
  want = bridge.mutable_state_from_flax(
      bridge._numpy_tree(jax_mutable["batch_stats"]))
  assert set(got) == set(want)
  for name, value in want.items():
    tol = STATS_MEAN_RTOL if name.endswith("mean") else STATS_VAR_RTOL
    assert _rel(got[name].numpy(), value.numpy()) <= tol, name


@functools.lru_cache(maxsize=None)
def _jax_run():
  """(jax model, port model, features, labels, initial JAX state, JAX
  state after one step, its metrics), built once: JAX states are never
  modified."""
  jax_model, model = _models()
  features, labels = _batch(model)
  initial = jax.jit(lambda rng, f: jax_train_step.create_train_state(
      jax_model, rng, f)[0])(jax.random.PRNGKey(0), features)
  stepped, metrics = jax_train_step.make_train_step(
      jax_model, donate=False)(initial, features, labels)
  return jax_model, model, features, labels, initial, stepped, metrics


def test_qtopt_train_step_matches_jax():
  _, model, features, labels, initial, jax_state, jax_metrics = _jax_run()
  state = bridge.train_state_from_jax(initial)
  assert state.opt_state[0] == {"inner_state": {}}  # the masked decay
  assert len(state.mutable_state) == 2 * 10  # 10 batch norms
  before = {k: v.clone() for k, v in state.mutable_state.items()}
  new_state, metrics = train_step.make_train_step(model)(
      state, _torch(features), _torch(labels))
  assert set(metrics) == set(jax_metrics) == {"loss", "td_mse",
                                              "global_gradient_norm"}
  for key in metrics:
    assert _rel(float(metrics[key]), float(jax_metrics[key])) <= LOSS_RTOL
  assert new_state.step == 1
  _assert_close(new_state.params, _state_dict(jax_state.params), PARAM_ATOL)
  _assert_close(new_state.ema_params, _state_dict(jax_state.ema_params),
                PARAM_ATOL)
  _assert_close(new_state.opt_state[1][0]["trace"],
                _state_dict(jax_state.opt_state[1][0].trace), PARAM_ATOL)
  assert new_state.opt_state[1][1] == {"count": 1}
  _assert_stats_close(new_state.mutable_state, jax_state.mutable_state)
  # The step left its input state as it was.
  assert all(torch.equal(state.mutable_state[k], v) for k, v in before.items())


def test_decay_mask_hits_conv_and_dense_kernels_only():
  jax_model, model = _models(l2_regularization=1e-2)
  flax_params = jax.tree_util.tree_map(np.asarray, _jax_run()[4].params)
  params = model.init_params(torch.Generator().manual_seed(0))
  optimizer = model.create_optimizer()
  zeros = {k: torch.zeros_like(v) for k, v in params.items()}
  updates, _ = optimizer.update(zeros, optimizer.init(params), params)
  decayed = {k for k, v in updates.items() if bool(v.abs().max() > 0)}
  assert decayed == {k for k, v in params.items() if v.ndim > 1}
  assert "conv1_1.weight" in decayed and "fc0.weight" in decayed
  assert "conv1_1.bias" not in decayed and "conv2_bn.weight" not in decayed
  assert "conv1_bn.bias" not in decayed and "logit.bias" not in decayed
  # The same updates as the JAX chain on the same parameters.
  ported = _state_dict(flax_params)
  tx = jax_model.create_optimizer()
  jax_updates, _ = tx.update(jax.tree_util.tree_map(jnp.zeros_like,
                                                    flax_params),
                             tx.init(flax_params), flax_params)
  got, _ = optimizer.update({k: torch.zeros_like(v) for k, v in ported.items()},
                            optimizer.init(ported), ported)
  _assert_close(got, _state_dict(jax_updates), 1e-12)


def test_eval_step_and_loop_match_jax():
  jax_model, model, features, labels, _, jax_state, _ = _jax_run()
  state = bridge.train_state_from_jax(jax_state)
  assert not torch.equal(state.ema_params["fc0.weight"],
                         state.params["fc0.weight"])
  want = jax_train_step.make_eval_step(jax_model)(jax_state, features, labels)
  got = train_step.make_eval_step(model)(state, _torch(features),
                                         _torch(labels))
  assert set(got) == set(want) == {"loss", "q_mean", "td_mse"}
  for key in got:
    assert _rel(float(got[key]), float(want[key])) <= EVAL_RTOL, key
  batches = [_batch(model, seed=s) for s in (0, 2, 4)]
  step = train_step.make_eval_step(model)
  summed = {}
  for f, l in batches:
    for key, value in step(state, _torch(f), _torch(l)).items():
      summed[key] = summed.get(key, 0.0) + value
  def stack(i):
    return {k: torch.stack([_torch(b[i])[k] for b in batches])
            for k in batches[0][i]}

  looped = train_step.make_eval_loop(model, 3)(state, stack(0), stack(1))
  for key in summed:
    torch.testing.assert_close(looped[key], summed[key], atol=0, rtol=0)
  with pytest.raises(ValueError, match="num_steps"):
    train_step.make_eval_loop(model, 0)


def _run_kwargs(**overrides):
  kwargs = dict(mode="train_and_evaluate", max_train_steps=4, eval_steps=2,
                eval_every_n_steps=2, checkpoint_every_n_steps=2,
                log_every_n_steps=2, seed=0)
  kwargs.update(overrides)
  return kwargs


def test_train_and_evaluate_logs_the_jax_metric_keys(tmp_path):
  small = dict(image_size=32, action_size=4, network="small")
  want = jax_train_eval.train_eval_model(
      model=jax_models.QTOptModel(device_type="cpu", **small),
      model_dir=str(tmp_path / "jax"),
      input_generator_train=jax_input_generators.DefaultRandomInputGenerator(
          batch_size=8),
      input_generator_eval=jax_input_generators.DefaultRandomInputGenerator(
          batch_size=8), step_stats_every_n_steps=0, executable_cache_dir=None,
      device_prefetch_depth=0, **_run_kwargs())
  got = train_eval.train_eval_model(
      model=models.QTOptModel(**small), model_dir=str(tmp_path / "port"),
      input_generator_train=input_generators.DefaultRandomInputGenerator(
          batch_size=8),
      input_generator_eval=input_generators.DefaultRandomInputGenerator(
          batch_size=8), device="cpu", **_run_kwargs())
  assert set(got) == set(want) == {
      "loss", "td_mse", "global_gradient_norm", "eval/loss", "eval/q_mean",
      "eval/td_mse"}
  assert all(np.isfinite(v) for v in got.values())
  with open(tmp_path / "port" / "train" / "metrics.jsonl") as f:
    # The loss and eval rows (step-stats windows are rows of their own).
    records = [r for r in map(json.loads, f)
               if "loss" in r or "eval/loss" in r]
  assert [(r["step"], "eval/loss" in r) for r in records] == [
      (2, False), (2, True), (4, False), (4, True)]


def _tiny_critic():
  # 108 px: the smallest width the (1, 1, 1) tower takes (54, 18, 6, 3, 1).
  return _critic(108, 16, (1, 1, 1))(
      image_size=108, action_size=5, network="grasping44",
      grasp_param_names=BLOCKS, ema_decay=0.5)


def _generators():
  return (input_generators.DefaultRandomInputGenerator(batch_size=4, seed=0),
          input_generators.DefaultRandomInputGenerator(batch_size=4, seed=7))


def test_train_and_evaluate_checkpoints_and_resumes_batch_stats(tmp_path):
  model = _tiny_critic()
  train_gen, eval_gen = _generators()
  train_eval.train_eval_model(
      model=model, model_dir=str(tmp_path), device="cpu",
      input_generator_train=train_gen, input_generator_eval=eval_gen,
      **_run_kwargs())
  manager = checkpoints.CheckpointManager(str(tmp_path / "checkpoints"))
  assert manager.all_steps() == [2, 4]
  at_4 = manager.restore()
  assert len(at_4.mutable_state) == 2 * 8  # 8 batch norms
  moved = [k for k, v in at_4.mutable_state.items()
           if not torch.equal(v, model.init_mutable_state()[k])]
  assert len(moved) == len(at_4.mutable_state)
  with open(manager._manifest_path(4)) as f:
    assert "state.pt" in json.load(f)["files"]
  # A resume continues the statistics: the same state as six plain steps.
  train_eval.train_eval_model(
      model=model, model_dir=str(tmp_path), device="cpu",
      input_generator_train=train_gen, input_generator_eval=eval_gen,
      **_run_kwargs(max_train_steps=6))
  resumed = manager.restore()
  state = train_step.create_train_state(model, torch.Generator().manual_seed(0),
                                        torch.device("cpu"))
  train_gen.set_specification_from_model(model, "train")
  stream = train_gen.create_dataset("train")
  step = train_step.make_train_step(model)
  for i in range(6):
    if i == 4:  # the resumed run restarted its stream from the seed
      stream = train_gen.create_dataset("train")
    batch = next(stream)
    state, _ = step(state, batch["features"], batch["labels"])
  assert resumed.step == state.step == 6
  for tree in ("params", "ema_params", "mutable_state"):
    for name, value in getattr(state, tree).items():
      torch.testing.assert_close(getattr(resumed, tree)[name], value,
                                 atol=0, rtol=0, msg=f"{tree} {name}")
  # 'evaluate' averages the eval metrics of the newest checkpoint.
  metrics = train_eval.train_eval_model(
      model=model, model_dir=str(tmp_path), device="cpu",
      input_generator_eval=eval_gen, **_run_kwargs(mode="evaluate"))
  eval_step = train_step.make_eval_step(model)
  eval_gen.set_specification_from_model(model, "eval")
  eval_stream = eval_gen.create_dataset("eval")
  want = [eval_step(resumed, b["features"], b["labels"])
          for b in (next(eval_stream), next(eval_stream))]
  for key in ("loss", "q_mean", "td_mse"):
    assert metrics[key] == pytest.approx(
        (float(want[0][key]) + float(want[1][key])) / 2, rel=1e-6)
  with open(tmp_path / "eval" / "metrics.jsonl") as f:
    assert json.loads(f.readline())["step"] == 6


def test_checkpoint_predictor_restores_batch_stats(tmp_path):
  model = _tiny_critic()
  train_gen, eval_gen = _generators()
  train_eval.train_eval_model(
      model=model, model_dir=str(tmp_path), device="cpu",
      input_generator_train=train_gen, input_generator_eval=eval_gen,
      **_run_kwargs())
  predictor = predictors.CheckpointPredictor(model=_tiny_critic(),
                                             model_dir=str(tmp_path),
                                             device="cpu")
  assert predictor.restore() and predictor.global_step == 4
  state = checkpoints.CheckpointManager(
      str(tmp_path / "checkpoints")).restore()
  for name, value in state.mutable_state.items():
    assert torch.equal(predictor.state.mutable_state[name], value)
  features, _ = _batch(model, batch=3, seed=9)
  got = predictor.predict(features)
  with torch.no_grad():
    want, _ = model.inference_network_fn(state.ema_params,
                                         state.mutable_state,
                                         _torch(features), "predict")
  for key in ("q_predicted", "logits"):
    np.testing.assert_array_equal(got[key], want[key].numpy())
  # Staged weights: batch statistics are checked like parameters.
  with pytest.raises(ValueError, match="mutable_state keys"):
    predictor.load_params(state.params, mutable_state={"x": torch.zeros(1)})
  predictor.load_params(state.params, mutable_state=state.mutable_state,
                        global_step=9)
  assert predictor.restore() and predictor.global_step == 9


def test_cli_trains_the_qtopt_config_shrunk_to_the_small_critic(tmp_path):
  from tensor2robot_tpu_torch.bin import run_t2r_trainer
  from tensor2robot_tpu_torch.utils import config

  bindings = [f"train_eval_model.model_dir = '{tmp_path}'",
              "train_eval_model.device = 'cpu'",
              "train_eval_model.max_train_steps = 2",
              "train_eval_model.eval_steps = 1",
              "train_eval_model.eval_every_n_steps = 2",
              "train_eval_model.checkpoint_every_n_steps = 2",
              "QTOptModel.network = 'small'",
              "QTOptModel.image_size = 32",
              "DefaultRandomInputGenerator.batch_size = 4"]
  argv = ["--config_files", str(pathlib.Path(models.__file__).parents[2]
                                / "configs" / "train_qtopt.gin")]
  for binding in bindings:
    argv += ["--config", binding]
  try:
    metrics = run_t2r_trainer.main(argv)
  finally:
    config.clear_config()
  assert np.isfinite(metrics["loss"]) and np.isfinite(metrics["eval/q_mean"])
  assert checkpoints.CheckpointManager(
      str(tmp_path / "checkpoints")).all_steps() == [2]


def test_a_checkpoint_without_mutable_state_restores(tmp_path):
  manager = checkpoints.CheckpointManager(str(tmp_path),
                                          async_checkpointing=False)
  state = train_step.TrainState(step=3, params={"w": torch.ones(2)})
  manager.save(3, state)
  path = tmp_path / "3" / checkpoints.STATE_FILENAME
  payload = torch.load(path, weights_only=True)
  del payload["mutable_state"]
  torch.save(payload, path)
  manager._write_manifest(3)
  restored = manager.restore()
  assert restored.step == 3 and restored.mutable_state == {}


def test_unported_knobs_raise(tmp_path):
  # PCGrad is ported (tests/test_torch_pcgrad.py holds its step against
  # JAX's); a model without task losses trains without it, as in JAX.
  assert train_step._uses_pcgrad(models.QTOptModel(use_pcgrad=True))
  assert not train_step._uses_pcgrad(models.QTOptModel())
  with pytest.raises(ValueError, match="input_generator_eval"):
    train_eval.train_eval_model(model=_tiny_critic(), model_dir=str(tmp_path),
                                mode="continuous_eval", device="cpu")
  with pytest.raises(ValueError, match="input_generator_eval"):
    train_eval.train_eval_model(
        model=_tiny_critic(), model_dir=str(tmp_path), device="cpu",
        input_generator_train=_generators()[0], **_run_kwargs())
  with pytest.raises(ValueError, match="batch_stats leaf"):
    bridge.mutable_state_from_flax({"bn": {"mean": np.zeros(2),
                                           "var": np.ones(2)}, "x": 1.0})

  class State:
    step, params, opt_state, ema_params = 0, {}, (), None
    mutable_state = {"cache": {}}

  with pytest.raises(ValueError, match="cache"):
    bridge.train_state_from_jax(State())


# -- task heads --------------------------------------------------------------


def test_task_heads_match_jax():
  rs = np.random.RandomState(4)
  logits = rs.randn(6, 1).astype(np.float32) * 3
  binary = (rs.rand(6, 1) > 0.5).astype(np.float32)
  multi_logits = rs.randn(6, 4).astype(np.float32)
  sparse = rs.randint(0, 4, 6)
  np.testing.assert_allclose(
      heads.sigmoid_cross_entropy(torch.from_numpy(logits),
                                  torch.from_numpy(binary)).numpy(),
      np.asarray(jax_heads.sigmoid_cross_entropy(logits, binary)),
      rtol=1e-6, atol=1e-7)
  onehot = np.eye(4, dtype=np.float32)[sparse]
  np.testing.assert_allclose(
      heads.softmax_cross_entropy(torch.from_numpy(multi_logits),
                                  torch.from_numpy(onehot)).numpy(),
      np.asarray(jax_heads.softmax_cross_entropy(multi_logits, onehot)),
      rtol=1e-6, atol=1e-7)

  def compare(jax_model, model, outputs, labels):
    want = jax_model.model_eval_fn({}, labels, outputs)
    got = model.model_eval_fn({}, _torch(labels), _torch(outputs))
    assert set(got) == set(want)
    for key, value in want.items():
      assert float(got[key]) == pytest.approx(float(value), rel=1e-6,
                                              abs=1e-7), key

  class JaxClassifier(jax_heads.ClassificationModel):
    get_feature_specification = get_label_specification = None
    create_module = None

  class Classifier(heads.ClassificationModel):
    get_feature_specification = get_label_specification = None
    create_module = None

  for num_classes, out, y in ((1, logits, binary), (4, multi_logits, sparse),
                              (4, multi_logits, onehot)):
    compare(JaxClassifier(num_classes=num_classes, device_type="cpu"),
            Classifier(num_classes=num_classes), {"logits": out},
            {"class": y})

  class JaxRegressor(jax_heads.RegressionModel):
    get_feature_specification = get_label_specification = None
    create_module = None

  class Regressor(heads.RegressionModel):
    get_feature_specification = get_label_specification = None
    create_module = None

  target = rs.randn(6, 3).astype(np.float32)
  compare(JaxRegressor(device_type="cpu"), Regressor(),
          {"inference_output": target + rs.randn(6, 3).astype(np.float32)},
          {"target": target})
  q = rs.rand(6, 1).astype(np.float32)
  compare(jax_models.QTOptModel(device_type="cpu"), models.QTOptModel(),
          {"q_predicted": q}, {"reward": binary})
  tiled = heads.CriticModel.tile_state_for_actions(
      {"state/image": torch.arange(6).reshape(2, 3)}, 2)
  np.testing.assert_array_equal(
      tiled["state/image"].numpy(),
      np.asarray(jax_heads.CriticModel.tile_state_for_actions(
          {"state/image": np.arange(6).reshape(2, 3)}, 2)["state/image"]))
