"""Export bundles and the predictors that serve them, on the CPU.

* The bundle's layout (assets JSON and pbtxt, signature naming the port's
  class, operative config, `params/variables.pt` with the EMA parameters
  and the batch-norm statistics); a version appears complete or not at
  all (only a hidden directory exists while it is written); an
  `ExportHook` keeps `num_versions` and the lagged directory holds the
  version before the newest.
* `ExportedModelPredictor` over a bundle equals `CheckpointPredictor`
  over the checkpoint it was exported from, exactly.
* A JAX `DefaultExportGenerator` bundle, and a port bundle of the same
  weights carried across by `bridge.export_variables_from_jax`, give the
  same outputs through each package's `ExportedModelPredictor` (f32,
  within 1e-5 relative).
* A bundle that names a JAX class is refused, and a fresh process that
  tried to load one never imported `tensor2robot_tpu`.
* With `write_saved_model=True` the bundle holds `saved_model/`, whose
  program `SavedModelPredictor` serves, equal to the predict function.
* `restore()` returns False after its timeout on an empty directory, and
  `close()` interrupts a `restore_async` that is waiting.
* `EnsemblePredictor`'s mean equals the JAX package's over the same
  bundles and seed (f32, within 1e-5 relative).
"""

import json
import os
import subprocess
import sys
import threading
import time

import jax
import numpy as np
import orbax.checkpoint as ocp
import pytest
import torch

from tensor2robot_tpu import specs as jax_specs
from tensor2robot_tpu.export import export_generator as jax_export
from tensor2robot_tpu.parallel import train_step as jax_train_step
from tensor2robot_tpu.predictors import predictors as jax_predictors
from tensor2robot_tpu.research.qtopt import models as jax_models
from tensor2robot_tpu_torch import bridge
from tensor2robot_tpu_torch import checkpoints
from tensor2robot_tpu_torch import specs
from tensor2robot_tpu_torch import train_eval
from tensor2robot_tpu_torch.bin import export_saved_model
from tensor2robot_tpu_torch.data import input_generators
from tensor2robot_tpu_torch.export import export_generator
from tensor2robot_tpu_torch.hooks import core as hooks
from tensor2robot_tpu_torch.parallel import train_step
from tensor2robot_tpu_torch.predictors import predictors
from tensor2robot_tpu_torch.predictors import saved_model_predictor
from tensor2robot_tpu_torch.research.qtopt import models

# The port's tests run in the same worker processes as the JAX suite;
# one torch thread keeps torch from starting its OpenMP and MKL thread
# pools beside XLA's CPU threads.
torch.set_num_threads(1)

OUTPUT_RTOL = 1e-5
REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BLOCKS = {"world_vector": (0, 3), "vertical_rotation": (3, 2)}
SIZE, FILTERS, NUM_CONVS = 108, 16, (1, 1, 1)
KWARGS = dict(image_size=SIZE, action_size=5, network="grasping44",
              grasp_param_names=BLOCKS)


class _JaxCritic(jax_models.QTOptModel):
  """A narrow Grasping44 (batch norm included) at 108 px."""

  def create_module(self):
    return jax_models.Grasping44(num_convs=NUM_CONVS, filters=FILTERS,
                                 grasp_param_names=BLOCKS)


class _Critic(models.QTOptModel):

  def create_module(self):
    return models.Grasping44(SIZE, 3, 5, num_convs=NUM_CONVS,
                             filters=FILTERS, grasp_param_names=BLOCKS)


def _request(model, rows=3, seed=0):
  return dict(specs.make_random_numpy(
      model.preprocessor.get_in_feature_specification("predict"),
      batch_size=rows, seed=seed))


def _rel(got, want):
  got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
  return float(np.abs(got - want).max() / np.abs(want).max())


def _trained(model_dir, steps=4):
  train_eval.train_eval_model(
      model=_Critic(**KWARGS), model_dir=str(model_dir), mode="train",
      max_train_steps=steps, checkpoint_every_n_steps=2,
      log_every_n_steps=2, device="cpu",
      input_generator_train=input_generators.DefaultRandomInputGenerator(
          batch_size=2, seed=0))


def test_bundle_layout_and_checkpoint_equality(tmp_path):
  _trained(tmp_path)
  path = export_saved_model.export_checkpoint(
      model=_Critic(**KWARGS), model_dir=str(tmp_path), device="cpu")
  assert os.path.dirname(path) == str(tmp_path / "export")
  assert sorted(os.listdir(path)) == [
      "assets.extra", "operative_config.gin", "params", "signature.json",
      "t2r_assets.json"]
  assert os.path.isfile(os.path.join(path, "assets.extra",
                                     "t2r_assets.pbtxt"))
  with open(os.path.join(path, "signature.json")) as f:
    signature = json.load(f)
  assert signature["model_class"] == f"{_Critic.__module__}._Critic"
  assert signature["global_step"] == 4
  assert signature["outputs"] == ["logits", "q_predicted"]
  assets = specs.load_assets(os.path.join(path, "t2r_assets.json"))
  assert assets.global_step == 4
  state = checkpoints.CheckpointManager(
      str(tmp_path / "checkpoints")).restore(4)
  variables = torch.load(os.path.join(path, "params", "variables.pt"),
                         weights_only=True)
  for got, want in ((variables["params"], state.ema_params),
                    (variables["mutable"], state.mutable_state)):
    assert set(got) == set(want) and all(torch.equal(got[k], want[k])
                                         for k in want)
  assert any(k.endswith("running_var") for k in variables["mutable"])

  exported = predictors.ExportedModelPredictor(
      export_dir=str(tmp_path / "export"), model=_Critic(**KWARGS),
      device="cpu")
  checkpoint = predictors.CheckpointPredictor(
      model=_Critic(**KWARGS), model_dir=str(tmp_path), device="cpu")
  assert exported.restore() and checkpoint.restore()
  assert exported.global_step == checkpoint.global_step == 4
  assert exported.loaded_path == path
  request = _request(exported.model)
  got, want = exported.predict(request), checkpoint.predict(request)
  assert set(got) == set(want)
  for key in want:
    np.testing.assert_array_equal(got[key], want[key])


def test_a_version_appears_whole_and_versions_are_kept(tmp_path,
                                                       monkeypatch):
  model = _Critic(**KWARGS)
  state = train_step.create_train_state(
      model, torch.Generator().manual_seed(0), torch.device("cpu"))
  generator = export_generator.DefaultExportGenerator()
  generator.set_specification_from_model(model)
  base = tmp_path / "export"
  writing, release = threading.Event(), threading.Event()
  plain_save = torch.save

  def slow_save(obj, f):
    writing.set()
    assert release.wait(30)
    plain_save(obj, f)

  monkeypatch.setattr(torch, "save", slow_save)
  paths = []
  writer = threading.Thread(
      target=lambda: paths.append(generator.export(state, str(base), 3)))
  writer.start()
  try:
    assert writing.wait(30)
    names = os.listdir(base)
    assert len(names) == 1 and names[0].startswith(".")
    assert predictors._valid_export_dirs(str(base)) == []
  finally:
    release.set()
    writer.join(30)
  assert [os.path.basename(p) for p in paths] == os.listdir(base)
  monkeypatch.setattr(torch, "save", plain_save)

  # An ExportHook (synchronous) keeps num_versions and the lagged copy.
  hook = hooks.ExportHook(export_generator=generator, num_versions=2,
                          lagged_export_dir_name="lagged")
  ctx = hooks.TrainContext(model, str(tmp_path), get_state=lambda: state)
  hook.begin(ctx)
  for step in (10, 20, 30):
    hook.after_checkpoint(ctx, step)
  versions = sorted(os.listdir(base), key=int)
  lagged = sorted(os.listdir(tmp_path / "lagged"), key=int)
  assert len(versions) == 2 and len(lagged) == 2
  assert lagged[-1] == versions[-2]
  steps = [specs.load_assets(str(base / v / "t2r_assets.json")).global_step
           for v in versions]
  assert steps == [20, 30]
  assert [e["step"] for e in hook.exports] == [10, 20, 30]
  assert all(e["bytes"] > 0 for e in hook.exports)
  # With write_saved_model the bundle also holds the torch.export
  # program, and the SavedModel predictor serves it.
  saved = export_generator.DefaultExportGenerator(write_saved_model=True)
  saved.set_specification_from_model(model)
  path = saved.export(state, str(tmp_path / "saved"), 40)
  assert os.path.isdir(os.path.join(path, "saved_model"))
  predictor = saved_model_predictor.SavedModelPredictor(
      export_dir=str(tmp_path / "saved"), device="cpu")
  assert predictor.restore() and predictor.global_step == 40
  request = _request(model)
  np.testing.assert_array_equal(
      predictor.predict(request)["q_predicted"],
      train_step.make_predict_fn(model)(state, specs.SpecStruct({
          k: torch.as_tensor(v) for k, v in request.items()
      }))["q_predicted"].numpy())


def _jax_state(model, seed):
  """A JAX state whose EMA differs from its params and whose batch
  statistics are off their init."""
  features = dict(jax_specs.make_random_numpy(
      model.get_feature_specification("train"), batch_size=2, seed=0))
  state = jax_train_step.create_train_state(model, jax.random.PRNGKey(seed),
                                            features)[0]
  rng = np.random.RandomState(seed)
  stats = jax.tree_util.tree_map(
      lambda x: (rng.rand(*x.shape) + 0.5).astype(np.float32),
      jax.device_get(state.mutable_state))
  ema = jax.tree_util.tree_map(lambda x: x * 0.9 + 0.01,
                               jax.device_get(state.params))
  return state.replace(mutable_state=stats, ema_params=ema)


def _bundle_pair(tmp_path, seed):
  """(JAX bundle dir, port bundle dir) of one JAX state: the port's
  written from the JAX bundle's variables, read on the JAX side."""
  jax_model = _JaxCritic(device_type="cpu", use_ema=True, **KWARGS)
  generator = jax_export.DefaultExportGenerator()
  generator.set_specification_from_model(jax_model)
  jax_path = generator.export(_jax_state(jax_model, seed),
                              str(tmp_path / "jax" / str(seed)))
  with ocp.StandardCheckpointer() as checkpointer:
    variables = checkpointer.restore(os.path.join(jax_path, "params"))
  carried = bridge.export_variables_from_jax(variables)
  port_generator = export_generator.DefaultExportGenerator()
  port_generator.set_specification_from_model(_Critic(**KWARGS))
  port_path = port_generator.export(
      train_step.TrainState(step=0, params=carried["params"],
                            mutable_state=carried["mutable"]),
      str(tmp_path / "port" / str(seed)))
  return jax_path, port_path


def _jax_exported(path):
  predictor = jax_predictors.ExportedModelPredictor(
      export_dir=os.path.dirname(path),
      model=_JaxCritic(device_type="cpu", use_ema=True, **KWARGS))
  assert predictor.restore()
  return predictor


def _port_exported(path):
  predictor = predictors.ExportedModelPredictor(
      export_dir=os.path.dirname(path), model=_Critic(**KWARGS),
      device="cpu")
  assert predictor.restore()
  return predictor


def test_jax_and_port_bundles_of_the_same_weights_agree(tmp_path):
  jax_path, port_path = _bundle_pair(tmp_path, 0)
  request = _request(_Critic(**KWARGS), rows=3, seed=4)
  want = _jax_exported(jax_path).predict(request)
  got = _port_exported(port_path).predict(request)
  assert set(got) == set(want)
  for key in want:
    assert _rel(got[key], want[key]) <= OUTPUT_RTOL, key


def test_ensemble_matches_jax(tmp_path):
  pairs = [_bundle_pair(tmp_path, seed) for seed in range(3)]
  jax_ensemble = jax_predictors.EnsemblePredictor(
      predictors=[_jax_exported(j) for j, _ in pairs], num_samples=2,
      seed=3)
  ensemble = predictors.EnsemblePredictor(
      predictors=[_port_exported(p) for _, p in pairs], num_samples=2,
      seed=3)
  assert ensemble.restore() and ensemble.global_step == 0
  for seed in (4, 5):
    request = _request(_Critic(**KWARGS), rows=2, seed=seed)
    want, got = jax_ensemble.predict(request), ensemble.predict(request)
    for key in want:
      assert _rel(got[key], want[key]) <= OUTPUT_RTOL, key
  ensemble.close()


def test_a_jax_bundle_is_refused_without_importing_it(tmp_path):
  bundle = tmp_path / "export" / "1"
  os.makedirs(bundle / "params")
  specs.write_assets(specs.Assets(global_step=1),
                     str(bundle / "t2r_assets.json"))
  with open(bundle / "signature.json", "w") as f:
    json.dump({"model_class":
               "tensor2robot_tpu.research.qtopt.models.QTOptModel"}, f)
  with open(bundle / "operative_config.gin", "w") as f:
    f.write("import tensor2robot_tpu.research.qtopt.models\n")
  code = (
      "import sys\n"
      f"sys.path.insert(0, {REPO_ROOT!r})\n"
      "from tensor2robot_tpu_torch.predictors import predictors\n"
      f"p = predictors.ExportedModelPredictor(export_dir={str(tmp_path / 'export')!r}, device='cpu')\n"
      "try:\n"
      "  p.restore()\n"
      "except ValueError as e:\n"
      "  print('refused', 'JAX package' in str(e))\n"
      "print('imported', sorted(m for m in sys.modules\n"
      "                         if m.split('.')[0] == 'tensor2robot_tpu'))\n")
  result = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120, cwd=str(tmp_path))
  assert result.returncode == 0, result.stderr
  assert "refused True" in result.stdout
  assert "imported []" in result.stdout


def test_restore_times_out_and_close_interrupts_the_wait(tmp_path):
  predictor = predictors.ExportedModelPredictor(
      export_dir=str(tmp_path / "empty"), model=_Critic(**KWARGS),
      timeout_secs=0.3, device="cpu")
  start = time.monotonic()
  assert not predictor.restore()
  assert 0.3 <= time.monotonic() - start < 10
  assert predictor.global_step == -1
  waiting = predictors.ExportedModelPredictor(
      export_dir=str(tmp_path / "empty"), model=_Critic(**KWARGS),
      timeout_secs=600, device="cpu")
  thread = waiting.restore_async()
  time.sleep(0.2)
  start = time.monotonic()
  waiting.close()
  assert time.monotonic() - start < 10
  assert not thread.is_alive()
  assert waiting.global_step == -1
