"""The port's SavedModel (a `torch.export` program) and its predictor,
against the JAX package's jax2tf SavedModel served by TensorFlow.

* The JAX `MockT2RModel`, trained 10 steps with `write_saved_model=True`,
  is served by the JAX `SavedModelPredictor` under TF; its bundle's
  variables, carried across by `bridge.export_variables_from_jax`, are
  exported by the port's `DefaultExportGenerator(write_saved_model=True)`
  and served by the port's `SavedModelPredictor` from one artifact at
  batches 2 and 5: outputs within 1e-6. The same holds through the
  tf_example receiver on the same serialized protos.
* The causal sequence policy on the 'flash' backend (two blocks, width
  32): the program records `t2r::flash_fwd` (its CPU implementation, the
  plain version, runs here) and matches the JAX model's predict on the
  bridged weights within 1e-4 (the f32 limit of
  `test_torch_sequence_model.py`) at batches 1 and 3.
* Restore-time checks, twins of the JAX package's: two specs sharing a
  feed name raise "both feed serving"; spec names that differ from the
  declared inputs raise. A TensorFlow SavedModel directory is refused.
* The preprocessor rule: an identity or torch-op preprocessor exports
  (the second embedded, serving wire-layout features); a host-side one
  is refused unless the receivers are raw.
"""

import json
import os

import numpy as np
import orbax.checkpoint as ocp
import pytest
import torch

from tensor2robot_tpu import train_eval as jax_train_eval
from tensor2robot_tpu.data import codec as jax_codec
from tensor2robot_tpu.export import export_generator as jax_export
from tensor2robot_tpu.models import sequence_model as jax_sequence_model
from tensor2robot_tpu.predictors import predictors as jax_predictors
from tensor2robot_tpu.predictors import saved_model_predictor as jax_smp
from tensor2robot_tpu.utils import config as jax_config
from tensor2robot_tpu.utils import mocks as jax_mocks
from tensor2robot_tpu_torch import bridge
from tensor2robot_tpu_torch import specs
from tensor2robot_tpu_torch.export import export_generator
from tensor2robot_tpu_torch.export import saved_model
from tensor2robot_tpu_torch.models import sequence_model
from tensor2robot_tpu_torch.parallel import train_step
from tensor2robot_tpu_torch.predictors import predictors
from tensor2robot_tpu_torch.predictors import saved_model_predictor
from tensor2robot_tpu_torch.preprocessors import base as preprocessors_lib
from tensor2robot_tpu_torch.utils import config
from tensor2robot_tpu_torch.utils import mocks

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _clean_config():
  """No binding another test left in the port's config reaches the export
  generator or the models exported here."""
  config.clear_config()
  yield
  config.clear_config()

MOCK_TOL = 1e-6
SEQUENCE_TOL = 1e-4
WIDTHS = dict(obs_size=4, action_size=2, hidden_size=32, num_blocks=2,
              num_heads=4)


@pytest.fixture(scope="module")
def jax_mock_export(tmp_path_factory):
  """(JAX export root, port export root) of the mock trained 10 steps."""
  pytest.importorskip("tensorflow")
  root = tmp_path_factory.mktemp("mock")
  model_dir = str(root / "jax")
  jax_config.clear_config()
  jax_train_eval.train_eval_model(
      model=jax_mocks.MockT2RModel(device_type="cpu"),
      model_dir=model_dir, mode="train", max_train_steps=10,
      checkpoint_every_n_steps=10,
      input_generator_train=jax_mocks.MockInputGenerator(batch_size=4),
      mesh_shape=(1, 1, 1),
      export_generators=[jax_export.DefaultExportGenerator(
          write_saved_model=True)],
      log_every_n_steps=10)
  jax_config.clear_config()
  jax_root = os.path.join(model_dir, "export")
  bundle = jax_predictors._valid_export_dirs(jax_root)[-1]
  with ocp.StandardCheckpointer() as checkpointer:
    variables = checkpointer.restore(os.path.join(bundle, "params"))
  carried = bridge.export_variables_from_jax(variables)
  generator = export_generator.DefaultExportGenerator(write_saved_model=True)
  generator.set_specification_from_model(mocks.MockT2RModel())
  port_root = str(root / "port")
  generator.export(train_step.TrainState(
      step=10, params=carried["params"], mutable_state=carried["mutable"]),
      port_root)
  return jax_root, port_root


def _port_predictor(root):
  predictor = saved_model_predictor.SavedModelPredictor(export_dir=root,
                                                        device="cpu")
  assert predictor.restore()
  return predictor


@pytest.mark.parametrize("batch", [2, 5])
def test_mock_matches_the_jax_tf_saved_model(jax_mock_export, batch):
  jax_root, port_root = jax_mock_export
  want_predictor = jax_smp.SavedModelPredictor(export_dir=jax_root)
  assert want_predictor.restore()
  got_predictor = _port_predictor(port_root)
  assert got_predictor.global_step == want_predictor.global_step == 10
  x = np.random.RandomState(batch).randn(batch, 3).astype(np.float32)
  want = want_predictor.predict({"x": x})
  got = got_predictor.predict({"x": x})
  assert set(got) == set(want)
  for key in want:
    assert got[key].shape == want[key].shape == (batch, 1)
    np.testing.assert_allclose(got[key], want[key], rtol=0, atol=MOCK_TOL)


def test_tf_example_receiver_matches_the_jax_tf_saved_model(
    jax_mock_export):
  import tensorflow as tf

  jax_root, port_root = jax_mock_export
  bundle = jax_predictors._valid_export_dirs(jax_root)[-1]
  module = tf.saved_model.load(os.path.join(bundle, "saved_model"))
  rows = np.random.RandomState(7).randn(3, 3).astype(np.float32)
  records = [jax_codec.encode_example({"measured_position": row}, None)
             for row in rows]
  want = module.tf_example_fn(tf.constant(records))
  port = _port_predictor(port_root)
  got = port.predict_tf_example(records)
  dense = port.predict({"x": rows})
  for key in ("prediction", "logit"):
    np.testing.assert_allclose(got[key], np.asarray(want[key]), rtol=0,
                               atol=MOCK_TOL)
    np.testing.assert_array_equal(got[key], dense[key])


def test_sequence_policy_program_runs_the_flash_operator(tmp_path):
  t = 16
  jax_predictor = jax_predictors.CheckpointPredictor(
      model=jax_sequence_model.SequenceRegressionModel(
          sequence_length=t, attention_backend="flash", device_type="cpu",
          **WIDTHS),
      model_dir="/nonexistent")
  jax_predictor.init_randomly()
  numpy_tree = lambda tree: {  # noqa: E731
      k: numpy_tree(v) if hasattr(v, "items") else np.asarray(v)
      for k, v in tree.items()}
  params, ema = bridge.bridge_train_state(
      numpy_tree(jax_predictor._state.params),
      None if jax_predictor._state.ema_params is None
      else numpy_tree(jax_predictor._state.ema_params))
  model = sequence_model.SequenceRegressionModel(
      sequence_length=t, attention_backend="flash", **WIDTHS)
  generator = export_generator.DefaultExportGenerator(write_saved_model=True)
  generator.set_specification_from_model(model)
  generator.export(train_step.TrainState(step=3, params=params,
                                         ema_params=ema),
                   str(tmp_path / "export"))
  program = torch.export.load(os.path.join(
      predictors._valid_export_dirs(str(tmp_path / "export"))[-1],
      "saved_model", saved_model.PROGRAM_FILENAME))
  targets = [str(node.target) for node in program.graph.nodes
             if node.op == "call_function"]
  assert targets.count("t2r.flash_fwd.default") == WIDTHS["num_blocks"]
  port = _port_predictor(str(tmp_path / "export"))
  for batch in (1, 3):
    obs = np.random.RandomState(batch).randn(
        batch, t, WIDTHS["obs_size"]).astype(np.float32)
    want = jax_predictor.predict({"observation": obs})
    got = port.predict({"observation": obs})
    assert got["action"].shape == (batch, t, WIDTHS["action_size"])
    np.testing.assert_allclose(got["action"], np.asarray(want["action"]),
                               rtol=0, atol=SEQUENCE_TOL)


def _doctored_bundle(root, feature_spec):
  """A port bundle of the mock whose assets declare `feature_spec`."""
  model = mocks.MockT2RModel()
  generator = export_generator.DefaultExportGenerator(write_saved_model=True)
  generator.set_specification_from_model(model)
  path = generator.export(train_step.create_train_state(
      model, torch.Generator().manual_seed(0), torch.device("cpu")), root)
  assets = specs.load_assets(os.path.join(path, specs.ASSET_FILENAME))
  specs.write_assets(specs.Assets(feature_spec=feature_spec,
                                  label_spec=assets.label_spec,
                                  global_step=assets.global_step),
                     os.path.join(path, specs.ASSET_FILENAME))
  return root


def test_duplicate_feed_names_raise(tmp_path):
  root = _doctored_bundle(str(tmp_path / "export"), specs.SpecStruct({
      "a/x": specs.TensorSpec(shape=(3,), dtype=np.float32,
                              name="measured_position"),
      "b/x": specs.TensorSpec(shape=(3,), dtype=np.float32,
                              name="measured_position")}))
  predictor = saved_model_predictor.SavedModelPredictor(export_dir=root,
                                                        device="cpu")
  with pytest.raises(ValueError, match="both feed serving"):
    predictor.restore()


def test_feed_name_mismatch_raises(tmp_path):
  root = _doctored_bundle(str(tmp_path / "export"), specs.SpecStruct({
      "x": specs.TensorSpec(shape=(3,), dtype=np.float32,
                            name="misnamed_position")}))
  predictor = saved_model_predictor.SavedModelPredictor(export_dir=root,
                                                        device="cpu")
  with pytest.raises(ValueError, match="do not match the serving_default"):
    predictor.restore()


def test_tf_saved_model_directory_is_refused(jax_mock_export):
  jax_root, _ = jax_mock_export
  predictor = saved_model_predictor.SavedModelPredictor(export_dir=jax_root,
                                                        device="cpu")
  with pytest.raises(ValueError, match="TensorFlow SavedModel"):
    predictor.restore()


def test_reference_era_tf_directory_is_refused(tmp_path):
  bundle = tmp_path / "export" / "1234567890"
  bundle.mkdir(parents=True)
  (bundle / "saved_model.pb").write_bytes(b"\x08\x01")
  predictor = saved_model_predictor.SavedModelPredictor(
      export_dir=str(tmp_path / "export"), device="cpu")
  with pytest.raises(ValueError, match="TensorFlow SavedModel"):
    predictor.restore()


def test_restore_waits_then_returns_false(tmp_path):
  predictor = saved_model_predictor.SavedModelPredictor(
      export_dir=str(tmp_path), device="cpu")
  assert predictor.restore() is False
  assert predictor.global_step == -1


class _Shift(preprocessors_lib.SpecTransformationPreprocessor):
  """x -> 2x - 1, in torch ops."""

  def _preprocess_fn(self, features, labels, mode):
    features = specs.SpecStruct(dict(features.items()))
    features["x"] = features["x"] * 2.0 - 1.0
    return features, labels


class _HostShift(preprocessors_lib.SpecTransformationPreprocessor):
  """The same transform through numpy on the host."""

  def _preprocess_fn(self, features, labels, mode):
    features = specs.SpecStruct(dict(features.items()))
    features["x"] = torch.as_tensor(np.asarray(features["x"]) * 2.0 - 1.0)
    return features, labels


def _mock_with(preprocessor_cls):
  model = mocks.MockT2RModel(preprocessor_cls=preprocessor_cls)
  state = train_step.create_train_state(
      model, torch.Generator().manual_seed(0), torch.device("cpu"))
  return model, state


def test_torch_preprocessor_is_embedded(tmp_path):
  model, state = _mock_with(_Shift)
  generator = export_generator.DefaultExportGenerator(write_saved_model=True)
  generator.set_specification_from_model(model)
  path = generator.export(state, str(tmp_path / "export"))
  with open(os.path.join(path, export_generator.SIGNATURE_FILENAME)) as f:
    assert json.load(f)["preprocessor_embedded"] is True
  wire = {"x": np.linspace(-1.0, 1.0, 6, dtype=np.float32).reshape(2, 3)}
  served = _port_predictor(str(tmp_path / "export")).predict(wire)
  eager = predictors.ExportedModelPredictor(
      export_dir=str(tmp_path / "export"), model=model, device="cpu")
  assert eager.restore()
  np.testing.assert_allclose(served["prediction"],
                             eager.predict(wire)["prediction"], rtol=1e-6)


def test_host_preprocessor_is_refused_unless_raw(tmp_path):
  model, state = _mock_with(_HostShift)
  generator = export_generator.DefaultExportGenerator(write_saved_model=True)
  with pytest.raises(ValueError, match="_HostShift"):
    generator.set_specification_from_model(model)
  raw = export_generator.DefaultExportGenerator(write_saved_model=True,
                                                export_raw_receivers=True)
  raw.set_specification_from_model(model)
  path = raw.export(state, str(tmp_path / "export"))
  assert os.path.isdir(os.path.join(path, "saved_model"))


def test_predictor_runs_on_cuda_unless_asked_for_the_cpu(monkeypatch,
                                                         tmp_path):
  monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
  with pytest.raises(RuntimeError, match="no CUDA device"):
    saved_model_predictor.SavedModelPredictor(export_dir=str(tmp_path))
  assert saved_model_predictor.SavedModelPredictor(
      export_dir=str(tmp_path), device="cpu").device == torch.device("cpu")
