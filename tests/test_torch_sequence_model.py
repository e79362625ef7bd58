"""The port's causal sequence policy against the JAX package's, on the CPU.

The JAX model is initialised by its own predictor; `bridge.py` carries
its flax params into the port, and both predict the same numpy
observations: full forward on the 'reference' and 'flash' backends,
the per-tick `decode_step_fn` and the in-place `decode_arena_step_fn`,
and bf16 predict.

Tolerances: f32 1e-4 (a two-block model, f32 throughout); bf16 3e-2 on
outputs of order 1.
"""

import numpy as np
import pytest
import torch

from tensor2robot_tpu.models import sequence_model as jax_sequence_model
from tensor2robot_tpu.predictors import predictors as jax_predictors
from tensor2robot_tpu_torch import bridge
from tensor2robot_tpu_torch.models import sequence_model
from tensor2robot_tpu_torch.predictors import predictors

# The port's tests run in the same worker processes as the JAX suite;
# one torch thread keeps torch from starting its OpenMP and MKL thread
# pools beside XLA's CPU threads.
torch.set_num_threads(1)

MODEL_TOL = 1e-4
BF16_TOL = 3e-2
WIDTHS = dict(obs_size=4, action_size=2, hidden_size=32, num_blocks=2,
              num_heads=4)

_jax_cache = {}


def _jax_predictor(t, backend, use_bfloat16=False):
  key = (t, backend, use_bfloat16)
  if key not in _jax_cache:
    predictor = jax_predictors.CheckpointPredictor(
        model=jax_sequence_model.SequenceRegressionModel(
            sequence_length=t, attention_backend=backend, device_type="cpu",
            use_bfloat16=use_bfloat16, **WIDTHS),
        model_dir="/nonexistent")
    predictor.init_randomly()
    _jax_cache[key] = predictor
  return _jax_cache[key]


def _port_predictor(jax_predictor, t, backend, use_bfloat16=False):
  predictor = predictors.CheckpointPredictor(
      model=sequence_model.SequenceRegressionModel(
          sequence_length=t, attention_backend=backend,
          use_bfloat16=use_bfloat16, **WIDTHS),
      device="cpu")
  params, ema = bridge.bridge_train_state(
      _numpy_tree(jax_predictor._state.params),
      None if jax_predictor._state.ema_params is None
      else _numpy_tree(jax_predictor._state.ema_params))
  predictor.load_params(params, ema)
  assert predictor.restore()
  return predictor


def _numpy_tree(tree):
  if isinstance(tree, dict) or hasattr(tree, "items"):
    return {k: _numpy_tree(v) for k, v in tree.items()}
  return np.asarray(tree)


def _obs(b, t, seed=0):
  return np.random.RandomState(seed).randn(b, t, WIDTHS["obs_size"]).astype(
      np.float32)


def test_bridge_names_and_layouts():
  jax_pred = _jax_predictor(8, "reference")
  params = _numpy_tree(jax_pred._state.params)
  state_dict = bridge.state_dict_from_flax(params)
  model = sequence_model.SequenceRegressionModel(sequence_length=8, **WIDTHS)
  assert set(state_dict) == set(model.module.state_dict())
  np.testing.assert_array_equal(state_dict["attn_1.q_proj.weight"].numpy(),
                                params["attn_1"]["q_proj"]["kernel"].T)
  np.testing.assert_array_equal(state_dict["ln_mlp_0.weight"].numpy(),
                                params["ln_mlp_0"]["scale"])
  with pytest.raises(ValueError, match="no bridge"):
    bridge.state_dict_from_flax({"conv": {"kernel": np.zeros((3, 3, 1, 2)),
                                          "bias": np.zeros(2),
                                          "extra": np.zeros(1)}})


@pytest.mark.parametrize("backend,t", [("reference", 8), ("reference", 32),
                                       ("flash", 8), ("flash", 32),
                                       ("flash", 12)])
def test_predict_matches_jax_on_bridged_weights(backend, t):
  jax_pred = _jax_predictor(t, backend)
  port = _port_predictor(jax_pred, t, backend)
  obs = _obs(2, t, seed=t)
  want = jax_pred.predict({"observation": obs})
  got = port.predict({"observation": obs})
  assert set(got) == {"action", "inference_output"}
  assert got["action"].shape == (2, t, 2) and got["action"].dtype == np.float32
  np.testing.assert_allclose(got["action"], want["action"], atol=MODEL_TOL,
                             rtol=MODEL_TOL)


@pytest.mark.parametrize("t", [8, 32])
def test_decode_step_matches_jax_full_prefix(t):
  """The pure per-tick decode reproduces the JAX stateless forward at
  every step, and advances each row's tick index."""
  jax_pred = _jax_predictor(t, "reference")
  port = _port_predictor(jax_pred, t, "reference")
  obs = _obs(2, t, seed=3)
  full = jax_pred.predict({"observation": obs})["action"]
  bundle = port.decode_bundle()
  state = bundle.get_state()
  sess = bundle.init_session_state(2)
  for i in range(t):
    sess, out = bundle.decode_fn(state, sess,
                                 {"observation": torch.from_numpy(obs[:, i])})
    np.testing.assert_allclose(out["action"].numpy(), full[:, i],
                               atol=MODEL_TOL, rtol=MODEL_TOL)
  assert sess["index"].tolist() == [t, t]


@pytest.mark.parametrize("t", [8, 32])
def test_decode_arena_step_matches_jax_full_prefix(t):
  """The fused-arena tick, in place on a 4-slot arena: two lanes on slots
  3 and 1 plus a pad lane on the null slot, against the JAX forward."""
  jax_pred = _jax_predictor(t, "flash")
  port = _port_predictor(jax_pred, t, "flash")
  obs = _obs(2, t, seed=5)
  full = jax_pred.predict({"observation": obs})["action"]
  bundle = port.decode_bundle()
  state = bundle.get_state()
  arena = bundle.init_session_state(4)
  ptrs = {k: v.data_ptr() for k, v in arena.items()}
  null_before = {k: v[0].clone() for k, v in arena.items()}
  slots = torch.tensor([3, 1, 0], dtype=torch.int32)
  mask = torch.tensor([True, True, False])
  for i in range(t):
    features = {"observation": torch.from_numpy(
        np.concatenate([obs[:, i], obs[:1, i]]))}
    new_arena, out = bundle.decode_arena_fn(state, arena, slots, features,
                                            mask)
    assert new_arena is arena
    np.testing.assert_allclose(out["action"][:2].numpy(), full[:, i],
                               atol=MODEL_TOL, rtol=MODEL_TOL)
  assert {k: v.data_ptr() for k, v in arena.items()} == ptrs
  assert arena["index"].tolist() == [0, t, 0, t]
  for k, v in arena.items():
    assert torch.equal(v[0], null_before[k]), k


def test_bf16_predict_matches_jax():
  t = 8
  jax_pred = _jax_predictor(t, "flash", use_bfloat16=True)
  port = _port_predictor(jax_pred, t, "flash", use_bfloat16=True)
  obs = _obs(2, t, seed=9)
  want = jax_pred.predict({"observation": obs})["action"]
  got = port.predict({"observation": obs})["action"]
  assert got.dtype == np.float32 and np.isfinite(got).all()
  np.testing.assert_allclose(got, want, atol=BF16_TOL, rtol=BF16_TOL)


def test_random_init_is_seeded():
  def predict(seed):
    predictor = predictors.CheckpointPredictor(
        model=sequence_model.SequenceRegressionModel(sequence_length=8,
                                                     **WIDTHS),
        device="cpu")
    predictor.init_randomly(seed=seed)
    return predictor.predict({"observation": _obs(1, 8)})["action"]

  np.testing.assert_array_equal(predict(0), predict(0))
  assert not np.allclose(predict(0), predict(1))


@pytest.mark.parametrize("backend", ["ring", "ulysses"])
def test_sequence_parallel_backends_are_not_ported_yet(backend):
  # Ported (tests/test_torch_sequence_parallel.py): without a mesh the
  # module cannot be built, as in the JAX package.
  model = sequence_model.SequenceRegressionModel(attention_backend=backend,
                                                 **WIDTHS)
  with pytest.raises(ValueError, match="set_mesh"):
    model.create_module()


def test_load_params_checks_names_and_shapes():
  predictor = predictors.CheckpointPredictor(
      model=sequence_model.SequenceRegressionModel(sequence_length=8,
                                                   **WIDTHS),
      device="cpu")
  assert not predictor.restore()
  with pytest.raises(ValueError, match="no model loaded"):
    predictor.predict({"observation": _obs(1, 8)})
  params = predictor.model.init_params(torch.Generator().manual_seed(0))
  with pytest.raises(ValueError, match="missing"):
    predictor.load_params({k: v for k, v in params.items() if k != "head.bias"})
  params["head.bias"] = torch.zeros(3)
  with pytest.raises(ValueError, match="shape"):
    predictor.load_params(params)


def test_specs_and_random_batches_match_jax():
  """The feature/label/decode specs, and `make_random_numpy` draws the
  same numpy stream for the same seed."""
  from tensor2robot_tpu import specs as jax_specs
  from tensor2robot_tpu_torch import specs

  jax_model = _jax_predictor(8, "reference")._model
  model = sequence_model.SequenceRegressionModel(sequence_length=8, **WIDTHS)
  for mode in ("train", "predict"):
    for getter in ("get_feature_specification", "get_label_specification"):
      mine = specs.flatten_spec_structure(getattr(model, getter)(mode))
      theirs = jax_specs.flatten_spec_structure(getattr(jax_model, getter)(
          mode))
      assert list(mine) == list(theirs)
      for key in mine:
        assert mine[key].shape == theirs[key].shape
        assert mine[key].dtype == theirs[key].dtype
  spec = model.get_feature_specification("predict")
  got = specs.make_random_numpy(spec, batch_size=3, seed=5)
  want = jax_specs.make_random_numpy(
      jax_model.get_feature_specification("predict"), batch_size=3, seed=5)
  np.testing.assert_array_equal(got["observation"], want["observation"])
  bf16 = sequence_model.SequenceRegressionModel(
      sequence_length=8, use_bfloat16=True, **WIDTHS).preprocessor
  out_spec = bf16.get_out_feature_specification("predict")
  assert out_spec["observation"].dtype is torch.bfloat16


def test_predict_validates_features_against_the_spec():
  port = _port_predictor(_jax_predictor(8, "reference"), 8, "reference")
  with pytest.raises(ValueError, match="incompatible"):
    port.predict({"observation": _obs(1, 7)})
  with pytest.raises(ValueError, match="no matching value"):
    port.predict({"obs": _obs(1, 8)})


def test_serving_bundle_predicts_like_the_predictor():
  port = _port_predictor(_jax_predictor(8, "reference"), 8, "reference")
  bundle = port.serving_bundle()
  obs = _obs(2, 8, seed=13)
  features = bundle.preprocess({"observation": obs})
  got = bundle.predict_fn(bundle.get_state(), features)["action"].numpy()
  np.testing.assert_array_equal(got, port.predict({"observation": obs})[
      "action"])
  assert list(bundle.feature_spec) == ["observation"]
