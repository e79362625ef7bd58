"""The LSTM family in the port against the JAX package, on the CPU.

`LSTMRegressionModel` at test widths (obs 4, action 2, T 6, hidden 8),
f32; JAX parameters drawn at random (biases included, so a bias in the
wrong place or gates in the wrong order show) and carried across by
`bridge.py`:

* the full-sequence forward against the JAX model's `nn.RNN(
  OptimizedLSTMCell)`, and the bridge's layout (rows of `weight_ih`
  and `weight_hh` stacked i, f, g, o; `bias_hh` the hidden biases): 1e-5
  relative;
* a session advanced tick by tick through the decode seam against the
  full-prefix forward at every step, as `tests/test_session.py` holds
  the JAX model (rtol 1e-5, atol 1e-6);
* `SessionEngine` on the carry path (gather -> one tick -> masked
  scatter) against the JAX engine on the same weights, two staggered
  sessions in padded buckets, past T (the carry has no horizon): 1e-5;
  pad lanes leave the null slot as it was (zeros, bit for bit);
* one train step against the JAX step (Adam 1e-4): loss 1e-5, parameters
  1e-6 absolute;
* `train_eval_model` trains it, `CheckpointPredictor(model_dir=...)`
  restores the newest step and its engine's ticks equal its stateless
  predict;
* the port's init: orthogonal hidden kernels per gate, zero biases.
"""

import jax
import numpy as np
import pytest
import torch

from tensor2robot_tpu import serving as jax_serving
from tensor2robot_tpu.models import sequence_model as jax_sequence_model
from tensor2robot_tpu.obs import metrics as jax_metrics
from tensor2robot_tpu.parallel import train_step as jax_train_step
from tensor2robot_tpu.predictors import predictors as jax_predictors
from tensor2robot_tpu_torch import bridge
from tensor2robot_tpu_torch import train_eval
from tensor2robot_tpu_torch.data import input_generators
from tensor2robot_tpu_torch.models import sequence_model
from tensor2robot_tpu_torch.obs import metrics as metrics_lib
from tensor2robot_tpu_torch.parallel import train_step
from tensor2robot_tpu_torch.predictors import predictors
from tensor2robot_tpu_torch.serving import session

# The port's tests run in the same worker processes as the JAX suite;
# one torch thread keeps torch from starting its OpenMP and MKL thread
# pools beside XLA's CPU threads.
torch.set_num_threads(1)

LSTM_KW = dict(obs_size=4, action_size=2, sequence_length=6, hidden_size=8)
T, OBS, H = LSTM_KW["sequence_length"], LSTM_KW["obs_size"], LSTM_KW[
    "hidden_size"]
FORWARD_RTOL = 1e-5
TICK_RTOL, TICK_ATOL = 1e-5, 1e-6
PARAM_ATOL = 1e-6


def _obs(batch, seq_len=T, seed=0):
  return np.random.RandomState(seed).randn(batch, seq_len, OBS).astype(
      np.float32)


def _randomized(params, seed=0):
  """Every leaf of a flax tree redrawn from N(0, 0.5^2)."""
  rs = np.random.RandomState(seed)
  return jax.tree_util.tree_map(
      lambda x: (0.5 * rs.randn(*np.shape(x))).astype(np.float32), params)


def _jax_predictor(seed=0):
  predictor = jax_predictors.CheckpointPredictor(
      model=jax_sequence_model.LSTMRegressionModel(device_type="cpu",
                                                   **LSTM_KW),
      model_dir="/nonexistent")
  predictor.init_randomly()
  params = _randomized(jax.device_get(predictor._state.params), seed)
  predictor._state = predictor._state.replace(params=params, ema_params=None)
  return predictor


def _port_predictor(jax_predictor, sequence_length=T):
  predictor = predictors.CheckpointPredictor(
      model=sequence_model.LSTMRegressionModel(
          **dict(LSTM_KW, sequence_length=sequence_length)), device="cpu")
  predictor.load_params(bridge.state_dict_from_flax(
      bridge._numpy_tree(jax.device_get(jax_predictor._state.params))))
  assert predictor.restore()
  return predictor


def _rel(got, want):
  got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
  return float(np.abs(got - want).max() / np.abs(want).max())


def test_bridge_layout_and_full_sequence_match_jax():
  jax_pred = _jax_predictor()
  flax_cell = jax.device_get(jax_pred._state.params)["lstm_cell"]
  port = _port_predictor(jax_pred)
  params = port._state.params
  assert set(params) == {"lstm_cell.weight_ih", "lstm_cell.weight_hh",
                         "lstm_cell.bias_hh", "head.weight", "head.bias"}
  for i, gate in enumerate(bridge.LSTM_GATES):
    rows = slice(i * H, (i + 1) * H)
    for name, want in (
        ("weight_ih", np.asarray(flax_cell["i" + gate]["kernel"]).T),
        ("weight_hh", np.asarray(flax_cell["h" + gate]["kernel"]).T),
        ("bias_hh", np.asarray(flax_cell["h" + gate]["bias"]))):
      np.testing.assert_array_equal(
          params[f"lstm_cell.{name}"][rows].numpy(), want)
  obs = _obs(3, seed=1)
  want = jax_pred.predict({"observation": obs})["action"]
  got = port.predict({"observation": obs})["action"]
  assert got.shape == (3, T, LSTM_KW["action_size"])
  assert _rel(got, want) <= FORWARD_RTOL


def test_ticks_match_the_full_prefix():
  port = _port_predictor(_jax_predictor(seed=2))
  obs = _obs(2, seed=3)
  full = port.predict({"observation": obs})["action"]
  bundle = port.decode_bundle()
  assert bundle.decode_arena_fn is None and bundle.max_ticks is None
  state = bundle.get_state()
  sess = bundle.init_session_state(2)
  assert set(sess) == {"index", "carry_c", "carry_h"}
  with torch.no_grad():
    for t in range(T):
      sess, out = bundle.decode_fn(
          state, sess, {"observation": torch.from_numpy(obs[:, t])})
      np.testing.assert_allclose(out["action"].numpy(), full[:, t],
                                 rtol=TICK_RTOL, atol=TICK_ATOL)
  assert sess["index"].tolist() == [T, T]


def test_engine_carry_path_matches_jax_engine():
  jax_pred = _jax_predictor(seed=4)
  port = _port_predictor(jax_pred)
  ticks = T + 3  # past T: the carry has no horizon
  obs = _obs(2, seq_len=ticks, seed=5)
  full = _port_predictor(jax_pred, ticks).predict(
      {"observation": obs})["action"]
  with jax_metrics.isolated(), metrics_lib.isolated():
    jax_engine = jax_serving.SessionEngine(predictor=jax_pred,
                                           max_sessions=4, buckets=[1, 2, 4])
    engine = session.SessionEngine(predictor=port, max_sessions=4,
                                   buckets=[1, 2, 4], device="cpu")
    jax_a, jax_b = jax_engine.open(), jax_engine.open()
    a, b = engine.open(), engine.open()
    got = engine.step(a, {"observation": obs[0, 0]})
    want = jax_engine.step(jax_a, {"observation": obs[0, 0]})
    assert _rel(got["action"], want["action"]) <= FORWARD_RTOL
    for i in range(ticks - 1):
      # Two sessions a tick apart in one dispatch.
      items = [(a, {"observation": obs[0, i + 1]}),
               (b, {"observation": obs[1, i]})]
      got = engine.step_many(items)
      want = jax_engine.step_many([(jax_a, items[0][1]),
                                   (jax_b, items[1][1])])
      for lane, (row, col) in enumerate([(0, i + 1), (1, i)]):
        assert _rel(got[lane]["action"], want[lane]["action"]) \
            <= FORWARD_RTOL
        np.testing.assert_allclose(got[lane]["action"], full[row, col],
                                   rtol=TICK_RTOL, atol=TICK_ATOL)
    assert engine.session_ticks(a) == ticks
    assert engine.session_ticks(b) == ticks - 1
    for leaf in engine.arena.values():
      assert leaf.shape[0] == 5 and not leaf[0].any()
    assert engine.arena["index"][1:].tolist().count(ticks) == 1
    engine.close()
    jax_engine.close()


def test_engine_pad_lanes_leave_the_null_slot():
  port = _port_predictor(_jax_predictor(seed=6))
  with metrics_lib.isolated():
    engine = session.SessionEngine(predictor=port, max_sessions=4,
                                   buckets=[4], device="cpu").warmup()
    sid = engine.open()
    for t in range(3):
      engine.step(sid, {"observation": _obs(1, seed=t)[0, 0]})
    slot = engine._slots[sid]
    for name, leaf in engine.arena.items():
      assert not leaf[0].any(), name  # 3 pad lanes a tick, zeros kept
      others = [s for s in range(1, 5) if s != slot]
      assert not leaf[others].any(), name
    assert engine.arena["carry_h"][slot].abs().sum() > 0
    engine.close()


def test_train_step_matches_jax():
  jax_model = jax_sequence_model.LSTMRegressionModel(device_type="cpu",
                                                     **LSTM_KW)
  model = sequence_model.LSTMRegressionModel(**LSTM_KW)
  rs = np.random.RandomState(7)
  features = {"observation": _obs(3, seed=8)}
  labels = {"action": rs.randn(3, T, LSTM_KW["action_size"]).astype(
      np.float32)}
  jax_state, _ = jax_train_step.create_train_state(
      jax_model, jax.random.PRNGKey(0), features)
  jax_state = jax_state.replace(params=_randomized(
      jax.device_get(jax_state.params), seed=9))
  state = bridge.train_state_from_jax(jax_state)
  jax_state, jax_metrics_ = jax_train_step.make_train_step(
      jax_model, donate=False)(jax_state, features, labels)
  state, metrics = train_step.make_train_step(model)(
      state, {k: torch.from_numpy(v) for k, v in features.items()},
      {k: torch.from_numpy(v) for k, v in labels.items()})
  assert set(metrics) == set(jax_metrics_)
  for key in metrics:
    assert _rel(float(metrics[key]), float(jax_metrics_[key])) <= 1e-5, key
  want = bridge.state_dict_from_flax(bridge._numpy_tree(jax_state.params))
  for name, value in want.items():
    np.testing.assert_allclose(state.params[name].numpy(), value.numpy(),
                               atol=PARAM_ATOL, rtol=0, err_msg=name)


def test_trains_and_serves_from_its_checkpoint(tmp_path):
  model = sequence_model.LSTMRegressionModel(**LSTM_KW)
  train_eval.train_eval_model(
      model=model, model_dir=str(tmp_path), mode="train", max_train_steps=6,
      checkpoint_every_n_steps=3, log_every_n_steps=1, device="cpu",
      input_generator_train=input_generators.DefaultRandomInputGenerator(
          batch_size=4))
  predictor = predictors.CheckpointPredictor(
      model=sequence_model.LSTMRegressionModel(**LSTM_KW),
      model_dir=str(tmp_path), device="cpu")
  assert predictor.restore() and predictor.global_step == 6
  obs = _obs(1, seed=10)
  full = predictor.predict({"observation": obs})["action"][0]
  with metrics_lib.isolated():
    engine = session.SessionEngine(predictor=predictor, max_sessions=2,
                                   max_tick_batch=2, device="cpu")
    sid = engine.open()
    ticks = np.stack([engine.step(sid, {"observation": obs[0, t]})["action"]
                      for t in range(T)])
    engine.close()
  np.testing.assert_allclose(ticks, full, rtol=TICK_RTOL, atol=TICK_ATOL)


def test_init_is_flax_s():
  model = sequence_model.LSTMRegressionModel(**LSTM_KW)
  params = model.init_params(torch.Generator().manual_seed(0))
  assert not params["lstm_cell.bias_hh"].any()
  for gate in params["lstm_cell.weight_hh"].chunk(4):
    torch.testing.assert_close(gate @ gate.T, torch.eye(H), atol=1e-5,
                               rtol=0)
  assert params["lstm_cell.weight_ih"].shape == (4 * H, OBS)
  other = model.init_params(torch.Generator().manual_seed(1))
  assert not torch.equal(other["lstm_cell.weight_ih"],
                         params["lstm_cell.weight_ih"])
  with pytest.raises(ValueError, match="no bridge"):
    bridge.state_dict_from_flax({"cell": {"ii": {"kernel": np.zeros((2, 2))},
                                          "x": {"y": np.zeros(2)}}})
