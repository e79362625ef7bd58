"""The port's train step against the JAX package's, on the CPU.

A JAX `TrainState` (the JAX model's own initialisation, Adam at 1e-4) is
carried into the port by `bridge.train_state_from_jax`; both packages
then train the same numpy batches, preprocessed by their own
preprocessors, through their `make_train_step` (JAX: no mesh, no
donation; flash attention with the Pallas kernels interpreted).

Tolerances, f32: loss and gradient norm 1e-5; parameters and EMA 1e-6
absolute, 1% of the learning rate. The exception is `attn_*.k_proj.bias`:
softmax is invariant to a shift of every score in a row, so its gradient
is zero up to rounding, and Adam normalises that rounding noise to a step
of ±lr in either package; it is held to 2 * lr * steps. bf16: loss and
gradient norm 3e-2 relative (bf16 activations). Adam steps are ~lr in
size whatever the gradient's rounding, so in bf16 the parameters and EMA
are held by their update Δ = final - initial against JAX's: |Δ - Δ_jax|
over |Δ_jax| (2-norms) at most 0.25 per leaf and 0.1 over all leaves
together (k_proj.bias left out, for the reason above). Sound readings
after 3 steps: worst leaf 0.132 (params) and 0.186 (EMA), both
`ln_mlp_0.bias`, where one element's gradient is within rounding of
zero; all leaves 0.036 and 0.049. An update never applied reads 1, one
of the wrong sign 2.
"""

import jax
import numpy as np
import pytest
import torch

from tensor2robot_tpu.models import sequence_model as jax_sequence_model
from tensor2robot_tpu.parallel import train_step as jax_train_step
from tensor2robot_tpu_torch import bridge
from tensor2robot_tpu_torch.models import sequence_model
from tensor2robot_tpu_torch.parallel import train_step

# The port's tests run in the same worker processes as the JAX suite;
# one torch thread keeps torch from starting its OpenMP and MKL thread
# pools beside XLA's CPU threads.
torch.set_num_threads(1)

LR = 1e-4
F32_TOL = 1e-5
PARAM_TOL = 1e-6
BF16_RTOL = 3e-2
BF16_DELTA_LEAF_RTOL = 0.25
BF16_DELTA_TREE_RTOL = 0.1
WIDTHS = dict(obs_size=4, action_size=2, hidden_size=32, num_blocks=2,
              num_heads=2, sequence_length=40, attention_backend="flash")


def _models(use_bfloat16=False, use_ema=False):
  kwargs = dict(use_bfloat16=use_bfloat16, use_ema=use_ema, ema_decay=0.9,
                **WIDTHS)
  return (jax_sequence_model.SequenceRegressionModel(device_type="cpu",
                                                     **kwargs),
          sequence_model.SequenceRegressionModel(**kwargs))


def _batches(n, seed=0):
  rs = np.random.RandomState(seed)
  t, obs, act = (WIDTHS["sequence_length"], WIDTHS["obs_size"],
                 WIDTHS["action_size"])
  return [({"observation": rs.randn(2, t, obs).astype(np.float32)},
           {"action": rs.randn(2, t, act).astype(np.float32)})
          for _ in range(n)]


def _preprocess_both(jax_model, model, features, labels):
  jax_batch = jax_model.preprocessor.preprocess(features, labels, "train")
  port_batch = model.preprocessor.preprocess(
      {k: torch.from_numpy(v) for k, v in features.items()},
      {k: torch.from_numpy(v) for k, v in labels.items()}, "train")
  return jax_batch, port_batch


def _state_dict(tree):
  return bridge.state_dict_from_flax(bridge._numpy_tree(tree))


def _assert_params_close(jax_tree, params, steps, default_tol):
  want = _state_dict(jax_tree)
  assert set(want) == set(params)
  for name, value in want.items():
    tol = 2 * LR * steps if name.endswith("k_proj.bias") else default_tol
    np.testing.assert_allclose(params[name].numpy(), value.numpy(), atol=tol,
                               rtol=0, err_msg=name)


def _assert_updates_close(jax_tree, params, jax_tree0, params0):
  """The port's update Δ = params - params0 against JAX's, by relative
  2-norm per leaf and over all leaves together."""
  want, want0 = _state_dict(jax_tree), _state_dict(jax_tree0)
  err_sq = ref_sq = 0.0
  for name in want:
    if name.endswith("k_proj.bias"):
      continue
    want_delta = (want[name] - want0[name]).double()
    err = float((params[name] - params0[name]).double().sub(want_delta).norm())
    ref = float(want_delta.norm())
    assert err <= BF16_DELTA_LEAF_RTOL * ref, (name, err / ref)
    err_sq, ref_sq = err_sq + err**2, ref_sq + ref**2
  assert err_sq**0.5 <= BF16_DELTA_TREE_RTOL * ref_sq**0.5, (err_sq / ref_sq)**0.5


@pytest.mark.parametrize("use_ema", [False, True])
@pytest.mark.parametrize("use_bfloat16", [False, True])
def test_three_bridged_steps_match_jax(use_bfloat16, use_ema):
  jax_model, model = _models(use_bfloat16, use_ema)
  batches = _batches(3)
  jax_state, _ = jax_train_step.create_train_state(
      jax_model, jax.random.PRNGKey(0), batches[0][0])
  state = bridge.train_state_from_jax(jax_state)
  jax_state0, state0 = jax_state, state
  jax_step = jax_train_step.make_train_step(jax_model, donate=False)
  step = train_step.make_train_step(model)
  for features, labels in batches:
    (jf, jl), (pf, pl) = _preprocess_both(jax_model, model, features, labels)
    jax_state, jax_metrics = jax_step(jax_state, jf, jl)
    state, metrics = step(state, pf, pl)
    assert set(metrics) == set(jax_metrics) == {"loss", "mse",
                                                "global_gradient_norm"}
    for key in metrics:
      want, got = float(jax_metrics[key]), float(metrics[key])
      if use_bfloat16:
        assert abs(got - want) <= BF16_RTOL * abs(want), key
      else:
        assert abs(got - want) <= F32_TOL, key
  assert state.step == int(jax_state.step) == 3
  tol = 2 * LR * 3 if use_bfloat16 else PARAM_TOL
  _assert_params_close(jax_state.params, state.params, 3, tol)
  if use_bfloat16:
    _assert_updates_close(jax_state.params, state.params, jax_state0.params,
                          state0.params)
  if use_ema:
    _assert_params_close(jax_state.ema_params, state.ema_params, 3, tol)
    if use_bfloat16:
      # The EMA starts as a copy of the parameters.
      _assert_updates_close(jax_state.ema_params, state.ema_params,
                            jax_state0.params, state0.params)
  else:
    assert state.ema_params is None and jax_state.ema_params is None


def test_a_jax_run_continues_in_the_port():
  """Two JAX steps, bridged (step, params, Adam state), then two port
  steps: the same state as four JAX steps."""
  jax_model, model = _models(use_ema=True)
  batches = _batches(4, seed=1)
  jax_state, _ = jax_train_step.create_train_state(
      jax_model, jax.random.PRNGKey(1), batches[0][0])
  jax_step = jax_train_step.make_train_step(jax_model, donate=False)
  step = train_step.make_train_step(model)
  for features, labels in batches[:2]:
    jax_state, _ = jax_step(jax_state, features, labels)
  state = bridge.train_state_from_jax(jax_state)
  adam = state.opt_state[0]
  assert adam["count"] == 2 and state.step == 2
  np.testing.assert_array_equal(
      adam["mu"]["attn_0.q_proj.weight"].numpy(),
      np.asarray(jax_state.opt_state[0].mu["attn_0"]["q_proj"]["kernel"]).T)
  for features, labels in batches[2:]:
    jax_state, jax_metrics = jax_step(jax_state, features, labels)
    state, metrics = step(state, *_preprocess_both(jax_model, model, features,
                                                   labels)[1])
    assert abs(float(metrics["loss"]) - float(jax_metrics["loss"])) <= F32_TOL
  assert state.step == 4 and state.opt_state[0]["count"] == 4
  _assert_params_close(jax_state.params, state.params, 4, PARAM_TOL)
  _assert_params_close(jax_state.ema_params, state.ema_params, 4, PARAM_TOL)
  for moment in ("mu", "nu"):
    want = _state_dict(getattr(jax_state.opt_state[0], moment))
    for name, value in want.items():
      np.testing.assert_allclose(state.opt_state[0][moment][name].numpy(),
                                 value.numpy(), atol=1e-6, rtol=1e-3,
                                 err_msg=f"{moment} {name}")


def test_train_loop_is_k_train_steps():
  _, model = _models(use_ema=True)
  batches = _batches(3, seed=2)
  pre = [model.preprocessor.preprocess(
      {k: torch.from_numpy(v) for k, v in f.items()},
      {k: torch.from_numpy(v) for k, v in l.items()}, "train")
         for f, l in batches]
  state = train_step.create_train_state(
      model, torch.Generator().manual_seed(0), torch.device("cpu"))
  step = train_step.make_train_step(model)
  stepped, losses = state, []
  for features, labels in pre:
    stepped, metrics = step(stepped, features, labels)
    losses.append(float(metrics["loss"]))
  loop = train_step.make_train_loop(model, 3)
  stack = lambda part: {  # noqa: E731
      k: torch.stack([b[part][k] for b in pre]) for k in pre[0][part]}
  looped, stacked = loop(state, stack(0), stack(1))
  assert looped.step == stepped.step == 3
  assert stacked["loss"].shape == (3,)
  np.testing.assert_array_equal(stacked["loss"].numpy(), losses)
  for name in state.params:
    torch.testing.assert_close(looped.params[name], stepped.params[name],
                               atol=0, rtol=0)
    torch.testing.assert_close(looped.ema_params[name],
                               stepped.ema_params[name], atol=0, rtol=0)
  with pytest.raises(ValueError, match="num_steps"):
    train_step.make_train_loop(model, 0)


def test_step_leaves_its_input_state_and_starts_ema_as_a_copy():
  _, model = _models(use_ema=True)
  state = train_step.create_train_state(
      model, torch.Generator().manual_seed(0), torch.device("cpu"))
  for name, value in state.params.items():
    assert state.ema_params[name].data_ptr() != value.data_ptr()
  before = {k: v.clone() for k, v in state.params.items()}
  (features, labels), = _batches(1)
  features, labels = model.preprocessor.preprocess(
      {k: torch.from_numpy(v) for k, v in features.items()},
      {k: torch.from_numpy(v) for k, v in labels.items()}, "train")
  new_state, _ = train_step.make_train_step(model)(state, features, labels)
  assert state.step == 0 and new_state.step == 1
  for name, value in state.params.items():
    assert torch.equal(value, before[name])
    assert not torch.equal(new_state.params[name], value) or name.endswith(
        "k_proj.bias")


def test_custom_optimizer_fn_and_unported_knobs():
  from tensor2robot_tpu_torch.models import optimizers

  model = sequence_model.SequenceRegressionModel(
      optimizer_fn=lambda: optimizers.create_sgd_optimizer(0.5), **WIDTHS)
  state = train_step.create_train_state(
      model, torch.Generator().manual_seed(0), torch.device("cpu"))
  assert state.opt_state == ({}, {})  # identity, then a constant scale
  # The knobs of the JAX model are ported (tests/test_torch_remat.py and
  # tests/test_torch_accumulation.py hold their steps against JAX's).
  remat = sequence_model.SequenceRegressionModel(remat=True, **WIDTHS)
  assert remat.remat and remat.gradient_accumulation_steps == 1
  accumulating = sequence_model.SequenceRegressionModel(
      optimizer_fn=lambda: optimizers.create_sgd_optimizer(0.5),
      gradient_accumulation_steps=2, **WIDTHS)
  assert not accumulating.remat
  assert accumulating.gradient_accumulation_steps == 2
  opt_state = train_step.create_train_state(
      accumulating, torch.Generator().manual_seed(0),
      torch.device("cpu")).opt_state
  assert (opt_state["mini_step"], opt_state["gradient_step"],
          opt_state["inner_opt_state"], opt_state["skip_state"]) == (
              0, 0, ({}, {}), {})
  assert set(opt_state["acc_grads"]) == set(state.params)
  with pytest.raises(ValueError, match="gradient_accumulation_steps"):
    sequence_model.SequenceRegressionModel(gradient_accumulation_steps=0,
                                           **WIDTHS)


def test_bridge_refuses_what_it_does_not_know():
  class Unknown(tuple):
    _fields = ("hessian",)
    hessian = None

  with pytest.raises(ValueError, match="hessian"):
    bridge.optimizer_state_from_optax(Unknown())
  with pytest.raises(ValueError, match="no bridge"):
    bridge.optimizer_state_from_optax(3.0)


def test_loss_and_eval_scalars_match_jax():
  """`model_train_fn` (MSE, reported as 'mse') and `model_eval_fn` (the
  train loss and its scalars) on the same outputs and labels, f32 1e-6."""
  jax_model, model = _models()
  rs = np.random.RandomState(5)
  t, act = WIDTHS["sequence_length"], WIDTHS["action_size"]
  outputs, labels = (rs.randn(2, t, act).astype(np.float32) for _ in range(2))
  want = jax_model.model_eval_fn({}, {"action": labels}, {"action": outputs})
  got = model.model_eval_fn({}, {"action": torch.from_numpy(labels)},
                            {"action": torch.from_numpy(outputs)})
  assert set(got) == set(want) == {"loss", "mse"}
  for key, value in want.items():
    np.testing.assert_allclose(float(got[key]), float(value), atol=1e-6,
                               rtol=0)
