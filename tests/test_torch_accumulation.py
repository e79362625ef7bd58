"""Gradient accumulation (`gradient_accumulation_steps=k`, the port's
`multi_steps` for optax.MultiSteps) against the JAX package, on the CPU.

* The QT-Opt critic (Grasping44 at the tests' width, f32, batch 2, the
  masked weight decay and the exponential-decay momentum inside) from a
  JAX state carried across by `bridge.py`, k = 3 micro-steps on three
  batches: after each, the port's state against the JAX `MultiSteps`
  state: `mini_step`, `gradient_step` and the inner schedule count
  exactly; `acc_grads`, parameters, EMA and the momentum trace 1e-6
  absolute (as `test_torch_qtopt_train.py`); the EMA and the parameters
  move only on the applied step; loss 1e-5 relative, and
  `global_gradient_norm` is the micro-batch's.
* k steps at batch B against one step at batch kB, on the sequence model
  at test widths (no batch norm, whose statistics over B rows are not
  those over kB rows) with momentum at 1e-2 (linear in the gradient, as
  the equivalence needs: Adam would normalise the rounding noise of the
  `k_proj.bias` gradient, which the softmax cancels, to a step of lr):
  parameters, EMA and the momentum trace 1e-6 absolute.
* A checkpoint written mid-accumulation (step 4 of k = 3) restores and
  continues bit for bit like the uninterrupted run.
* `multi_steps` alone: the mean, zeros between applied updates, and the
  inner state frozen in between.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from tensor2robot_tpu.parallel import train_step as jax_train_step
from tensor2robot_tpu_torch import bridge
from tensor2robot_tpu_torch import checkpoints
from tensor2robot_tpu_torch.models import optimizers
from tensor2robot_tpu_torch.models import sequence_model
from tensor2robot_tpu_torch.parallel import train_step
from tests import test_torch_qtopt_train as qt

# The port's tests run in the same worker processes as the JAX suite;
# one torch thread keeps torch from starting its OpenMP and MKL thread
# pools beside XLA's CPU threads.
torch.set_num_threads(1)

K = 3
SEQ_WIDTHS = dict(obs_size=4, action_size=2, hidden_size=16, num_blocks=1,
                  num_heads=2, sequence_length=8)


@functools.lru_cache(maxsize=None)
def _jax_run():
  """The bridged initial state, K JAX states and metrics, the batches."""
  jax_model, _ = qt._models(gradient_accumulation_steps=K)
  batches = [qt._batch(jax_model, seed=2 * i) for i in range(K)]
  state = jax.jit(lambda rng, f: jax_train_step.create_train_state(
      jax_model, rng, f)[0])(jax.random.PRNGKey(0), batches[0][0])
  initial = state
  step = jax_train_step.make_train_step(jax_model, donate=False)
  history = []
  for features, labels in batches:
    state, metrics = step(state, features, labels)
    history.append((state, metrics))
  return initial, history, batches


def test_k_steps_match_jax_multi_steps():
  initial, history, batches = _jax_run()
  _, model = qt._models(gradient_accumulation_steps=K)
  state = bridge.train_state_from_jax(initial)
  assert state.opt_state["mini_step"] == 0
  assert state.opt_state["skip_state"] == {}
  params0 = {k: v.clone() for k, v in state.params.items()}
  step = train_step.make_train_step(model)
  for i, ((features, labels), (jax_state, jax_metrics)) in enumerate(
      zip(batches, history)):
    state, metrics = step(state, qt._torch(features), qt._torch(labels))
    for key in metrics:
      assert qt._rel(float(metrics[key]), float(jax_metrics[key])) \
          <= qt.LOSS_RTOL, key
    want = bridge.train_state_from_jax(jax_state)
    got_opt, want_opt = state.opt_state, want.opt_state
    assert (got_opt["mini_step"], got_opt["gradient_step"]) == (
        want_opt["mini_step"], want_opt["gradient_step"]) == (
            (i + 1) % K, (i + 1) // K)
    assert got_opt["inner_opt_state"][1][1] == want_opt[
        "inner_opt_state"][1][1] == {"count": (i + 1) // K}
    qt._assert_close(got_opt["acc_grads"], want_opt["acc_grads"],
                     qt.PARAM_ATOL)
    qt._assert_close(got_opt["inner_opt_state"][1][0]["trace"],
                     want_opt["inner_opt_state"][1][0]["trace"],
                     qt.PARAM_ATOL)
    qt._assert_close(state.params, want.params, qt.PARAM_ATOL)
    qt._assert_close(state.ema_params, want.ema_params, qt.PARAM_ATOL)
    qt._assert_stats_close(state.mutable_state, jax_state.mutable_state)
    if i < K - 1:  # nothing applied yet: parameters and EMA as they were
      assert all(torch.equal(state.params[k], v) for k, v in params0.items())
      assert all(torch.equal(state.ema_params[k], v)
                 for k, v in params0.items())
  assert not all(torch.equal(state.params[k], v) for k, v in params0.items())
  assert all(not v.any() for v in state.opt_state["acc_grads"].values())


def _seq_model(k, optimizer_fn=None):
  return sequence_model.SequenceRegressionModel(
      gradient_accumulation_steps=k, use_ema=True, ema_decay=0.5,
      optimizer_fn=optimizer_fn, **SEQ_WIDTHS)


def _seq_batch(rows, seed):
  rs = np.random.RandomState(seed)
  t = SEQ_WIDTHS["sequence_length"]
  return ({"observation": torch.from_numpy(
      rs.randn(rows, t, SEQ_WIDTHS["obs_size"]).astype(np.float32))},
          {"action": torch.from_numpy(
              rs.randn(rows, t, SEQ_WIDTHS["action_size"]).astype(
                  np.float32))})


def test_k_steps_at_b_train_like_one_step_at_kb():
  big_features, big_labels = _seq_batch(2 * K, seed=4)
  momentum = lambda: optimizers.create_momentum_optimizer(1e-2)  # noqa: E731
  accumulating, plain = _seq_model(K, momentum), _seq_model(1, momentum)
  state = train_step.create_train_state(
      accumulating, torch.Generator().manual_seed(0), torch.device("cpu"))
  one = train_step.init_train_state(
      plain, {k: v.clone() for k, v in state.params.items()})
  step = train_step.make_train_step(accumulating)
  for i in range(K):
    rows = slice(2 * i, 2 * i + 2)
    state, metrics = step(state, {"observation":
                                  big_features["observation"][rows]},
                          {"action": big_labels["action"][rows]})
  one, _ = train_step.make_train_step(plain)(one, big_features, big_labels)
  assert state.step == K and one.step == 1
  inner = state.opt_state["inner_opt_state"]
  assert state.opt_state["gradient_step"] == 1
  for name in state.params:
    for got, want in ((state.params, one.params),
                      (state.ema_params, one.ema_params),
                      (inner[0]["trace"], one.opt_state[0]["trace"])):
      torch.testing.assert_close(got[name], want[name], atol=1e-6, rtol=0)


def test_mid_accumulation_checkpoint_resumes_exactly(tmp_path):
  model = _seq_model(K)
  batches = [_seq_batch(2, seed=10 + i) for i in range(6)]
  step = train_step.make_train_step(model)
  state = train_step.create_train_state(
      model, torch.Generator().manual_seed(1), torch.device("cpu"))
  straight = state
  for features, labels in batches:
    straight, _ = step(straight, features, labels)
  for features, labels in batches[:4]:
    state, _ = step(state, features, labels)
  assert state.opt_state["mini_step"] == 1  # mid-accumulation
  manager = checkpoints.CheckpointManager(str(tmp_path))
  manager.save(4, state)
  manager.wait_until_finished()
  assert manager.verify_step(4) is True
  resumed = manager.restore(4)
  assert resumed.opt_state["mini_step"] == 1
  assert resumed.opt_state["gradient_step"] == 1
  for features, labels in batches[4:]:
    resumed, _ = step(resumed, features, labels)
  assert resumed.step == straight.step == 6
  assert resumed.opt_state["mini_step"] == straight.opt_state[
      "mini_step"] == 0
  for name in ("params", "ema_params"):
    for key, value in getattr(straight, name).items():
      assert torch.equal(getattr(resumed, name)[key], value), (name, key)
  for key, value in straight.opt_state["inner_opt_state"][0]["mu"].items():
    assert torch.equal(
        resumed.opt_state["inner_opt_state"][0]["mu"][key], value), key


def test_multi_steps_alone():
  calls = []

  def inner_update(updates, state, params=None):
    calls.append({k: v.clone() for k, v in updates.items()})
    return ({k: -v for k, v in updates.items()},
            {"count": state["count"] + 1})

  tx = optimizers.multi_steps(optimizers.GradientTransformation(
      lambda params: {"count": 0}, inner_update), 2)
  params = {"w": torch.zeros(3)}
  state = tx.init(params)
  g1, g2 = torch.tensor([1.0, 2.0, 3.0]), torch.tensor([3.0, 2.0, 1.0])
  out, state = tx.update({"w": g1}, state, params)
  assert not out["w"].any() and state["inner_opt_state"] == {"count": 0}
  assert not optimizers.has_updated(state) and not calls
  out, state = tx.update({"w": g2}, state, params)
  torch.testing.assert_close(calls[0]["w"], (g1 + g2) / 2)
  torch.testing.assert_close(out["w"], -(g1 + g2) / 2)
  assert state["inner_opt_state"] == {"count": 1}
  assert (state["mini_step"], state["gradient_step"]) == (0, 1)
  assert optimizers.has_updated(state)
  assert optimizers.has_updated(({"count": 1},))
  with pytest.raises(ValueError, match="every_k"):
    optimizers.multi_steps(tx, 0)
