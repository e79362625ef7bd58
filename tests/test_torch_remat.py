"""Rematerialisation (`remat=True`) in the port against the JAX package
and against the port's own step without it, on the CPU.

* The QT-Opt critic (Grasping44 at the tests' width, f32, batch 2) from a
  JAX state carried across by `bridge.py`: one remat step against the
  JAX remat step (`jax.checkpoint`), held as `test_torch_qtopt_train.py`
  holds the plain step (loss 1e-5 relative, parameters, EMA and the
  momentum trace 1e-6 absolute, batch statistics per leaf).
* The same step with and without remat in the port: the loss, the
  gradients, the new batch statistics (batch norm returns them and
  writes no buffer, so the recompute cannot update them twice) and the
  new state are bit-identical on the CPU.
* The sequence policy at test widths (flash backend: the plain version on
  the CPU), remat against the JAX remat step: loss 1e-5, parameters 1e-6
  absolute (`k_proj.bias` 2 lr, as `test_torch_train_step.py`).
"""

import functools

import jax
import pytest
import torch

from tensor2robot_tpu.models import sequence_model as jax_sequence_model
from tensor2robot_tpu.parallel import train_step as jax_train_step
from tensor2robot_tpu_torch import bridge
from tensor2robot_tpu_torch.models import sequence_model
from tensor2robot_tpu_torch.parallel import train_step
from tests import test_torch_qtopt_train as qt
from tests import test_torch_train_step as st

# The port's tests run in the same worker processes as the JAX suite;
# one torch thread keeps torch from starting its OpenMP and MKL thread
# pools beside XLA's CPU threads.
torch.set_num_threads(1)


@functools.lru_cache(maxsize=None)
def _jax_remat_run():
  jax_model, model = qt._models(remat=True)
  assert jax_model.remat and model.remat
  features, labels = qt._batch(model)
  initial = jax.jit(lambda rng, f: jax_train_step.create_train_state(
      jax_model, rng, f)[0])(jax.random.PRNGKey(0), features)
  stepped, metrics = jax_train_step.make_train_step(
      jax_model, donate=False)(initial, features, labels)
  return features, labels, initial, stepped, metrics


def test_remat_step_matches_jax():
  features, labels, initial, jax_state, jax_metrics = _jax_remat_run()
  _, model = qt._models(remat=True)
  state = bridge.train_state_from_jax(initial)
  new_state, metrics = train_step.make_train_step(model)(
      state, qt._torch(features), qt._torch(labels))
  assert set(metrics) == set(jax_metrics)
  for key in metrics:
    assert qt._rel(float(metrics[key]), float(jax_metrics[key])) \
        <= qt.LOSS_RTOL, key
  qt._assert_close(new_state.params, qt._state_dict(jax_state.params),
                   qt.PARAM_ATOL)
  qt._assert_close(new_state.ema_params, qt._state_dict(jax_state.ema_params),
                   qt.PARAM_ATOL)
  qt._assert_close(new_state.opt_state[1][0]["trace"],
                   qt._state_dict(jax_state.opt_state[1][0].trace),
                   qt.PARAM_ATOL)
  qt._assert_stats_close(new_state.mutable_state, jax_state.mutable_state)


def test_remat_step_equals_the_plain_step():
  features, labels, initial, _, _ = _jax_remat_run()
  state = bridge.train_state_from_jax(initial)
  features, labels = qt._torch(features), qt._torch(labels)
  results = {}
  for remat in (False, True):
    _, model = qt._models(remat=remat)
    results[remat] = (
        train_step.loss_and_grads(model, state.params, features, labels,
                                  state.mutable_state),
        train_step.make_train_step(model)(state, features, labels))
  (loss, scalars, grads, stats), (stepped, metrics) = results[True]
  (loss0, scalars0, grads0, stats0), (stepped0, metrics0) = results[False]
  assert torch.equal(loss, loss0)
  assert scalars.keys() == scalars0.keys()
  for tree, tree0 in ((grads, grads0), (stats, stats0),
                      (stepped.params, stepped0.params),
                      (stepped.ema_params, stepped0.ema_params),
                      (stepped.mutable_state, stepped0.mutable_state),
                      (metrics, metrics0)):
    assert tree.keys() == tree0.keys()
    for key in tree0:
      assert torch.equal(tree[key], tree0[key]), key


@pytest.mark.parametrize("use_ema", [False, True])
def test_sequence_remat_step_matches_jax(use_ema):
  kwargs = dict(use_ema=use_ema, ema_decay=0.9, remat=True, **st.WIDTHS)
  jax_model = jax_sequence_model.SequenceRegressionModel(device_type="cpu",
                                                         **kwargs)
  model = sequence_model.SequenceRegressionModel(**kwargs)
  (features, labels), = st._batches(1, seed=3)
  jax_state, _ = jax_train_step.create_train_state(
      jax_model, jax.random.PRNGKey(0), features)
  state = bridge.train_state_from_jax(jax_state)
  (jf, jl), (pf, pl) = st._preprocess_both(jax_model, model, features, labels)
  jax_state, jax_metrics = jax_train_step.make_train_step(
      jax_model, donate=False)(jax_state, jf, jl)
  state, metrics = train_step.make_train_step(model)(state, pf, pl)
  for key in metrics:
    assert abs(float(metrics[key]) - float(jax_metrics[key])) \
        <= st.F32_TOL, key
  st._assert_params_close(jax_state.params, state.params, 1, st.PARAM_TOL)
  if use_ema:
    st._assert_params_close(jax_state.ema_params, state.ema_params, 1,
                            st.PARAM_TOL)
