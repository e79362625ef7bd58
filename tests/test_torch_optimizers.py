"""The port's optimizers and schedules against the JAX package's optax
chains, on the CPU.

Every factory of `models/optimizers.py` runs 5 updates on the same
numpy parameters and gradients in both packages; the updates must agree
to 1e-6 absolute (both are f32 elementwise arithmetic in the same order;
rsqrt and pow may differ in the last bit). Schedules are compared value
by value over the counts a run reads.
"""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tensor2robot_tpu.models import optimizers as jax_optimizers
from tensor2robot_tpu_torch.models import optimizers

# The port's tests run in the same worker processes as the JAX suite;
# one torch thread keeps torch from starting its OpenMP and MKL thread
# pools beside XLA's CPU threads.
torch.set_num_threads(1)

TOL = 1e-6
HP_DECAY = dict(batch_size=1, examples_per_epoch=2, num_epochs_per_decay=1,
                learning_rate_decay_factor=0.5)


def _both(name, *args, **kwargs):
  """The same factory call on both packages; a schedule argument given as
  (factory name, args) is built in each package first."""
  def build(module):
    resolved = [getattr(module, a[0])(*a[1]) if isinstance(a, tuple) else a
                for a in args]
    return getattr(module, name)(*resolved, **kwargs)

  return build(jax_optimizers), build(optimizers)


CASES = {
    "adam": lambda: _both("create_adam_optimizer", 1e-2),
    "adam_default": lambda: _both("create_adam_optimizer"),
    "adam_clipped": lambda: _both("create_adam_optimizer", 1e-2,
                                  gradient_clip_norm=1.0),
    "adam_unclipped": lambda: _both("create_adam_optimizer", 1e-2,
                                    gradient_clip_norm=1e3),
    "sgd": lambda: _both("create_sgd_optimizer", 0.1),
    "momentum": lambda: _both("create_momentum_optimizer", 0.1),
    "nesterov": lambda: _both("create_momentum_optimizer", 0.1,
                              use_nesterov=True),
    "rmsprop": lambda: _both("create_rms_prop_optimizer", 0.1),
    "rmsprop_small_eps": lambda: _both("create_rms_prop_optimizer", 0.1,
                                       eps=1e-3),
    "adam_exponential_decay": lambda: _both(
        "create_adam_optimizer",
        ("create_exponential_decay_learning_rate", (0.1, 2, 0.5))),
    "sgd_smooth_decay": lambda: _both(
        "create_sgd_optimizer",
        ("create_exponential_decay_learning_rate", (0.1, 2, 0.5, False))),
    "sgd_piecewise": lambda: _both(
        "create_sgd_optimizer",
        ("create_piecewise_linear_learning_rate", ((0, 3), (0.1, 0.01)))),
    "sgd_constant": lambda: _both(
        "create_sgd_optimizer", ("create_constant_learning_rate", (0.3,))),
    "hparams_momentum": lambda: _both("create_optimizer_from_hparams",
                                      **HP_DECAY),
    "hparams_rmsprop": lambda: _both("create_optimizer_from_hparams",
                                     optimizer="rmsprop", **HP_DECAY),
    "hparams_adam": lambda: _both("create_optimizer_from_hparams",
                                  optimizer="adam", **HP_DECAY),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_five_updates_match_optax(case):
  jax_tx, tx = CASES[case]()
  rs = np.random.RandomState(0)
  params = {"w": rs.randn(3, 4).astype(np.float32),
            "b": rs.randn(5).astype(np.float32)}
  jax_params = {k: jnp.asarray(v) for k, v in params.items()}
  port_params = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
  jax_state, state = jax_tx.init(jax_params), tx.init(port_params)
  for _ in range(5):
    grads = {k: 3 * rs.randn(*v.shape).astype(np.float32)
             for k, v in params.items()}
    jax_updates, jax_state = jax_tx.update(
        {k: jnp.asarray(v) for k, v in grads.items()}, jax_state, jax_params)
    jax_params = optax.apply_updates(jax_params, jax_updates)
    updates, state = tx.update({k: torch.from_numpy(v) for k, v in
                                grads.items()}, state, port_params)
    port_params = optimizers.apply_updates(port_params, updates)
    for k in params:
      np.testing.assert_allclose(updates[k].numpy(),
                                 np.asarray(jax_updates[k]), atol=TOL, rtol=0)
  for k in params:
    np.testing.assert_allclose(port_params[k].numpy(),
                               np.asarray(jax_params[k]), atol=TOL, rtol=0)


@pytest.mark.parametrize("name,args", [
    ("create_constant_learning_rate", (0.25,)),
    ("create_exponential_decay_learning_rate", (0.1, 3, 0.5)),
    ("create_exponential_decay_learning_rate", (0.1, 3, 0.5, False)),
    ("create_piecewise_linear_learning_rate", ((0, 4, 8), (1.0, 0.5, 0.1))),
    ("create_piecewise_linear_learning_rate", ((2, 6), (1.0, 0.0))),
])
def test_schedules_match_optax(name, args):
  jax_schedule = getattr(jax_optimizers, name)(*args)
  schedule = getattr(optimizers, name)(*args)
  for count in range(12):
    np.testing.assert_allclose(schedule(count),
                               float(jax_schedule(jnp.int32(count))),
                               atol=1e-7, rtol=1e-6)


def test_adam_state_layout_mirrors_optax():
  """A chain's state is a tuple of per-transformation dicts named after
  optax's fields: what `bridge.optimizer_state_from_optax` produces."""
  tx = optimizers.create_adam_optimizer(
      optimizers.create_constant_learning_rate(1e-3), gradient_clip_norm=1.0)
  state = tx.init({"w": torch.zeros(2)})
  assert state[0] == {}
  adam, schedule = state[1]
  assert set(adam) == {"count", "mu", "nu"} and adam["count"] == 0
  assert schedule == {"count": 0}
  jax_state = jax_optimizers.create_adam_optimizer(
      jax_optimizers.create_constant_learning_rate(1e-3),
      gradient_clip_norm=1.0).init({"w": jnp.zeros(2)})
  assert type(jax_state[1][0]).__name__ == "ScaleByAdamState"
  assert jax_state[1][0]._fields == ("count", "mu", "nu")


def test_unknown_optimizer_and_bad_learning_rate_raise():
  with pytest.raises(ValueError, match="Unknown optimizer"):
    optimizers.create_optimizer_from_hparams(optimizer="lamb")
  with pytest.raises(ValueError, match="learning_rate"):
    optimizers.create_adam_optimizer("fast")
  with pytest.raises(ValueError, match="same length"):
    optimizers.create_piecewise_linear_learning_rate((0, 1), (1.0,))
