"""The port's cross-entropy method against the JAX package's, on the CPU.

* `CrossEntropyMethod` (numpy) is bit-identical to the JAX package's on
  the same seed and objective: best action, best score, `final_mean_`
  and `final_stddev_`.
* `cross_entropy_method` (torch) takes the JAX function's normals as
  `draws`, rebuilt here by the same `jax.random.split` sequence; best
  action, best score and final mean agree with the JAX function on the
  same key to 1e-6 (float32: the two sum the elites in other orders).
* Ties: on an objective with many equal scores the port picks the elites
  `jax.lax.top_k` picks (the lower index first), iteration by iteration.
* `num_elites < 2` raises in both, and the draws' shape is checked.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensor2robot_tpu.ops import cem as jax_cem
from tensor2robot_tpu_torch.ops import cem

# The port's tests run in the same worker processes as the JAX suite;
# one torch thread keeps torch from starting its OpenMP and MKL thread
# pools beside XLA's CPU threads.
torch.set_num_threads(1)

ATOL = 1e-6
TARGET = np.array([0.3, -0.5, 0.8, 0.1], np.float32)


def _jax_draws(key, num_iterations, num_samples, action_dim):
  """The normals `jax_cem.cross_entropy_method` draws from `key`."""
  draws = []
  for _ in range(num_iterations):
    key, sample_key = jax.random.split(key)
    draws.append(np.asarray(jax.random.normal(
        sample_key, (num_samples, action_dim))))
  return np.stack(draws)


def _quadratic_np(actions):
  return -np.sum((actions - TARGET) ** 2, axis=-1)


def _tied_np(actions):
  # Few distinct levels: most of 64 scores tie with others.
  return np.floor(actions[:, 0] * 2.0)


@pytest.mark.parametrize("seed", [0, 1, 7])
@pytest.mark.parametrize("objective", [_quadratic_np, _tied_np])
def test_numpy_cem_is_bit_identical_to_jax(seed, objective):
  kwargs = dict(num_samples=64, num_iterations=3, num_elites=10, seed=seed)
  mean, stddev = np.zeros(4, np.float32), np.ones(4, np.float32)
  low, high = -np.ones(4, np.float32), np.ones(4, np.float32)
  want = jax_cem.CrossEntropyMethod(**kwargs)
  got = cem.CrossEntropyMethod(**kwargs)
  want_action, want_score = want.optimize(objective, mean, stddev, low, high)
  got_action, got_score = got.optimize(objective, mean, stddev, low, high)
  np.testing.assert_array_equal(got_action, want_action)
  assert got_score == want_score
  np.testing.assert_array_equal(got.final_mean_, want.final_mean_)
  np.testing.assert_array_equal(got.final_stddev_, want.final_stddev_)


def _run_both(seed, jax_objective, torch_objective, num_samples=64,
              num_iterations=3, num_elites=10, action_dim=4):
  key = jax.random.PRNGKey(seed)
  mean = np.zeros(action_dim, np.float32)
  stddev = np.ones(action_dim, np.float32)
  low, high = -np.ones(action_dim, np.float32), np.ones(action_dim,
                                                          np.float32)
  want = jax.jit(lambda k: jax_cem.cross_entropy_method(
      k, jax_objective, jnp.asarray(mean), jnp.asarray(stddev),
      num_samples=num_samples, num_iterations=num_iterations,
      num_elites=num_elites, low=jnp.asarray(low),
      high=jnp.asarray(high)))(key)
  history = []
  got = cem.cross_entropy_method(
      torch_objective, torch.from_numpy(mean), torch.from_numpy(stddev),
      num_samples=num_samples, num_iterations=num_iterations,
      num_elites=num_elites, low=torch.from_numpy(low),
      high=torch.from_numpy(high),
      draws=torch.from_numpy(_jax_draws(key, num_iterations, num_samples,
                                        action_dim)),
      history=history)
  return [np.asarray(w) for w in want], [g.numpy() for g in got], history


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_torch_cem_matches_jax_on_its_draws(seed):
  target = jnp.asarray(TARGET)
  want, got, history = _run_both(
      seed, lambda a: -jnp.sum((a - target) ** 2, axis=-1),
      lambda a: -torch.sum((a - torch.from_numpy(TARGET)) ** 2, dim=-1))
  for name, w, g in zip(("best_action", "best_score", "final_mean"), want,
                        got):
    np.testing.assert_allclose(g, w, rtol=0, atol=ATOL, err_msg=name)
  assert len(history) == 3
  assert np.all(np.abs(got[0]) <= 1.0)


def test_ties_pick_the_elites_top_k_picks():
  """Scores floor(2 x) over 64 samples: six levels, so the 10 elites cut
  through a tie. The port's elites, iteration by iteration, are
  `jax.lax.top_k`'s on the same scores, and the final mean agrees."""
  seen = []

  def torch_objective(actions):
    scores = torch.floor(actions[:, 0] * 2.0)
    seen.append(scores.numpy().copy())
    return scores

  want, got, history = _run_both(
      3, lambda a: jnp.floor(a[:, 0] * 2.0), torch_objective)
  ties = 0
  for scores, step in zip(seen, history):
    want_idx = np.asarray(jax.lax.top_k(jnp.asarray(scores), 10)[1])
    np.testing.assert_array_equal(step["elite_idx"].numpy(), want_idx)
    ties += int(np.sum(scores == scores[want_idx[-1]]) > np.sum(
        scores[want_idx] == scores[want_idx[-1]]))
  assert ties >= 1, "no iteration cut through a tie"
  for name, w, g in zip(("best_action", "best_score", "final_mean"), want,
                        got):
    np.testing.assert_allclose(g, w, rtol=0, atol=ATOL, err_msg=name)


def test_one_elite_raises():
  with pytest.raises(ValueError, match="num_elites must be >= 2"):
    cem.cross_entropy_method(lambda a: a.sum(-1), torch.zeros(2),
                             torch.ones(2), num_elites=1)
  with pytest.raises(ValueError, match="num_elites must be >= 2"):
    cem.CrossEntropyMethod(num_elites=1)
  with pytest.raises(ValueError, match="num_elites must be <= num_samples"):
    cem.CrossEntropyMethod(num_samples=4, num_elites=5)


def test_draws_shape_is_checked():
  with pytest.raises(ValueError, match="draws must have shape"):
    cem.cross_entropy_method(lambda a: a.sum(-1), torch.zeros(2),
                             torch.ones(2), num_samples=8, num_iterations=2,
                             num_elites=2, draws=torch.zeros(2, 8, 3))


def test_generator_draws_are_reproducible():
  def run(seed):
    generator = torch.Generator().manual_seed(seed)
    return cem.cross_entropy_method(
        lambda a: -torch.sum(a ** 2, -1), torch.zeros(3), torch.ones(3),
        generator=generator)[0]

  assert torch.equal(run(5), run(5))
  assert not torch.equal(run(5), run(6))
