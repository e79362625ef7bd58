"""The last helpers in the port against the JAX package, on the CPU.

`ops/rotations.py`: every function on random float64 inputs (1e-12 of
max(1, max |ref|)), and `torch.autograd.grad` against `jax.grad` at the
boundary points: the zero axis-angle (the double where), quaternions
with w < 0 and near and at the identity, identical quaternions in the
geodesic distance (NaN where JAX's is NaN, equal elsewhere), and the
clip's even split of a tie. `utils/subsample.py`: the index functions
equal on the same `RandomState`, `gather_subsequence` equal to
`jnp.take`. `utils/test_fixture.py` driving a port model through
`random_train`, `random_predict` and the golden check.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensor2robot_tpu.ops import rotations as jax_rotations
from tensor2robot_tpu.utils import subsample as jax_subsample
from tensor2robot_tpu_torch.ops import rotations
from tensor2robot_tpu_torch.research.vrgripper import models
from tensor2robot_tpu_torch.utils import subsample
from tensor2robot_tpu_torch.utils import test_fixture

torch.set_num_threads(1)

TOL = 1e-12


def _jax_and_port(name, *args):
  """(JAX value, port value, JAX grads, port grads) of the summed output,
  float64, by argument."""
  with jax.enable_x64(True):
    fn = getattr(jax_rotations, name)
    jargs = [jnp.asarray(a) for a in args]
    want = np.asarray(fn(*jargs))
    want_grads = [np.asarray(g) for g in jax.grad(
        lambda *a: fn(*a).sum(), argnums=tuple(range(len(args))))(*jargs)]
  targs = [torch.tensor(a, requires_grad=True) for a in args]
  got = getattr(rotations, name)(*targs)
  grads = torch.autograd.grad(got.sum(), targs)
  return want, got.detach().numpy(), want_grads, [g.numpy() for g in grads]


def _close(got, want, tol=TOL):
  np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
  ok = ~np.isnan(want)
  scale = max(1.0, np.abs(want[ok]).max()) if ok.any() else 1.0
  assert np.abs(got[ok] - want[ok]).max(initial=0.0) / scale <= tol


RANDOM = {
    "quaternion_normalize": (4,),
    "quaternion_multiply": (4, 4),
    "quaternion_conjugate": (4,),
    "quaternion_rotate": (4, 3),
    "quaternion_to_axis_angle": (4,),
    "axis_angle_to_quaternion": (3,),
    "quaternion_to_rotation_matrix": (4,),
    "geodesic_distance": (4, 4),
}


@pytest.mark.parametrize("name", sorted(RANDOM))
def test_rotations_on_random_inputs(name):
  rng = np.random.RandomState(len(name))
  args = [rng.randn(5, width) for width in RANDOM[name]]
  want, got, want_grads, grads = _jax_and_port(name, *args)
  _close(got, want)
  for g, w in zip(grads, want_grads):
    _close(g, w, 1e-10)


BOUNDARIES = {
    "axis_angle_zero": ("axis_angle_to_quaternion", [[0.0, 0.0, 0.0]]),
    "axis_angle_tiny": ("axis_angle_to_quaternion", [[1e-7, -2e-7, 0.0]]),
    "to_axis_angle_identity": ("quaternion_to_axis_angle",
                               [[1.0, 0.0, 0.0, 0.0]]),
    "to_axis_angle_near_identity": ("quaternion_to_axis_angle",
                                    [[1.0, 1e-7, 0.0, 0.0]]),
    "to_axis_angle_w_negative": ("quaternion_to_axis_angle",
                                 [[-0.5, 0.5, 0.5, 0.5]]),
    "to_axis_angle_half_turn": ("quaternion_to_axis_angle",
                                [[0.0, 1.0, 0.0, 0.0]]),
}


@pytest.mark.parametrize("case", sorted(BOUNDARIES))
def test_rotation_gradients_at_boundaries(case):
  name, value = BOUNDARIES[case]
  want, got, want_grads, grads = _jax_and_port(name, np.asarray(value))
  _close(got, want)
  _close(grads[0], want_grads[0], 1e-10)


@pytest.mark.parametrize("same", [[1.0, 0.0, 0.0, 0.0],
                                  [0.5, 0.5, 0.5, 0.5]])
def test_geodesic_distance_at_identical_quaternions(same):
  q = np.asarray([same])
  want, got, want_grads, grads = _jax_and_port("geodesic_distance", q,
                                               q.copy())
  _close(got, want)
  for g, w in zip(grads, want_grads):  # NaN in both: arccos' at 1
    _close(g, w)


@pytest.mark.parametrize("x", [-0.5, 0.0, 0.3, 1.0, 1.5])
def test_clip_splits_a_tie_as_jax_does(x):
  with jax.enable_x64(True):
    want = float(jax.grad(lambda v: jnp.clip(v, 0.0, 1.0))(x))
  t = torch.tensor(x, dtype=torch.float64, requires_grad=True)
  (got,) = torch.autograd.grad(rotations._clip(t, 0.0, 1.0), t)
  assert float(got) == want
  if x in (0.0, 1.0):
    assert want == 0.5  # where torch.clamp would pass 1


# -- subsample -------------------------------------------------------------------


@pytest.mark.parametrize("length,samples", [(10, 4), (3, 5), (1, 1), (7, 7),
                                            (40, 8)])
def test_subsample_indices_equal_jax(length, samples):
  np.testing.assert_array_equal(
      subsample.uniform_indices(length, samples),
      jax_subsample.uniform_indices(length, samples))
  for fn in ("random_indices", "pinned_random_indices",
             "boundary_segment_indices"):
    got = getattr(subsample, fn)(length, samples, np.random.RandomState(3))
    want = getattr(jax_subsample, fn)(length, samples,
                                      np.random.RandomState(3))
    assert got.dtype == want.dtype == np.int64
    np.testing.assert_array_equal(got, want)
  with pytest.raises(ValueError):
    subsample.pinned_random_indices(length, 0)


def test_gather_subsequence_equals_jnp_take():
  sequence = np.random.RandomState(0).randn(9, 2, 3).astype(np.float32)
  idx = subsample.pinned_random_indices(9, 4, np.random.RandomState(1))
  want = np.asarray(jax_subsample.gather_subsequence(jnp.asarray(sequence),
                                                     jnp.asarray(idx)))
  got = subsample.gather_subsequence(torch.from_numpy(sequence), idx)
  np.testing.assert_array_equal(got.numpy(), want)


# -- test_fixture ----------------------------------------------------------------


def test_fixture_drives_a_port_model(tmp_path):
  def model():
    return models.VRGripperRegressionModel(episode_length=2, image_size=12,
                                           num_mixture_components=2)

  fixture = test_fixture.T2RModelFixture(str(tmp_path / "run"),
                                         batch_size=2, device="cpu")
  metrics = fixture.random_train(model(), max_train_steps=2)
  assert np.isfinite(metrics["loss"]) and "nll" in metrics
  outputs = fixture.random_predict(model())
  assert outputs[0]["mdn_params/logits"].shape == (2, 2, 2)
  golden = str(tmp_path / "golden.npy")
  test_fixture.T2RModelFixture(
      str(tmp_path / "a"), batch_size=2,
      device="cpu").train_and_check_golden_predictions(model(), golden)
  test_fixture.T2RModelFixture(
      str(tmp_path / "b"), batch_size=2,
      device="cpu").train_and_check_golden_predictions(model(), golden,
                                                       require=True)
  with pytest.raises(FileNotFoundError):
    test_fixture.T2RModelFixture(
        str(tmp_path / "c"), batch_size=2,
        device="cpu").train_and_check_golden_predictions(
            model(), str(tmp_path / "missing.npy"), require=True)
  with pytest.raises(AssertionError, match="no checkpoint"):
    test_fixture.assert_output_files(str(tmp_path / "nothing"))
