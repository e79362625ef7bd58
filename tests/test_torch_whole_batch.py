"""Ratios over the batch on a data split, against the JAX package's
global batch.

On a mesh the port's step and eval step run each data rank's block of
the batch, where JAX's jitted step reads the global batch. A mean over
rows agrees either way; a ratio of sums does not. The pose regression's
success-weighted MSE (sum(w·e) / sum(w)) and the binary classification
head's precision and recall gather what they sum over the batch group
(`collectives.all_gather_batch`), as BC-Z and Grasp2Vec do. A 2-rank
gloo world runs each rank's block (tests/test_torch_mesh_world.py); the
blocks differ in success count and in positives, so a per-block ratio
misses the global one by far more than the tolerance.

Tolerances: 1e-6 relative on the losses and metrics, 1e-6 absolute on
the gradient (f32 sums of eight rows in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest

from tensor2robot_tpu.models import heads as jax_heads
from tensor2robot_tpu.research.pose_env import models as jax_pose_models
from tests import test_torch_mesh_world as torch_mesh_world

TOL = 1e-6


def _payload():
  rs = np.random.RandomState(0)
  # Rank 0's rows: 3 of 4 successes; rank 1's: 1 of 4.
  reward = np.array([[0.0], [-0.1], [0.0], [-0.9],
                     [-0.8], [-0.7], [-0.05], [-0.6]], np.float32)
  # Rank 0 predicts mostly positive, rank 1 mostly negative.
  logits = np.array([[2.0], [1.5], [-0.3], [0.7],
                     [-1.2], [-2.0], [0.4], [-0.8]], np.float32)
  labels = np.array([[1.0], [0.0], [1.0], [1.0],
                     [1.0], [0.0], [0.0], [1.0]], np.float32)
  return {"predicted": rs.randn(8, 2).astype(np.float32),
          "target": rs.randn(8, 2).astype(np.float32),
          "reward": reward, "logits": logits, "labels": labels}


class _JaxClassifier(jax_heads.ClassificationModel):
  """The classification head alone (no network)."""


# Only the head's loss and metrics run: no network, no specs.
_JaxClassifier.__abstractmethods__ = frozenset()


def _jax_global(payload):
  import jax

  model = jax_pose_models.PoseEnvRegressionModel()

  def loss_fn(predicted):
    loss, scalars = model.model_train_fn(
        {}, {"target_pose": jnp.asarray(payload["target"]),
             "reward": jnp.asarray(payload["reward"])},
        {"inference_output": predicted}, "train")
    return loss, scalars

  (loss, scalars), grad = jax.value_and_grad(loss_fn, has_aux=True)(
      jnp.asarray(payload["predicted"]))
  metrics = _JaxClassifier(num_classes=1).model_eval_fn(
      {}, {"class": jnp.asarray(payload["labels"])},
      {"logits": jnp.asarray(payload["logits"])})
  return ({"loss": float(loss),
           "success_fraction": float(scalars["success_fraction"]),
           "grad": np.asarray(grad)},
          {k: float(v) for k, v in metrics.items()})


@pytest.fixture(scope="module")
def world(tmp_path_factory):
  payload = _payload()
  ranks = torch_mesh_world.run_world(
      2, "tests.test_torch_whole_batch_cases:whole_batch_ratios", payload,
      tmp_path_factory.mktemp("whole_batch"))
  return payload, ranks


def test_blocks_differ_from_the_global_batch():
  """The data is chosen so that each block's own ratio is far from the
  global one: a per-block computation cannot pass the tests below."""
  payload = _payload()
  pose, head = _jax_global(payload)
  for block in (slice(0, 4), slice(4, 8)):
    part = {k: v[block] for k, v in payload.items()}
    pose_b, head_b = _jax_global(part)
    assert abs(pose_b["loss"] - pose["loss"]) > 100 * TOL * pose["loss"]
    assert abs(head_b["precision"] - head["precision"]) > 0.05
    assert abs(head_b["recall"] - head["recall"]) > 0.05


def test_pose_success_weighted_loss_is_the_global_batch(world):
  payload, ranks = world
  want, _ = _jax_global(payload)
  for rank, result in enumerate(ranks):
    got = result["pose"]
    assert got["loss"] == pytest.approx(want["loss"], rel=TOL)
    assert got["success_fraction"] == pytest.approx(
        want["success_fraction"], rel=TOL)
    # Each rank's gradient is its rows' share of the global loss's.
    np.testing.assert_allclose(got["grad"],
                               want["grad"][rank * 4:(rank + 1) * 4],
                               atol=TOL, rtol=0)


def test_head_precision_and_recall_are_the_global_batch(world):
  payload, ranks = world
  _, want = _jax_global(payload)
  for result in ranks:
    for key in ("precision", "recall", "accuracy", "mse"):
      assert result["head"][key] == pytest.approx(want[key], rel=TOL), key
  # The loss is a mean over rows: the mean of the blocks' (the eval
  # step's mean over ranks) is the global one.
  assert np.mean([r["head"]["loss"] for r in ranks]) == pytest.approx(
      want["loss"], rel=TOL)
