"""The TEC triplet loss on a data split, against the JAX package's global
batch.

`VRGripperTECModel`'s triplet term mines each anchor's semihard negative
among the batch's rows and averages over the batch's positive pairs, so
it compares rows across the batch: on a mesh the port gathers the
embeddings and task ids over the batch group
(`collectives.all_gather_batch`), as Grasp2Vec does, and every data
rank's loss is the global one. The BC term is a mean over equal blocks.
Task ids [0, 1, 2, 3, 0, 1, 2, 3] split as two 4-row blocks put no
positive pair inside a block: a per-block reading gives a triplet term
of 0.0 where the global batch's is far from it.

Two configurations reach the loss: the TEC model with a `task_id` label
(small widths), and `configs/train_wtl_maml.gin`, whose MAML outer loss
runs the TEC model's train fn over the flattened inference split of 4
tasks (2 a rank); MAML's inner loop adapts each task on its own rows.
A 2-rank gloo world runs each rank's block
(tests/test_torch_mesh_world.py) in float64, JAX under
`jax.enable_x64`.

Tolerances: 1e-6 relative on the losses and scalars, 1e-6 of
max(1, max |g|) on every gradient.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest

from tensor2robot_tpu.layers import tec as jax_tec
from tensor2robot_tpu.research.vrgripper import models as jax_models
from tensor2robot_tpu.utils import config as jax_config
from tests import test_torch_mesh_world as torch_mesh_world
from tests import torch_model_parity as parity

TOL = 1e-6
REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TASK_IDS = np.array([0, 1, 2, 3, 0, 1, 2, 3], np.int64)
TEC = dict(demo_length=5, obs_size=6, action_size=3, embedding_size=8)


def _tec_case():
  rng = np.random.RandomState(7)
  features = {"demo_frames": rng.randn(8, 5, 6),
              "observation": rng.randn(8, 6)}
  labels = {"action": rng.randn(8, 3), "task_id": TASK_IDS}
  return jax_models.VRGripperTECModel(device_type="cpu", **TEC), \
      features, labels, {"tec": TEC}


def _maml_case():
  """`train_wtl_maml.gin`'s model (the JAX package's copy of the config
  for the reference, the port's in the ranks) on 4 tasks of 2 condition
  and 2 inference samples at the TEC base's default widths."""
  jax_config.clear_config()
  jax_config.parse_config_file(os.path.join(
      REPO_ROOT, "tensor2robot_tpu", "research", "vrgripper", "configs",
      "train_wtl_maml.gin"))
  try:
    model = jax_config.get_configurable("MAMLModel")()
  finally:
    jax_config.clear_config()
  rng = np.random.RandomState(11)
  tasks, samples, demo, obs, action = 4, 2, 8, 16, 7
  features = {}
  for split in ("condition", "inference"):
    features[f"{split}/features/demo_frames"] = rng.randn(tasks, samples,
                                                          demo, obs)
    features[f"{split}/features/observation"] = rng.randn(tasks, samples,
                                                          obs)
  features["condition/labels/action"] = rng.randn(tasks, samples, action)
  # Distinct ids inside a task's condition split; the flattened inference
  # split carries TASK_IDS, rank 0's tasks first.
  features["condition/labels/task_id"] = np.arange(
      tasks * samples).reshape(tasks, samples)
  labels = {"action": rng.randn(tasks, samples, action),
            "task_id": TASK_IDS.reshape(tasks, samples)}
  port = {"config": os.path.join(REPO_ROOT, "tensor2robot_tpu_torch",
                                 "configs", "train_wtl_maml.gin")}
  return model, features, labels, port


def _f32(tree):
  return {k: v.astype(np.float32) if v.dtype.kind == "f" else v
          for k, v in tree.items()}


@pytest.fixture(scope="module")
def cases(tmp_path_factory):
  """(JAX's global-batch step, the ranks' results) per case."""
  want, payload = {}, {}
  for name, build in (("tec", _tec_case), ("maml", _maml_case)):
    model, features, labels, port = build()
    params = parity.randomized(parity.init_variables(
        model, _f32(features))["params"], 3)
    want[name] = parity.jax_train(model, {"params": params}, features,
                                  labels, jnp.float64)
    payload[name] = dict(port, features=features, labels=labels, params={
        k: v.numpy() for k, v in parity.bridged(params).items()})
  ranks = torch_mesh_world.run_world(
      2, "tests.test_torch_tec_whole_batch_cases:tec_train_steps", payload,
      tmp_path_factory.mktemp("tec_whole_batch"))
  return want, ranks


def test_blocks_have_no_positive_pair():
  """Each 4-row block's own triplet term is 0.0 (the reading before the
  repair), the global batch's is not."""
  model, features, labels, _ = _tec_case()
  params = parity.randomized(parity.init_variables(
      model, _f32(features))["params"], 3)
  _, outputs, scalars, _, _ = parity.jax_train(
      model, {"params": params}, features, labels, jnp.float64)
  emb = jnp.asarray(outputs["task_embedding"])
  ids = jnp.asarray(TASK_IDS.astype(np.int32))
  assert float(scalars["embedding_triplet"]) > 0.1
  for block in (slice(0, 4), slice(4, 8)):
    assert float(jax_tec.triplet_semihard_loss(emb[block],
                                               ids[block])) == 0.0


@pytest.mark.parametrize("name", ["tec", "maml"])
def test_triplet_term_reads_the_global_batch(cases, name):
  want, ranks = cases
  _, _, w_scalars, _, _ = want[name]
  assert float(w_scalars["embedding_triplet"]) > 0.1
  for result in ranks:
    assert result[name]["scalars"]["embedding_triplet"] == pytest.approx(
        float(w_scalars["embedding_triplet"]), rel=TOL)


@pytest.mark.parametrize("name", ["tec", "maml"])
def test_loss_and_gradients_equal_the_global_step(cases, name):
  """The mean of the ranks' losses is the global loss, and the sum of
  their gradients (each divided by the mesh size) the global gradient."""
  want, ranks = cases
  w_loss, _, w_scalars, w_grads, _ = want[name]
  got = [r[name] for r in ranks]
  assert np.mean([r["loss"] for r in got]) == pytest.approx(float(w_loss),
                                                           rel=TOL)
  for key in w_scalars:
    if key.startswith("inner_loss"):
      continue  # per-task means over each rank's own tasks
    assert np.mean([r["scalars"][key] for r in got]) == pytest.approx(
        float(w_scalars[key]), rel=TOL), key
  assert set(got[0]["grads"]) == set(w_grads)
  for key, w_grad in w_grads.items():
    total = sum(r["grads"][key] for r in got)
    assert parity.scaled_err(total, w_grad) <= TOL, key
