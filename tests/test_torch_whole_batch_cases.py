"""Rank functions of tests/test_torch_whole_batch.py (torch only): each
runs on every rank of a CPU gloo world through
tests/test_torch_mesh_world.py and holds no test itself."""

import numpy as np
import torch

from tensor2robot_tpu_torch.models import heads
from tensor2robot_tpu_torch.parallel import collectives
from tensor2robot_tpu_torch.parallel import mesh as mesh_lib
from tensor2robot_tpu_torch.research.pose_env import models as pose_models


class _Classifier(heads.ClassificationModel):
  """The classification head alone: its loss and metrics take outputs,
  so no network is built."""


# Only the head's loss and metrics run: no network, no specs.
_Classifier.__abstractmethods__ = frozenset()


def whole_batch_ratios(rank, world_size, payload):
  """This rank's block of the global batch through the pose regression's
  success-weighted loss (and its gradient in the predictions) and the
  binary classification head's eval metrics, inside the data axis's
  batch group, as the mesh step and eval step run them."""
  mesh = mesh_lib.create_mesh((world_size, 1, 1), ("data", "fsdp", "sp"),
                              device="cpu")
  rows = len(payload["predicted"]) // world_size
  block = slice(rank * rows, (rank + 1) * rows)
  out = {}
  with collectives.batch_group(mesh.group(("data",))):
    predicted = torch.from_numpy(
        payload["predicted"][block]).requires_grad_(True)
    model = pose_models.PoseEnvRegressionModel()
    loss, scalars = model.model_train_fn(
        {}, {"target_pose": torch.from_numpy(payload["target"][block]),
             "reward": torch.from_numpy(payload["reward"][block])},
        {"inference_output": predicted}, "train")
    (grad,) = torch.autograd.grad(loss, predicted)
    out["pose"] = {"loss": float(loss),
                   "success_fraction": float(scalars["success_fraction"]),
                   # The step divides a gradient by the mesh size.
                   "grad": (grad / world_size).numpy()}
    metrics = _Classifier(num_classes=1).model_eval_fn(
        {}, {"class": torch.from_numpy(
            payload["labels"][block])},
        {"logits": torch.from_numpy(payload["logits"][block])})
    out["head"] = {k: float(v) for k, v in metrics.items()}
  return out
