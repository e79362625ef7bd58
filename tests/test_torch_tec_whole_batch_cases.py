"""Rank functions of tests/test_torch_tec_whole_batch.py (torch only): each
runs on every rank of a CPU gloo world through
tests/test_torch_mesh_world.py and holds no test itself."""

import numpy as np
import torch

from tensor2robot_tpu_torch.parallel import collectives
from tensor2robot_tpu_torch.parallel import mesh as mesh_lib
from tensor2robot_tpu_torch.parallel import train_step as ts
from tensor2robot_tpu_torch.research.vrgripper import models
from tensor2robot_tpu_torch.specs import SpecStruct
from tensor2robot_tpu_torch.utils import config


def _model(payload):
  if payload.get("config"):
    # The model the config's trainer builds: MAML over the TEC base.
    config.clear_config()
    config.parse_config_file(payload["config"])
    try:
      return config.get_configurable("MAMLModel")()
    finally:
      config.clear_config()
  return models.VRGripperTECModel(**payload["tec"])


def _block(tree, rank, world_size):
  out = SpecStruct()
  for key, value in tree.items():
    rows = value.shape[0] // world_size
    out[key] = torch.from_numpy(value[rank * rows:(rank + 1) * rows])
  return out


def tec_train_steps(rank, world_size, payload):
  """Per case: this rank's block of the global batch (its rows, or its
  tasks under MAML) through the model's train-mode loss and its gradient
  in every parameter, inside the data axis's batch group, as the mesh
  step runs them. The gradient is divided by the mesh size, as the step
  divides it after summing it over the ranks."""
  torch.manual_seed(0)
  mesh = mesh_lib.create_mesh((world_size, 1, 1), ("data", "fsdp", "sp"),
                              device="cpu")
  out = {}
  for name, case in payload.items():
    model = _model(case)
    params = {k: torch.from_numpy(v) for k, v in case["params"].items()}
    with collectives.batch_group(mesh.group(("data",))):
      loss, scalars, grads, _ = ts.loss_and_grads(
          model, params, _block(case["features"], rank, world_size),
          _block(case["labels"], rank, world_size), {})
    out[name] = {
        "loss": float(loss),
        "scalars": {k: float(v) for k, v in scalars.items()},
        "grads": {k: (g / world_size).numpy() for k, g in grads.items()}}
  return out
