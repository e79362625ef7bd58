"""A T2RModel whose trunk is pipelined over a mesh axis: the training-path
carrier for pipeline parallelism.

Counterpart of `tensor2robot_tpu.models.pipelined_model`: embed -> S
homogeneous residual MLP stages -> head, the stages' parameters stacked
(`stages_w1`, `stages_b1`, `stages_w2`, `stages_b2`, leading [S] dim) and
sharded over the `pp` axis by `pipeline_parallel_rules()`. On a mesh whose
`pp` axis has more than one rank the batch splits into microbatches that
run the pipeline schedule (`parallel.pipeline_parallel.pipelined_apply`):
GPipe at `num_virtual_stages=1`, interleaved 1F1B at v > 1. Without such a
mesh (a single process, serving) the same stack runs in depth order, the
same function.

For v > 1 the stack's layout is the interleaved one (position r*v + j
holds depth layer j*S + r, what contiguous `pp` sharding wants), in the
checkpoint too, so the pipelined step needs no permute; the sequential
schedule reads the depth order back through `interleave_order`.

On a mesh the trunk takes this rank's [v] block of each stage leaf, as
the train step hands it (`stage_local_axes`; the partition rules must
shard the stages over `pp`).
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from tensor2robot_tpu_torch import modes as modes_lib
from tensor2robot_tpu_torch.layers import flax_layers
from tensor2robot_tpu_torch.models import abstract as abstract_model
from tensor2robot_tpu_torch.parallel import pipeline_parallel as pp_lib
from tensor2robot_tpu_torch.specs import SpecStruct, TensorSpec
from tensor2robot_tpu_torch.utils import config

__all__ = ["PipelinedRegressionModel", "pipeline_parallel_rules",
           "STAGE_LEAVES"]

STAGE_LEAVES = ("stages_w1", "stages_b1", "stages_w2", "stages_b2")


@config.configurable
def pipeline_parallel_rules(axis: str = "pp", extra_rules=()):
  """Partition rules sharding the stacked stage params over `axis`: the
  homogeneous trunk's `stages_*` and the heterogeneous towers' [S, P_max]
  `pp_stages` (`layers.vision.PipelinedBerkeleyTower`)."""
  return ((r"stages_w", (axis, None, None)),
          (r"stages_b", (axis, None)),
          (r"pp_stages", (axis, None))) + tuple(extra_rules)


def _stage_fn(p: Dict[str, torch.Tensor], act: torch.Tensor) -> torch.Tensor:
  """x + W2 tanh(W1 x + b1) + b2 (flax's [in, out] stage matrices)."""
  hidden = torch.tanh(act @ p["w1"] + p["b1"])
  return act + hidden @ p["w2"] + p["b2"]


class _PipelinedTrunk(nn.Module):
  """embed -> S homogeneous residual MLP stages -> head."""

  def __init__(self, obs_size: int, action_size: int, hidden_size: int,
               num_stages: int, num_microbatches: int,
               num_virtual_stages: int = 1, mesh=None,
               axis_name: str = "pp", batch_axis: str = "data",
               dtype: Optional[torch.dtype] = None):
    super().__init__()
    self.num_stages = num_stages
    self.num_microbatches = num_microbatches
    self.num_virtual_stages = num_virtual_stages
    self.mesh = mesh
    self.axis_name = axis_name
    self.batch_axis = batch_axis
    self.dtype = dtype
    s, h = num_stages, hidden_size
    self.embed = nn.Linear(obs_size, h)
    self.stages_w1 = nn.Parameter(torch.zeros(s, h, h))
    self.stages_b1 = nn.Parameter(torch.zeros(s, h))
    self.stages_w2 = nn.Parameter(torch.zeros(s, h, h))
    self.stages_b2 = nn.Parameter(torch.zeros(s, h))
    self.head = nn.Linear(h, action_size)

  def initial_params(self, generator: torch.Generator
                     ) -> Dict[str, torch.Tensor]:
    """flax's: w1 variance_scaling(1, fan_in, normal) over the [S, h, h]
    stack (fan_in h * S), w2 a unit normal over sqrt(h), zero biases."""
    s, h = self.stages_w1.shape[:2]
    w1 = torch.randn((s, h, h), generator=generator) / math.sqrt(h * s)
    w2 = torch.randn((s, h, h), generator=generator) / math.sqrt(h)
    return {"stages_w1": w1, "stages_b1": torch.zeros(s, h),
            "stages_w2": w2, "stages_b2": torch.zeros(s, h)}

  def _pipelined(self, x: torch.Tensor, stages) -> torch.Tensor:
    batch, h = x.shape
    m = self.num_microbatches
    if batch % m:
      raise ValueError(
          f"batch size {batch} not divisible into {m} microbatches")
    v = self.num_virtual_stages
    out = pp_lib.pipelined_apply(
        _stage_fn, stages, x.reshape(m, batch // m, h), self.mesh,
        axis_name=self.axis_name, batch_axis=self.batch_axis,
        num_virtual_stages=v,
        params_layout="interleaved" if v > 1 else "layer", local=True)
    return out.reshape(batch, h)

  def forward(self, features, mode: str = modes_lib.TRAIN,
              train: bool = False):
    del mode, train  # no train-mode behaviour
    x = features["observation"]
    if self.dtype is not None:
      x = x.to(self.dtype)
    x = torch.tanh(flax_layers.dense(x, self.embed.weight, self.embed.bias))
    stages = {"w1": self.stages_w1, "b1": self.stages_b1,
              "w2": self.stages_w2, "b2": self.stages_b2}
    stages = {k: p.to(x.dtype) for k, p in stages.items()}
    if self.mesh is not None:
      x = self._pipelined(x, stages)
    else:
      # The sequential schedule, in depth order.
      v = self.num_virtual_stages
      order = (np.argsort(pp_lib.interleave_order(self.num_stages // v, v))
               if v > 1 else range(self.num_stages))
      for layer in order:
        x = _stage_fn({k: p[int(layer)] for k, p in stages.items()}, x)
    action = flax_layers.dense(x, self.head.weight, self.head.bias)
    return SpecStruct({"action": action, "inference_output": action}), {}


@config.configurable
class PipelinedRegressionModel(abstract_model.T2RModel):
  """observation -> action regression through a pp-sharded pipelined
  trunk. `train_eval_model` calls `set_mesh()` before the module is
  built, so a config needs only `mesh_axis_names = ('data', 'pp',
  'model')` and `partition_rules = @pipeline_parallel_rules()`."""

  def __init__(self, obs_size: int = 16, action_size: int = 7,
               hidden_size: int = 64, num_stages: int = 4,
               num_microbatches: int = 4, num_virtual_stages: int = 1,
               pp_axis: str = "pp", **kwargs):
    super().__init__(**kwargs)
    # The sequential schedule also splits the stack into
    # num_stages / num_virtual_stages columns, with or without a mesh.
    if num_virtual_stages < 1 or num_stages % num_virtual_stages:
      raise ValueError(
          f"num_stages={num_stages} must be a positive multiple of "
          f"num_virtual_stages={num_virtual_stages}")
    self._obs_size = obs_size
    self._action_size = action_size
    self._hidden_size = hidden_size
    self._num_stages = num_stages
    self._num_microbatches = num_microbatches
    self._num_virtual_stages = num_virtual_stages
    self._pp_axis = pp_axis
    self._mesh = None

  def set_mesh(self, mesh) -> None:
    """Receives the training mesh: the pipelined schedule runs when the
    mesh has a >1 `pp_axis`, the sequential one otherwise."""
    self._set_mesh_guarded(
        mesh, lambda m: self._validate_pp_stage_count(
            m, self._pp_axis, self._num_stages,
            num_virtual_stages=self._num_virtual_stages))

  def _pipelined_mesh(self):
    mesh = self._mesh
    if mesh is not None and mesh.shape.get(self._pp_axis, 1) > 1:
      return mesh
    return None

  def stage_local_axes(self, name: str) -> Tuple[str, ...]:
    if self._pipelined_mesh() is not None and name in STAGE_LEAVES:
      return (self._pp_axis,)
    return ()

  def get_feature_specification(self, mode):
    return SpecStruct({
        "observation": TensorSpec(shape=(self._obs_size,),
                                  dtype=np.float32, name="observation"),
    })

  def get_label_specification(self, mode):
    return SpecStruct({
        "action": TensorSpec(shape=(self._action_size,),
                             dtype=np.float32, name="action"),
    })

  def create_module(self):
    return _PipelinedTrunk(
        obs_size=self._obs_size, action_size=self._action_size,
        hidden_size=self._hidden_size, num_stages=self._num_stages,
        num_microbatches=self._num_microbatches,
        num_virtual_stages=self._num_virtual_stages,
        mesh=self._pipelined_mesh(), axis_name=self._pp_axis,
        dtype=self.compute_dtype if self.use_bfloat16 else None)

  def model_train_fn(self, features, labels, inference_outputs, mode):
    loss = torch.mean((inference_outputs["action"] - labels["action"]) ** 2)
    return loss, {"mse": loss}
