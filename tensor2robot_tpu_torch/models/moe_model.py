"""A T2RModel whose trunk is a mixture-of-experts MLP: the training-path
carrier for expert parallelism.

Counterpart of `tensor2robot_tpu.models.moe_model`: embed (Dense, relu)
-> `layers.moe.MixtureOfExperts` (`moe`) -> relu -> Dense `action`, the
loss the action's mean squared error plus `aux_loss_weight` times the
load-balancing auxiliary. Trained with `expert_parallel_rules()` the
`experts_*` leaves shard over the mesh's `model` axis: the ZeRO-3 step
gathers them for the forward and reduce-scatters their gradients (the
`sparse` and `dense` layouts). With `dispatch='alltoall'` and
`expert_parallel_rules(axis='data')` they shard over the token axis
instead and stay this rank's blocks (`stage_local_axes`); the layer's
all-to-alls route the tokens to them.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tensor2robot_tpu_torch import modes as modes_lib
from tensor2robot_tpu_torch.layers import flax_layers
from tensor2robot_tpu_torch.layers import moe as moe_lib
from tensor2robot_tpu_torch.models import abstract as abstract_model
from tensor2robot_tpu_torch.specs import SpecStruct, TensorSpec
from tensor2robot_tpu_torch.utils import config

__all__ = ["MoERegressionModel", "expert_parallel_rules"]


@config.configurable
def expert_parallel_rules(extra_rules=(), axis: str = "model"):
  """Partition rules sharding the `experts_*` params over `axis`:
  'model' for the sparse and dense layouts, 'data' (the tokens' axis)
  for `dispatch='alltoall'`."""
  return (moe_lib.expert_axis_param_rule(axis),) + tuple(extra_rules)


class _MoENetwork(nn.Module):

  def __init__(self, obs_size: int, action_size: int = 7,
               num_experts: int = 4, hidden_size: int = 64, top_k: int = 1,
               dispatch: str = "sparse", capacity_factor: float = 1.25,
               mesh=None, ep_axis: str = "data", dtype=None):
    super().__init__()
    self.dtype = dtype
    self.embed = nn.Linear(obs_size, hidden_size)
    self.moe = moe_lib.MixtureOfExperts(
        hidden_size, num_experts=num_experts, hidden_size=hidden_size,
        output_size=hidden_size, top_k=top_k, dispatch=dispatch,
        capacity_factor=capacity_factor, mesh=mesh, ep_axis=ep_axis,
        dtype=dtype)
    self.action = nn.Linear(hidden_size, action_size)

  def forward(self, features, mode: str = modes_lib.TRAIN,
              train: bool = False):
    del mode
    x = F.relu(flax_layers.dense(features["observation"], self.embed.weight,
                                 self.embed.bias, self.dtype))
    x, aux = self.moe(x, train=train)
    action = flax_layers.dense(F.relu(x), self.action.weight,
                               self.action.bias, self.dtype)
    return SpecStruct({"action": action, "inference_output": action,
                       "moe_aux_loss": aux}), {}


@config.configurable
class MoERegressionModel(abstract_model.T2RModel):
  """observation -> action regression through a routed-expert trunk."""

  def __init__(self, obs_size: int = 16, action_size: int = 7,
               num_experts: int = 4, hidden_size: int = 64,
               top_k: int = 1, dispatch: str = "sparse",
               capacity_factor: float = 1.25,
               aux_loss_weight: float = 0.01,
               ep_axis: str = "data", **kwargs):
    super().__init__(**kwargs)
    self._obs_size = obs_size
    self._action_size = action_size
    self._num_experts = num_experts
    self._hidden_size = hidden_size
    self._top_k = top_k
    self._dispatch = dispatch
    self._capacity_factor = capacity_factor
    self._aux_loss_weight = aux_loss_weight
    self._ep_axis = ep_axis
    self._mesh = None

  def set_mesh(self, mesh) -> None:
    """Receives the training mesh; `dispatch='alltoall'` routes over its
    `ep_axis` and needs it before the module is built."""
    self._set_mesh_guarded(mesh)

  def stage_local_axes(self, name: str) -> Tuple[str, ...]:
    if (self._dispatch == "alltoall" and self._mesh is not None
        and name.startswith("moe.experts_")):
      return (self._ep_axis,)
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
    if self._dispatch == "alltoall" and self._mesh is None:
      raise ValueError("dispatch='alltoall' needs set_mesh() before the "
                       "module is created (train_eval_model does this on "
                       "a mesh)")
    return _MoENetwork(
        self._obs_size, action_size=self._action_size,
        num_experts=self._num_experts, hidden_size=self._hidden_size,
        top_k=self._top_k, dispatch=self._dispatch,
        capacity_factor=self._capacity_factor, mesh=self._mesh,
        ep_axis=self._ep_axis,
        dtype=self.compute_dtype if self.use_bfloat16 else None)

  def model_train_fn(self, features, labels, inference_outputs, mode):
    mse = torch.mean((inference_outputs["action"] - labels["action"]) ** 2)
    aux = inference_outputs["moe_aux_loss"]
    loss = mse + self._aux_loss_weight * aux
    return loss, {"mse": mse, "moe_aux_loss": aux}
