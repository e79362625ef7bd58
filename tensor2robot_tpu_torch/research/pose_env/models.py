"""PoseEnv research models: the end-to-end toy task family.

Counterpart of `tensor2robot_tpu.research.pose_env.models`: a regression
model (behavioural cloning of the reach action, success-weighted when
the labels carry rewards) and a continuous Monte-Carlo critic, both over
a `BerkeleyNet` torso (filters (32, 16), kernels (5, 3), strides (2, 1))
on the toy env's 32x32 grayscale observations (`envs/pose_env.py`). The
module names are the JAX package's (`torso`, `head`, `fc_0`, `fc_1`,
`q`), so `bridge.py` carries its weights across.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tensor2robot_tpu_torch import modes as modes_lib
from tensor2robot_tpu_torch.layers import vision
from tensor2robot_tpu_torch.models import heads
from tensor2robot_tpu_torch.ops.image_norm import normalize_image
from tensor2robot_tpu_torch.parallel import collectives
from tensor2robot_tpu_torch.specs import SpecStruct, TensorSpec
from tensor2robot_tpu_torch.utils import config

__all__ = ["PoseEnvRegressionModel", "PoseEnvContinuousMCModel"]

IMAGE_SIZE = 32
TORSO_FILTERS = (32, 16)
CRITIC_HIDDEN = (64, 64)


def _obs_image(state):
  """Env observations may be the raw image array or the toy env's
  {'image', 'timestep'} dict (envs/pose_env.py)."""
  if isinstance(state, dict) and "image" in state:
    return state["image"]
  return state


def _torso(filters: Sequence[int], dtype: Optional[torch.dtype]
           ) -> vision.BerkeleyNet:
  return vision.BerkeleyNet(1, filters=filters, kernel_sizes=(5, 3),
                            strides=(2, 1), dtype=dtype)


def _prefixed(prefix: str, state):
  return {f"{prefix}.{k}": v for k, v in state.items()}


class _PoseRegressionNet(nn.Module):
  """Image -> BerkeleyNet feature points -> PoseHead (64 hidden, 2 out)."""

  def __init__(self, filters: Sequence[int] = TORSO_FILTERS,
               dtype: Optional[torch.dtype] = None):
    super().__init__()
    self.dtype = dtype
    self.torso = _torso(filters, dtype)
    self.head = vision.PoseHead(2 * filters[-1], output_size=2,
                                hidden_sizes=(64,))

  def forward(self, features, mode: str = modes_lib.TRAIN,
              train: bool = False):
    image = normalize_image(features["state/image"], self.dtype)
    points, state = self.torso(image, train=train)
    action = self.head(points, train=train)
    return (SpecStruct({"inference_output": action}),
            _prefixed("torso", state))


@config.configurable
class PoseEnvRegressionModel(heads.RegressionModel):
  """Behavioral cloning of the reach action from the rendered image."""

  def __init__(self, image_size: int = IMAGE_SIZE,
               success_reward_threshold: float = -0.25, **kwargs):
    super().__init__(target_label_key="target_pose", **kwargs)
    self._image_size = image_size
    # The toy env's per-step reward is -distance in the [-1, 1]^2 box, so
    # MC returns near 0 mean a close reach; for {0, 1} success rewards
    # bind e.g. 0.5.
    self._success_reward_threshold = success_reward_threshold

  def get_feature_specification(self, mode):
    return SpecStruct({
        "state/image": TensorSpec(
            shape=(self._image_size, self._image_size, 1), dtype=np.uint8,
            name="state/image", data_format="png"),
    })

  def get_label_specification(self, mode):
    return SpecStruct({
        "target_pose": TensorSpec(shape=(2,), dtype=np.float32,
                                  name="action/action"),
        # Success-weighted behavioral cloning from random collects:
        # zero-reward episodes give no regression signal. Optional, so
        # unweighted data still trains.
        "reward": TensorSpec(shape=(1,), dtype=np.float32, name="reward",
                             is_optional=True),
    })

  def create_module(self):
    return _PoseRegressionNet(
        dtype=self.compute_dtype if self.use_bfloat16 else None)

  def model_train_fn(self, features, labels, inference_outputs, mode):
    predicted = inference_outputs[self._output_key]
    target = labels[self._target_label_key]
    if "reward" in labels and labels["reward"] is not None:
      # A success indicator: the toy env writes negative -distance MC
      # returns, which as raw weights would flip the gradient's sign.
      weights = (labels["reward"]
                 > self._success_reward_threshold).to(predicted.dtype)
      per_example = ((predicted - target) ** 2).mean(dim=-1, keepdim=True)
      # A ratio of sums over the batch: on a data split every rank's rows
      # are gathered (differentiably), so both sums are the global
      # batch's, as in the JAX package's jitted step.
      group = collectives.current_batch_group()
      per_example = collectives.all_gather_batch(per_example, group)
      weights = collectives.all_gather_batch(weights, group)
      loss = (per_example * weights).sum() / torch.clamp(weights.sum(),
                                                         min=1e-6)
      return loss, {"weighted_mse": loss,
                    "success_fraction": weights.mean()}
    return super().model_train_fn(features, labels, inference_outputs,
                                  mode)

  def pack_features(self, state, context=None, timestep=0):
    """One observation (the raw image or the env's {'image': ...} dict)
    as batch-1 model features."""
    del context, timestep
    return SpecStruct({"state/image": np.expand_dims(
        np.asarray(_obs_image(state)), 0)})


class _PoseCriticNet(nn.Module):
  """Image -> BerkeleyNet feature points, concat the action -> 64 -> 64
  (relu) -> q."""

  def __init__(self, filters: Sequence[int] = TORSO_FILTERS,
               action_size: int = 2, dtype: Optional[torch.dtype] = None):
    super().__init__()
    self.dtype = dtype
    self.torso = _torso(filters, dtype)
    width = 2 * filters[-1] + action_size
    for i, size in enumerate(CRITIC_HIDDEN):
      self.add_module(f"fc_{i}", nn.Linear(width, size))
      width = size
    self.q = nn.Linear(width, 1)

  def forward(self, features, mode: str = modes_lib.TRAIN,
              train: bool = False):
    image = normalize_image(features["state/image"], self.dtype)
    points, state = self.torso(image, train=train)
    action = features["action/action"].to(points.dtype)
    x = torch.cat([points, action], dim=-1)
    for i in range(len(CRITIC_HIDDEN)):
      x = F.relu(getattr(self, f"fc_{i}")(x))
    return (SpecStruct({"q_predicted": self.q(x)}),
            _prefixed("torso", state))


@config.configurable
class PoseEnvContinuousMCModel(heads.CriticModel):
  """Q(image, action) regressed onto Monte-Carlo returns from replay
  episodes."""

  def __init__(self, image_size: int = IMAGE_SIZE, **kwargs):
    super().__init__(**kwargs)
    self._image_size = image_size

  def get_state_specification(self, mode):
    return SpecStruct({
        "image": TensorSpec(
            shape=(self._image_size, self._image_size, 1), dtype=np.uint8,
            name="state/image", data_format="png"),
    })

  def get_action_specification(self, mode):
    return SpecStruct({
        "action": TensorSpec(shape=(2,), dtype=np.float32,
                             name="action/action"),
    })

  def create_module(self):
    return _PoseCriticNet(
        dtype=self.compute_dtype if self.use_bfloat16 else None)

  def pack_features(self, state, context=None, timestep=0,
                    actions=None):
    """An observation and its candidate actions as model features: the
    image repeated once per action."""
    del context, timestep
    if actions is None:
      raise ValueError(
          "PoseEnvContinuousMCModel.pack_features requires candidate "
          "`actions` — the critic's feature spec has a non-optional "
          "action/action input.")
    out = SpecStruct()
    actions = np.asarray(actions, np.float32)
    image = np.repeat(np.expand_dims(np.asarray(_obs_image(state)), 0),
                      actions.shape[0], axis=0)
    out["action/action"] = actions
    out["state/image"] = image
    return out
