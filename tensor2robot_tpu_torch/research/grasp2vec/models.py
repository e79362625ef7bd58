"""Grasp2Vec: a self-supervised grasping representation learned by
embedding arithmetic, phi(pregrasp) - phi(postgrasp) ~= psi(goal).

Counterpart of `tensor2robot_tpu.research.grasp2vec.models`: the scene
and goal embedding towers, the dot-product localization heatmap and its
soft-argmax keypoints, and `Grasp2VecModel` with a config-selected
objective (`LOSS_TYPES`) and its eval (the retrieval accuracy of each
arithmetic embedding against the batch's goals, and keypoint quadrant
metrics when the labels carry them).

Towers: 'conv' is a stack of 3x3/2 convs (with biases), each followed by
a LayerNorm over the channels (flax's eps 1e-6) and relu; 'resnet' is the
FiLM-ResNet's `block_layer4` endpoint without conditioning;
'pipelined_conv' is the stride-2 3x3 conv/LayerNorm/relu stack as
heterogeneous pipeline stages (`vision.PipelinedBerkeleyTower`, no conv
bias, LayerNorm eps 1e-12, one `tower.pp_stages` leaf per embedding). With
a mesh whose `pp_axis` has more than one rank (`set_mesh`) both towers
run the GPipe schedule over `pipeline_microbatches` microbatches, and
their `pp_stages` are stage-local (`stage_local_axes`); otherwise the
sequential schedule, the same function. Module names are flax's
(`scene.conv_0`, `scene.norm_0`, `scene.resnet...`, `scene.tower`,
`scene.proj`, `goal.proj`), so `bridge.py` carries a JAX tree across.

The scene tower runs twice per batch (pregrasp and postgrasp). With the
resnet tower in train mode flax updates its batch statistics twice, the
second update starting from the first's result; the network composes the
two updates the same way.

On a mesh whose batch is split over data ranks, the embedding objectives
and the retrieval accuracy read the whole batch: each rank gathers every
rank's embeddings over the batch's axes (`collectives.all_gather_batch`),
so the loss is the global batch's, as the JAX package's jitted step
computes it.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tensor2robot_tpu_torch import modes as modes_lib
from tensor2robot_tpu_torch.layers import film_resnet
from tensor2robot_tpu_torch.layers import flax_layers, vision
from tensor2robot_tpu_torch.models import abstract as abstract_model
from tensor2robot_tpu_torch.ops.image_norm import normalize_image
from tensor2robot_tpu_torch.parallel import collectives
from tensor2robot_tpu_torch.research.grasp2vec import losses as g2v_losses
from tensor2robot_tpu_torch.specs import SpecStruct, TensorSpec
from tensor2robot_tpu_torch.utils import config

__all__ = ["SceneEmbedding", "GoalEmbedding", "Grasp2VecModel",
           "keypoint_heatmap", "TOWERS"]

TOWERS = ("conv", "resnet", "pipelined_conv")
LAYER_NORM_EPSILON = 1e-6  # flax's default

State = Dict[str, torch.Tensor]


def _check_tower(tower: str) -> None:
  if tower not in TOWERS:
    raise ValueError(f"tower must be one of {TOWERS}, got {tower!r}")


class _Embedding(nn.Module):
  """A tower ('conv', 'resnet' or 'pipelined_conv') built onto this
  module, as flax builds it inside the embedding's scope."""

  def __init__(self, tower: str, filters: Sequence[int], resnet_size: int,
               dtype: Optional[torch.dtype], image_size: int = 48,
               pp_mesh=None, pp_axis: str = "pp",
               pp_num_microbatches: int = 4):
    super().__init__()
    _check_tower(tower)
    self.tower_type = tower
    self.dtype = dtype
    if tower == "pipelined_conv":
      self.tower = vision.PipelinedBerkeleyTower(
          (image_size, image_size, 3), filters=filters,
          kernel_sizes=(3,) * len(filters), strides=(2,) * len(filters),
          mesh=pp_mesh, axis_name=pp_axis,
          num_microbatches=pp_num_microbatches, dtype=dtype)
      self.tower_channels = filters[-1]
      return
    if tower == "resnet":
      self.resnet = film_resnet.ResNet(3, resnet_size=resnet_size,
                                       dtype=dtype)
      bottleneck = resnet_size >= film_resnet.BOTTLENECK_FROM
      self.tower_channels = 2048 if bottleneck else 512
      return
    self.num_convs = len(filters)
    channels = 3
    for i, f in enumerate(filters):
      self.add_module(f"conv_{i}", nn.Conv2d(channels, f, 3))
      self.add_module(f"norm_{i}", nn.LayerNorm(f))
      channels = f
    self.tower_channels = channels

  def spatial(self, image: torch.Tensor, train: bool
              ) -> Tuple[torch.Tensor, State]:
    """NHWC image -> (NHWC features, new batch statistics)."""
    if self.tower_type == "pipelined_conv":
      return self.tower(image, train=train)
    if self.tower_type == "resnet":
      _, endpoints, state = self.resnet(image, train=train)
      return endpoints["block_layer4"], {f"resnet.{k}": v
                                         for k, v in state.items()}
    x = image.permute(0, 3, 1, 2)
    for i in range(self.num_convs):
      conv = getattr(self, f"conv_{i}")
      dtype = torch.promote_types(x.dtype, conv.weight.dtype)
      x = flax_layers.conv2d(x.to(dtype), conv.weight.to(dtype),
                             conv.bias.to(dtype), stride=2)
      norm = getattr(self, f"norm_{i}")
      x = flax_layers.layer_norm(x, norm.weight, norm.bias,
                                 LAYER_NORM_EPSILON)
      x = F.relu(x.to(self.dtype or x.dtype))
    return x.permute(0, 2, 3, 1), {}


class SceneEmbedding(_Embedding):
  """Tower -> 1x1 conv `proj` -> (pooled embedding [B, D], spatial map
  [B, H', W', D]); the map feeds the localization heatmap."""

  def __init__(self, embedding_size: int = 64,
               filters: Sequence[int] = (32, 64, 64), tower: str = "conv",
               resnet_size: int = 18, dtype: Optional[torch.dtype] = None,
               **tower_kwargs):
    super().__init__(tower, filters, resnet_size, dtype, **tower_kwargs)
    self.proj = nn.Conv2d(self.tower_channels, embedding_size, 1)

  def forward(self, image: torch.Tensor, train: bool = False):
    x, state = self.spatial(image, train)
    weight = self.proj.weight.reshape(self.proj.weight.shape[:2])
    spatial = flax_layers.dense(x, weight, self.proj.bias)
    return spatial.mean(dim=(1, 2)), spatial, state


class GoalEmbedding(_Embedding):
  """Tower -> spatial mean -> Dense `proj` -> [B, D]."""

  def __init__(self, embedding_size: int = 64,
               filters: Sequence[int] = (32, 64, 64), tower: str = "conv",
               resnet_size: int = 18, dtype: Optional[torch.dtype] = None,
               **tower_kwargs):
    super().__init__(tower, filters, resnet_size, dtype, **tower_kwargs)
    self.proj = nn.Linear(self.tower_channels, embedding_size)

  def forward(self, image: torch.Tensor, train: bool = False):
    x, state = self.spatial(image, train)
    return (flax_layers.dense(x.mean(dim=(1, 2)), self.proj.weight,
                              self.proj.bias), state)


def keypoint_heatmap(spatial_features: torch.Tensor,
                     goal_embedding: torch.Tensor) -> torch.Tensor:
  """Dot-product localization heatmap [B, H, W]."""
  return torch.einsum("bhwc,bc->bhw", spatial_features, goal_embedding)


def _compose_updates(first: State, second: State, initial: State,
                     momentum: float) -> State:
  """Running statistics after two updates in a row, given each update
  taken alone from `initial`: m (m r + (1 - m) b1) + (1 - m) b2 =
  second + m (first - r)."""
  return {k: second[k] + momentum * (first[k] - initial[k]) for k in second}


class _Grasp2VecNetwork(nn.Module):

  def __init__(self, embedding_size: int = 64, tower: str = "conv",
               filters: Sequence[int] = (32, 64, 64), resnet_size: int = 18,
               dtype: Optional[torch.dtype] = None, **tower_kwargs):
    super().__init__()
    self.dtype = dtype
    self.scene = SceneEmbedding(embedding_size, filters, tower, resnet_size,
                                dtype, **tower_kwargs)
    self.goal = GoalEmbedding(embedding_size, filters, tower, resnet_size,
                              dtype, **tower_kwargs)

  def forward(self, features, mode: str = modes_lib.TRAIN,
              train: bool = False):
    norm = lambda img: normalize_image(img, self.dtype)
    initial = {k: v for k, v in self.scene.named_buffers()}
    pregrasp, pregrasp_spatial, first = self.scene(
        norm(features["pregrasp_image"]), train=train)
    postgrasp, postgrasp_spatial, second = self.scene(
        norm(features["postgrasp_image"]), train=train)
    goal_emb, goal_state = self.goal(norm(features["goal_image"]),
                                     train=train)
    scene_state = _compose_updates(first, second, initial,
                                   film_resnet.BATCH_NORM_DECAY)
    outputs = SpecStruct()
    outputs["pregrasp_embedding"] = pregrasp
    outputs["postgrasp_embedding"] = postgrasp
    outputs["pregrasp_spatial"] = pregrasp_spatial
    outputs["postgrasp_spatial"] = postgrasp_spatial
    outputs["goal_embedding"] = goal_emb
    outputs["arithmetic_embedding"] = pregrasp - postgrasp
    outputs["heatmap"] = keypoint_heatmap(pregrasp_spatial, goal_emb)
    outputs["keypoints"] = g2v_losses.heatmap_keypoints(outputs["heatmap"])
    state = {f"scene.{k}": v for k, v in scene_state.items()}
    state.update({f"goal.{k}": v for k, v in goal_state.items()})
    return outputs, state


@config.configurable
class Grasp2VecModel(abstract_model.T2RModel):
  """phi(pre) - phi(post) ~= psi(goal) under a config-selected objective:
  'npairs' (bidirectional), 'npairs_multilabel', 'triplet',
  'l2_arithmetic' or 'cosine_arithmetic'; `ty_loss_weight` adds the TY
  localization loss."""

  LOSS_TYPES = ("npairs", "npairs_multilabel", "triplet", "l2_arithmetic",
                "cosine_arithmetic")

  def __init__(self, image_size: int = 48, embedding_size: int = 64,
               tower: str = "conv", resnet_size: int = 18,
               filters: Tuple[int, ...] = (32, 64, 64),
               loss_type: str = "npairs",
               non_negativity_constraint: bool = False,
               triplet_margin: float = 3.0,
               ty_loss_weight: float = 0.0,
               pipeline_microbatches: int = 4,
               pp_axis: str = "pp",
               **kwargs):
    super().__init__(**kwargs)
    if loss_type not in self.LOSS_TYPES:
      raise ValueError(f"loss_type must be one of {self.LOSS_TYPES}, "
                       f"got {loss_type!r}")
    _check_tower(tower)
    self._image_size = image_size
    self._embedding_size = embedding_size
    self._tower = tower
    self._resnet_size = resnet_size
    self._filters = tuple(filters)
    self._loss_type = loss_type
    self._non_negativity_constraint = non_negativity_constraint
    self._triplet_margin = triplet_margin
    self._ty_loss_weight = ty_loss_weight
    self._pipeline_microbatches = pipeline_microbatches
    self._pp_axis = pp_axis
    self._mesh = None

  def set_mesh(self, mesh) -> None:
    """Receives the training mesh. With tower='pipelined_conv' and a >1
    `pp_axis`, both embedding towers run their conv stacks as
    heterogeneous GPipe stages; otherwise the sequential schedule."""

    def validate(m):
      if self._tower == "pipelined_conv":
        self._validate_pp_stage_count(m, self._pp_axis, len(self._filters),
                                      what="pipelined tower")

    self._set_mesh_guarded(mesh, validate)

  def _pipelined_mesh(self):
    mesh = self._mesh
    if (mesh is not None and self._tower == "pipelined_conv"
        and mesh.shape.get(self._pp_axis, 1) > 1):
      return mesh
    return None

  def stage_local_axes(self, name: str) -> Tuple[str, ...]:
    if self._pipelined_mesh() is not None and name in (
        "scene.tower.pp_stages", "goal.tower.pp_stages"):
      return (self._pp_axis,)
    return ()

  def get_feature_specification(self, mode):
    image = lambda name: TensorSpec(
        shape=(self._image_size, self._image_size, 3), dtype=np.uint8,
        name=name, data_format="jpeg")
    return SpecStruct({
        "pregrasp_image": image("pregrasp/image"),
        "postgrasp_image": image("postgrasp/image"),
        "goal_image": image("goal/image"),
    })

  def get_label_specification(self, mode):
    # grasp_success masks or relabels the arithmetic and multilabel
    # objectives; keypoint_quadrant scores localization on Shapes-style
    # data.
    return SpecStruct({
        "grasp_success": TensorSpec(shape=(1,), dtype=np.float32,
                                    name="grasp_success", is_optional=True),
        "keypoint_quadrant": TensorSpec(shape=(), dtype=np.int64,
                                        name="keypoint_quadrant",
                                        is_optional=True),
    })

  def create_module(self) -> nn.Module:
    return _Grasp2VecNetwork(
        embedding_size=self._embedding_size, tower=self._tower,
        filters=self._filters, resnet_size=self._resnet_size,
        dtype=self.compute_dtype if self.use_bfloat16 else None,
        image_size=self._image_size, pp_mesh=self._pipelined_mesh(),
        pp_axis=self._pp_axis,
        pp_num_microbatches=self._pipeline_microbatches)

  @staticmethod
  def _label(labels, key: str) -> Optional[torch.Tensor]:
    if labels is not None and key in labels:
      return labels[key]
    return None

  @staticmethod
  def _whole_batch(x: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """`x` over the whole batch: on a data split, every rank's rows
    gathered (differentiably), as the global batch's loss reads them."""
    if x is None:
      return None
    return collectives.all_gather_batch(x,
                                        collectives.current_batch_group())

  def model_train_fn(self, features, labels, inference_outputs, mode):
    # The embedding losses compare every row with every other (npairs'
    # negatives are the batch's other rows), so they read the whole batch.
    pre, post, goal = (self._whole_batch(inference_outputs[k]) for k in (
        "pregrasp_embedding", "postgrasp_embedding", "goal_embedding"))
    success = self._whole_batch(self._label(labels, "grasp_success"))
    if self._loss_type == "npairs":
      loss = g2v_losses.npairs_loss_bidirectional(
          pre, goal, post,
          non_negativity_constraint=self._non_negativity_constraint)
    elif self._loss_type == "npairs_multilabel":
      if success is None:
        success = torch.ones((pre.shape[0], 1), device=pre.device)
      loss = g2v_losses.npairs_loss_multilabel(pre, goal, post, success)
    elif self._loss_type == "triplet":
      loss, _, _ = g2v_losses.triplet_loss(pre, goal, post,
                                           margin=self._triplet_margin)
    elif self._loss_type == "l2_arithmetic":
      loss = g2v_losses.l2_arithmetic_loss(pre, goal, post, mask=success)
    else:
      loss = g2v_losses.cosine_arithmetic_loss(pre, goal, post, mask=success)
    scalars = {"embed_loss": loss}
    if self._ty_loss_weight:
      # A mean over rows: this rank's rows' mean averages to the batch's.
      ty = g2v_losses.ty_loss(inference_outputs["pregrasp_spatial"],
                              inference_outputs["postgrasp_spatial"],
                              inference_outputs["goal_embedding"])
      scalars["ty_loss"] = ty
      loss = loss + self._ty_loss_weight * ty
    return loss, scalars

  def model_eval_fn(self, features, labels, inference_outputs):
    loss, scalars = self.model_train_fn(features, labels, inference_outputs,
                                        modes_lib.EVAL)
    arithmetic = self._whole_batch(inference_outputs["arithmetic_embedding"])
    goal = self._whole_batch(inference_outputs["goal_embedding"])
    # Does each arithmetic embedding rank its own goal first? argmax
    # takes the first of tied maxima, as jnp's does.
    sims = arithmetic @ goal.T
    correct = torch.argmax(sims, dim=-1) == torch.arange(
        sims.shape[0], device=sims.device)
    metrics = {"loss": loss,
               "retrieval_accuracy": correct.to(torch.float32).mean(),
               **scalars}
    quadrant = self._label(labels, "keypoint_quadrant")
    if quadrant is not None:
      accuracy, keypoint_ce = g2v_losses.keypoint_accuracy(
          inference_outputs["keypoints"], quadrant)
      metrics["keypoint_accuracy"] = accuracy
      metrics["keypoint_ce"] = keypoint_ce
    return metrics
