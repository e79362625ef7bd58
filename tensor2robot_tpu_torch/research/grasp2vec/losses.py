"""Grasp2Vec's embedding-arithmetic losses.

Counterpart of `tensor2robot_tpu.research.grasp2vec.losses`: the L2 and
cosine arithmetic losses (masked by grasp success), the semihard triplet
and bidirectional n-pairs objectives (and the multilabel variant that
collapses failed grasps onto one class), keypoint quadrant accuracy, the
norm-matching and send-to-zero regularizers, the spatial softmax response
and TY ratio loss over scene feature maps, and the soft-argmax keypoints
of a heatmap. Masks are weighted means, sum(x m) / max(sum(m), 1): the
value over a non-empty mask and 0 over an empty one.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from tensor2robot_tpu_torch.layers import tec as tec_lib

__all__ = [
    "l2_arithmetic_loss", "cosine_arithmetic_loss", "triplet_loss",
    "npairs_loss_bidirectional", "npairs_loss_multilabel",
    "keypoint_accuracy", "send_to_zero_loss", "match_norms_loss",
    "get_softmax_response", "ty_loss", "heatmap_keypoints",
]

_QUADRANT_CENTERS = ((0.5, -0.5), (-0.5, -0.5), (0.5, 0.5), (-0.5, 0.5))


def _norm(x: torch.Tensor, dim: int = -1,
          keepdim: bool = False) -> torch.Tensor:
  return torch.linalg.vector_norm(x, dim=dim, keepdim=keepdim)


def _masked_mean(values: torch.Tensor,
                 mask: Optional[torch.Tensor]) -> torch.Tensor:
  if mask is None:
    return values.mean()
  mask = mask.reshape(values.shape).to(values.dtype)
  return torch.sum(values * mask) / torch.clamp(torch.sum(mask), min=1.0)


def _l2_normalize(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
  return x / torch.clamp(_norm(x, dim, keepdim=True), min=1e-12)


def l2_arithmetic_loss(pregrasp_embedding, goal_embedding,
                       postgrasp_embedding, mask=None) -> torch.Tensor:
  """Masked mean of |pre - goal - post|^2."""
  raw = pregrasp_embedding - goal_embedding - postgrasp_embedding
  return _masked_mean(torch.sum(raw ** 2, dim=1), mask)


def cosine_arithmetic_loss(pregrasp_embedding, goal_embedding,
                           postgrasp_embedding, mask=None) -> torch.Tensor:
  """Masked mean cosine distance of normalize(pre - post) and
  normalize(goal)."""
  pair_a = _l2_normalize(pregrasp_embedding - postgrasp_embedding)
  pair_b = _l2_normalize(goal_embedding)
  return _masked_mean(1.0 - torch.sum(pair_a * pair_b, dim=1), mask)


def triplet_loss(pregrasp_embedding, goal_embedding, postgrasp_embedding,
                 margin: float = 3.0
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
  """Euclidean semihard triplet over {normalize(pre - post),
  normalize(goal)}, example i's two members sharing label i. Returns
  (loss, pairs, labels)."""
  pair_a = _l2_normalize(pregrasp_embedding - postgrasp_embedding)
  pair_b = _l2_normalize(goal_embedding)
  n = pregrasp_embedding.shape[0]
  labels = torch.arange(n, device=pair_a.device).repeat(2)
  pairs = torch.cat([pair_a, pair_b], dim=0)
  loss = tec_lib.triplet_semihard_loss(pairs, labels, margin=margin,
                                       distance="euclidean")
  return loss, pairs, labels


def npairs_loss_bidirectional(pregrasp_embedding, goal_embedding,
                              postgrasp_embedding,
                              non_negativity_constraint: bool = False
                              ) -> torch.Tensor:
  """n-pairs in both anchor orders over (pre - post, goal)."""
  pair_a = pregrasp_embedding - postgrasp_embedding
  if non_negativity_constraint:
    pair_a = F.relu(pair_a)
  return (tec_lib.npairs_loss(pair_a, goal_embedding)
          + tec_lib.npairs_loss(goal_embedding, pair_a))


def npairs_loss_multilabel(pregrasp_embedding, goal_embedding,
                           postgrasp_embedding, grasp_success
                           ) -> torch.Tensor:
  """n-pairs with failed grasps collapsed onto one 'nothing grasped'
  class: example i has label i when its grasp succeeded, else 0."""
  pair_a = pregrasp_embedding - postgrasp_embedding
  n = pregrasp_embedding.shape[0]
  success = grasp_success.reshape(n).to(torch.int32)
  labels = torch.arange(n, dtype=torch.int32, device=pair_a.device) * success
  return (tec_lib.npairs_loss(pair_a, goal_embedding, labels)
          + tec_lib.npairs_loss(goal_embedding, pair_a, labels))


def keypoint_accuracy(keypoints, labels
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
  """Quadrant accuracy and sigmoid cross-entropy of (x, y) keypoints
  against integer quadrant labels."""
  keypoints = keypoints.reshape(-1, 2)
  labels = labels.reshape(-1).long()
  centers = torch.tensor(_QUADRANT_CENTERS, dtype=torch.float32,
                         device=keypoints.device)
  dtype = torch.promote_types(keypoints.dtype, torch.float32)
  logits = keypoints.to(dtype) @ centers.to(dtype).T
  correct = (torch.argmax(logits, dim=1) == labels).to(torch.float32)
  one_hot = F.one_hot(labels, 4).to(dtype)
  ce = (torch.clamp(logits, min=0) - logits * one_hot
        + torch.log1p(torch.exp(-torch.abs(logits))))
  return correct.mean(), ce.mean()


def send_to_zero_loss(tensor, mask=None) -> torch.Tensor:
  """Masked mean L2 norm."""
  return _masked_mean(_norm(tensor, dim=1), mask)


def match_norms_loss(anchor_tensors, paired_tensors) -> torch.Tensor:
  """Pulls the paired norms toward the (detached) anchor norms: half the
  batch SUM of squared differences (the reference's tf.nn.l2_loss)."""
  anchor_norms = _norm(anchor_tensors, dim=1).detach()
  paired_norms = _norm(paired_tensors, dim=1)
  return 0.5 * torch.sum((anchor_norms - paired_norms) ** 2)


def get_softmax_response(goal_embedding, scene_spatial
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
  """(max heatmap response, max softmax mass) of a goal embedding against
  an NHWC feature map."""
  heatmap = torch.einsum("bhwd,bd->bhw", scene_spatial, goal_embedding)
  flat = heatmap.reshape(heatmap.shape[0], -1)
  return flat.amax(dim=1), torch.softmax(flat, dim=1).amax(dim=1)


def ty_loss(pregrasp_spatial, postgrasp_spatial,
            goal_embedding) -> torch.Tensor:
  """The goal should respond more in the pregrasp scene than in the
  postgrasp one: mean(max post response - max pre response) of unit
  vectors."""
  pre = _l2_normalize(pregrasp_spatial)
  post = _l2_normalize(postgrasp_spatial)
  goal = _l2_normalize(goal_embedding)[:, None, None, :]
  pre_max = torch.sum(pre * goal, dim=-1).amax(dim=(1, 2))
  post_max = torch.sum(post * goal, dim=-1).amax(dim=(1, 2))
  return torch.mean(post_max - pre_max)


def heatmap_keypoints(heatmap: torch.Tensor) -> torch.Tensor:
  """Spatial soft-argmax of a [B, H, W] heatmap -> [B, 2] (x, y) in
  [-1, 1]."""
  b, h, w = heatmap.shape
  probs = torch.softmax(heatmap.reshape(b, -1), dim=-1).reshape(b, h, w)
  dtype = torch.promote_types(probs.dtype, torch.float32)
  ys = torch.linspace(-1.0, 1.0, h, dtype=dtype, device=probs.device)
  xs = torch.linspace(-1.0, 1.0, w, dtype=dtype, device=probs.device)
  y = torch.sum(probs.sum(dim=2) * ys[None, :], dim=1)
  x = torch.sum(probs.sum(dim=1) * xs[None, :], dim=1)
  return torch.stack([x, y], dim=-1)
