"""Task-Embedded Control (TEC) networks: episode embeddings and the
contrastive and triplet embedding losses.

Counterpart of `tensor2robot_tpu.layers.tec`: the temporal reducers
(`reduce_temporal_embeddings`, `TemporalConvEmbedding`), the episode and
image embedders (`EmbedEpisode`, `EmbedConditionImages`), and the losses
over [B, D] embeddings with integer labels (`npairs_loss`,
`triplet_semihard_loss` with masked semihard mining,
`cosine_distance_matrix`). Module names are flax's (`fc1`, `fc2`,
`images_to_features`, `fc_{i}`, `fc_ln_{i}`, `fc_out`, `conv1d_{i}`,
`conv_ln_{i}`, `out`); layer norms use flax's eps, 1e-6.

The semihard mining takes its minimum and maximum with `amin` / `amax`,
whose gradient splits evenly between ties, as JAX's does.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from tensor2robot_tpu_torch.layers import flax_layers
from tensor2robot_tpu_torch.layers import vision

__all__ = ["reduce_temporal_embeddings", "EmbedEpisode",
           "EmbedConditionImages", "TemporalConvEmbedding", "npairs_loss",
           "triplet_semihard_loss", "cosine_distance_matrix"]

LAYER_NORM_EPSILON = 1e-6  # flax's default


def _norm(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
  return torch.linalg.vector_norm(x, dim=dim, keepdim=True)


def _layer_norm(x: torch.Tensor, norm: nn.LayerNorm) -> torch.Tensor:
  return flax_layers.layer_norm(x, norm.weight, norm.bias,
                                LAYER_NORM_EPSILON, dim=-1)


def _dense(x: torch.Tensor, layer: nn.Linear,
           dtype: Optional[torch.dtype] = None) -> torch.Tensor:
  return flax_layers.dense(x, layer.weight, layer.bias, dtype)


def reduce_temporal_embeddings(embeddings: torch.Tensor,
                               reduction: str = "mean") -> torch.Tensor:
  """[B, T, D] -> [B, D]."""
  if reduction == "mean":
    return embeddings.mean(dim=1)
  if reduction == "final":
    return embeddings[:, -1]
  if reduction == "max":
    return embeddings.amax(dim=1)
  raise ValueError(f"Unknown reduction {reduction!r}")


class EmbedEpisode(nn.Module):
  """Per-frame MLP (`fc1` relu, `fc2`) -> temporal reduction -> L2
  normalisation (x / (|x| + 1e-7))."""

  def __init__(self, in_features: int, embedding_size: int = 64,
               hidden_size: int = 128, reduction: str = "mean",
               normalize: bool = True):
    super().__init__()
    self.reduction = reduction
    self.normalize = normalize
    self.fc1 = nn.Linear(in_features, hidden_size)
    self.fc2 = nn.Linear(hidden_size, embedding_size)

  def forward(self, frames: torch.Tensor, train: bool = False
              ) -> torch.Tensor:
    del train  # no train-mode behaviour
    x = _dense(F.relu(_dense(frames, self.fc1)), self.fc2)
    x = reduce_temporal_embeddings(x, self.reduction)
    if self.normalize:
      x = x / (_norm(x) + 1e-7)
    return x


class EmbedConditionImages(nn.Module):
  """`BerkeleyNet` (unflattened) per image, then with `fc_layers` hidden
  layers Dense without bias -> LayerNorm -> relu and a biased linear
  `fc_out`; on a spatial map (no spatial softmax) the layers are 1x1
  convs over the channels. `forward` returns (embedding, the tower's new
  batch statistics, {} for its layer norms)."""

  def __init__(self, in_channels: int,
               fc_layers: Optional[Sequence[int]] = None,
               use_spatial_softmax: bool = True,
               filters: Sequence[int] = (64, 32, 32),
               kernel_sizes: Sequence[int] = (7, 3, 3),
               strides: Sequence[int] = (2, 1, 1),
               dtype: Optional[torch.dtype] = None):
    super().__init__()
    self.dtype = dtype
    self.use_spatial_softmax = use_spatial_softmax
    self.images_to_features = vision.BerkeleyNet(
        in_channels, filters=tuple(filters), kernel_sizes=tuple(kernel_sizes),
        strides=tuple(strides), use_spatial_softmax=use_spatial_softmax,
        flatten=False, dtype=dtype)
    self.fc_layers = None if fc_layers is None else tuple(fc_layers)
    if self.fc_layers is None:
      return
    width = 2 * filters[-1] if use_spatial_softmax else filters[-1]
    for i, units in enumerate(self.fc_layers[:-1]):
      if use_spatial_softmax:
        self.add_module(f"fc_{i}", nn.Linear(width, units, bias=False))
      else:
        self.add_module(f"fc_{i}", nn.Conv2d(width, units, 1, bias=False))
      self.add_module(f"fc_ln_{i}", nn.LayerNorm(units))
      width = units
    final = self.fc_layers[-1]
    self.fc_out = (nn.Linear(width, final) if use_spatial_softmax
                   else nn.Conv2d(width, final, 1))

  def _fc(self, name: str, x: torch.Tensor) -> torch.Tensor:
    # A 1x1 conv on an NHWC map is a Dense over its channels.
    layer = getattr(self, name)
    weight = layer.weight.reshape(layer.weight.shape[:2])
    return flax_layers.dense(x, weight, layer.bias)

  def forward(self, images: torch.Tensor, train: bool = False):
    x, state = self.images_to_features(images, train=train)
    state = {f"images_to_features.{k}": v for k, v in state.items()}
    if self.fc_layers is None:
      return x, state
    for i in range(len(self.fc_layers) - 1):
      x = F.relu(_layer_norm(self._fc(f"fc_{i}", x),
                             getattr(self, f"fc_ln_{i}")).to(
                                 self.dtype or x.dtype))
    return self._fc("fc_out", x), state


class TemporalConvEmbedding(nn.Module):
  """Learned temporal reduction [B, T, D] -> [B, output_size]: conv1d
  stacks (kernel 10, SAME, no bias) -> relu -> LayerNorm, a mean over
  time, Dense -> relu -> LayerNorm per hidden layer, then `out`."""

  def __init__(self, in_features: int, output_size: int,
               conv1d_layers: Sequence[int] = (64,),
               fc_hidden_layers: Sequence[int] = (100,),
               kernel_size: int = 10):
    super().__init__()
    self.conv1d_layers = tuple(conv1d_layers)
    self.fc_hidden_layers = tuple(fc_hidden_layers)
    width = in_features
    for i, filters in enumerate(self.conv1d_layers):
      self.add_module(f"conv1d_{i}", nn.Conv1d(width, filters, kernel_size,
                                               bias=False))
      self.add_module(f"conv_ln_{i}", nn.LayerNorm(filters))
      width = filters
    for i, hidden in enumerate(self.fc_hidden_layers):
      self.add_module(f"fc_{i}", nn.Linear(width, hidden))
      self.add_module(f"fc_ln_{i}", nn.LayerNorm(hidden))
      width = hidden
    self.out = nn.Linear(width, output_size)

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    for i in range(len(self.conv1d_layers)):
      y = flax_layers.conv1d_same(x, getattr(self, f"conv1d_{i}").weight)
      x = _layer_norm(F.relu(y), getattr(self, f"conv_ln_{i}"))
    x = x.mean(dim=-2)
    for i in range(len(self.fc_hidden_layers)):
      x = _layer_norm(F.relu(_dense(x, getattr(self, f"fc_{i}"))),
                      getattr(self, f"fc_ln_{i}"))
    return _dense(x, self.out)


def cosine_distance_matrix(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
  """Pairwise cosine distances, [N, D] x [M, D] -> [N, M]."""
  a = a / (_norm(a) + 1e-7)
  b = b / (_norm(b) + 1e-7)
  return 1.0 - a @ b.T


def _soft_targets(labels: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
  """Each row spread evenly over the columns that share its label."""
  same = (labels[:, None] == labels[None, :]).to(dtype)
  return same / same.sum(-1, keepdim=True)


def npairs_loss(embeddings_anchor: torch.Tensor,
                embeddings_positive: torch.Tensor,
                labels: Optional[torch.Tensor] = None) -> torch.Tensor:
  """Softmax cross-entropy of anchor . positive similarities, the targets
  spread over equal labels (labels default to 0..N-1)."""
  logits = embeddings_anchor @ embeddings_positive.T
  if labels is None:
    labels = torch.arange(logits.shape[0], device=logits.device)
  targets = _soft_targets(labels, torch.float32)
  log_probs = torch.log_softmax(logits, dim=-1)
  return -(targets * log_probs).sum(-1).mean()


def triplet_semihard_loss(embeddings: torch.Tensor,
                          labels: torch.Tensor,
                          margin: float = 1.0,
                          distance: str = "cosine") -> torch.Tensor:
  """Semihard triplet mining: for each anchor-positive pair, the nearest
  negative farther than the positive, else the farthest negative; the
  hinge averaged over the positive pairs."""
  if distance == "cosine":
    dist = cosine_distance_matrix(embeddings, embeddings)
  else:
    sq = (embeddings ** 2).sum(-1)
    dist = torch.sqrt(torch.clamp(
        sq[:, None] + sq[None, :] - 2.0 * embeddings @ embeddings.T,
        min=1e-12))
  n = labels.shape[0]
  same = labels[:, None] == labels[None, :]
  positive_mask = same & ~torch.eye(n, dtype=torch.bool, device=same.device)
  negative_mask = ~same
  d_ap = dist[:, :, None]
  d_an = dist[:, None, :]
  semihard = (d_an > d_ap) & negative_mask[:, None, :]
  inf = torch.tensor(float("inf"), dtype=dist.dtype, device=dist.device)
  semihard_min = torch.where(semihard, d_an, inf).amin(dim=-1)
  easiest_neg = torch.where(negative_mask, dist, -inf).amax(dim=-1)
  neg_dist = torch.where(torch.isfinite(semihard_min), semihard_min,
                         easiest_neg[:, None])
  loss = torch.clamp(dist + margin - neg_dist, min=0.0)
  num_pairs = torch.clamp(positive_mask.sum(), min=1)
  return torch.where(positive_mask, loss, 0.0).sum() / num_pairs
