"""ResNet v1/v2 with per-block FiLM conditioning.

Counterpart of `tensor2robot_tpu.layers.film_resnet`: basic blocks below
size 50 and bottleneck blocks from 50 on, v1 (post-activation) and v2
(pre-activation), a linear FiLM generator (one Dense per block, 2 x
channels, split into gamma and beta) and the endpoints `block_layer1`
.. `block_layer4` and `final_reduce_mean` (NHWC, as in JAX). Images come
in NHWC; the tower runs NCHW. Module names are flax's (`conv_stem`,
`bn_stem`, `layer1_block0.conv1`, `film_generator.film_l0_b0`, ...), so
`bridge.py` carries a JAX tree and its `batch_stats` across by name.

Pinned as in the JAX package:

* batch norm decay 0.997 and eps 1e-5 (flax's BatchNorm with the
  reference's TF1 constants); the running variance is the biased one, and
  `forward` returns the new statistics instead of writing them;
* the 7x7/2 stem conv and the 3x3/2 max pool are TF 'SAME' (uneven
  padding on even sizes; the pool pads with -inf), through
  `flax_layers.conv2d` and `flax_layers.max_pool`;
* a projection shortcut only where the shapes differ (v1), or where the
  channels or the stride change (v2);
* FiLM after a block's last batch norm, in the block's dtype, at 4 x
  filters for v1 bottlenecks and at filters otherwise;
* kernels lecun normal (flax's default), FiLM and logits Dense biases 0.

Under bfloat16 batch norm returns the compute dtype; its statistics and
normalisation run in at least float32 (`flax_layers.normalize`).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from tensor2robot_tpu_torch.layers import flax_layers
from tensor2robot_tpu_torch.ops.image_norm import normalize_image

__all__ = ["ResNet", "LinearFilmGenerator", "RESNET_BLOCK_SIZES",
           "BOTTLENECK_FROM", "BATCH_NORM_DECAY", "BATCH_NORM_EPSILON"]

RESNET_BLOCK_SIZES: Dict[int, Sequence[int]] = {
    18: (2, 2, 2, 2),
    34: (3, 4, 6, 3),
    50: (3, 4, 6, 3),
    101: (3, 4, 23, 3),
    152: (3, 8, 36, 3),
    200: (3, 24, 36, 3),
}
BOTTLENECK_FROM = 50
BATCH_NORM_DECAY = 0.997
BATCH_NORM_EPSILON = 1e-5

FilmParams = Optional[Tuple[torch.Tensor, torch.Tensor]]
State = Dict[str, torch.Tensor]


def _conv(x: torch.Tensor, conv: nn.Conv2d, stride: int = 1) -> torch.Tensor:
  """flax `nn.Conv` (no dtype): SAME, in the promoted dtype."""
  dtype = torch.promote_types(x.dtype, conv.weight.dtype)
  return flax_layers.conv2d(x.to(dtype), conv.weight.to(dtype), None, stride)


def _batch_norm(channels: int) -> flax_layers.BatchNorm:
  return flax_layers.BatchNorm(channels, momentum=BATCH_NORM_DECAY,
                               epsilon=BATCH_NORM_EPSILON)


def _film(x: torch.Tensor, film_params: FilmParams) -> torch.Tensor:
  if film_params is None:
    return x
  gamma, beta = (p.to(x.dtype)[:, :, None, None] for p in film_params)
  return x * (1.0 + gamma) + beta


class LinearFilmGenerator(nn.Module):
  """Conditioning vector -> per-block (gamma, beta): one Dense
  `film_l{layer}_b{block}` to 2 x channels per block."""

  def __init__(self, condition_size: int, block_channels: Sequence[int],
               blocks_per_layer: Sequence[int]):
    super().__init__()
    self.blocks_per_layer = tuple(blocks_per_layer)
    for layer, (channels, n_blocks) in enumerate(
        zip(block_channels, blocks_per_layer)):
      for block in range(n_blocks):
        self.add_module(f"film_l{layer}_b{block}",
                        nn.Linear(condition_size, 2 * channels))

  def forward(self, conditioning: torch.Tensor
              ) -> List[List[Tuple[torch.Tensor, torch.Tensor]]]:
    out = []
    for layer, n_blocks in enumerate(self.blocks_per_layer):
      layer_params = []
      for block in range(n_blocks):
        dense = getattr(self, f"film_l{layer}_b{block}")
        proj = flax_layers.dense(conditioning, dense.weight, dense.bias)
        layer_params.append(tuple(proj.chunk(2, dim=-1)))
      out.append(layer_params)
    return out


def _bn(owner: nn.Module, name: str, x: torch.Tensor, train: bool,
        state: State) -> torch.Tensor:
  """`owner`'s batch norm `name` on x; its new statistics go into `state`
  under `name`."""
  y, stats = getattr(owner, name)(x, train)
  state.update({f"{name}.{k}": v for k, v in stats.items()})
  return y


class _BlockV1(nn.Module):
  """Post-activation block: basic (conv3x3/s, conv3x3) or bottleneck
  (conv1x1, conv3x3/s, conv1x1 to 4 x filters), each conv followed by
  batch norm, FiLM after the last, a projected shortcut where the shapes
  differ, relu after the sum."""

  def __init__(self, in_channels: int, filters: int, strides: int,
               bottleneck: bool):
    super().__init__()
    self.strides = strides
    self.bottleneck = bottleneck
    out_channels = 4 * filters if bottleneck else filters
    if bottleneck:
      self.conv1 = nn.Conv2d(in_channels, filters, 1, bias=False)
      self.conv2 = nn.Conv2d(filters, filters, 3, bias=False)
      self.conv3 = nn.Conv2d(filters, out_channels, 1, bias=False)
      self.bn3 = _batch_norm(out_channels)
    else:
      self.conv1 = nn.Conv2d(in_channels, filters, 3, bias=False)
      self.conv2 = nn.Conv2d(filters, filters, 3, bias=False)
    self.bn1 = _batch_norm(filters)
    self.bn2 = _batch_norm(filters)
    self.has_proj = in_channels != out_channels or strides != 1
    if self.has_proj:
      self.proj = nn.Conv2d(in_channels, out_channels, 1, bias=False)
      self.bn_proj = _batch_norm(out_channels)

  def forward(self, x: torch.Tensor, film_params: FilmParams, train: bool,
              state: State) -> torch.Tensor:
    if self.bottleneck:
      y = F.relu(_bn(self, "bn1", _conv(x, self.conv1), train, state))
      y = F.relu(_bn(self, "bn2", _conv(y, self.conv2, self.strides), train,
                     state))
      y = _bn(self, "bn3", _conv(y, self.conv3), train, state)
    else:
      y = F.relu(_bn(self, "bn1", _conv(x, self.conv1, self.strides), train,
                     state))
      y = _bn(self, "bn2", _conv(y, self.conv2), train, state)
    y = _film(y, film_params)
    shortcut = x
    if self.has_proj:
      shortcut = _bn(self, "bn_proj", _conv(x, self.proj, self.strides),
                     train, state)
    return F.relu(y + shortcut)


class _BlockV2(nn.Module):
  """Pre-activation block: batch norm + relu before each conv, the
  shortcut taps the pre-activated input (projected where the channels or
  the stride change), FiLM after the last batch norm at `filters` width,
  before the relu and the final conv; no relu after the sum."""

  def __init__(self, in_channels: int, filters: int, strides: int,
               bottleneck: bool):
    super().__init__()
    self.strides = strides
    self.bottleneck = bottleneck
    out_channels = 4 * filters if bottleneck else filters
    self.bn1 = _batch_norm(in_channels)
    self.has_proj = in_channels != out_channels or strides != 1
    if self.has_proj:
      self.proj = nn.Conv2d(in_channels, out_channels, 1, bias=False)
    if bottleneck:
      self.conv1 = nn.Conv2d(in_channels, filters, 1, bias=False)
      self.bn2 = _batch_norm(filters)
      self.conv2 = nn.Conv2d(filters, filters, 3, bias=False)
      self.bn3 = _batch_norm(filters)
      self.conv3 = nn.Conv2d(filters, out_channels, 1, bias=False)
    else:
      self.conv1 = nn.Conv2d(in_channels, filters, 3, bias=False)
      self.bn2 = _batch_norm(filters)
      self.conv2 = nn.Conv2d(filters, filters, 3, bias=False)

  def forward(self, x: torch.Tensor, film_params: FilmParams, train: bool,
              state: State) -> torch.Tensor:
    preact = F.relu(_bn(self, "bn1", x, train, state))
    shortcut = (_conv(preact, self.proj, self.strides) if self.has_proj
                else x)
    if self.bottleneck:
      y = F.relu(_bn(self, "bn2", _conv(preact, self.conv1), train, state))
      y = _bn(self, "bn3", _conv(y, self.conv2, self.strides), train, state)
      y = _conv(F.relu(_film(y, film_params)), self.conv3)
    else:
      y = _bn(self, "bn2", _conv(preact, self.conv1, self.strides), train,
              state)
      y = _conv(F.relu(_film(y, film_params)), self.conv2)
    return y + shortcut


class ResNet(nn.Module):
  """ResNet v1/v2 with optional FiLM conditioning.

  `forward(images, conditioning=None, train=False)` returns (features,
  endpoints, new batch statistics by name, {} unless training): features
  is the global average pool ([B, C]), or the logits with `num_classes`;
  endpoints maps `block_layer1..4` to NHWC activations and
  `final_reduce_mean` (and `logits`) to the pooled ones. A
  `condition_size` > 0 adds the `film_generator`; conditioning is then
  applied when given.
  """

  def __init__(self, in_channels: int = 3, resnet_size: int = 18,
               num_classes: Optional[int] = None,
               width_multiplier: float = 1.0, condition_size: int = 0,
               version: int = 1, dtype: Optional[torch.dtype] = None):
    super().__init__()
    if resnet_size not in RESNET_BLOCK_SIZES:
      raise ValueError(f"Unsupported resnet_size {resnet_size}; "
                       f"choose from {sorted(RESNET_BLOCK_SIZES)}")
    if version not in (1, 2):
      raise ValueError(f"version must be 1 or 2, got {version}")
    self.version = version
    self.dtype = dtype
    self.blocks_per_layer = tuple(RESNET_BLOCK_SIZES[resnet_size])
    bottleneck = resnet_size >= BOTTLENECK_FROM
    block_cls = _BlockV1 if version == 1 else _BlockV2
    base = [int(c * width_multiplier) for c in (64, 128, 256, 512)]
    if condition_size:
      film_width = 4 if (bottleneck and version == 1) else 1
      self.film_generator = LinearFilmGenerator(
          condition_size, [c * film_width for c in base],
          self.blocks_per_layer)
    else:
      self.film_generator = None
    self.conv_stem = nn.Conv2d(in_channels, base[0], 7, bias=False)
    if version == 1:
      self.bn_stem = _batch_norm(base[0])
    channels = base[0]
    for layer, (filters, n_blocks) in enumerate(
        zip(base, self.blocks_per_layer)):
      for block in range(n_blocks):
        strides = 2 if (block == 0 and layer > 0) else 1
        self.add_module(f"layer{layer + 1}_block{block}",
                        block_cls(channels, filters, strides, bottleneck))
        channels = 4 * filters if bottleneck else filters
    if version == 2:
      self.bn_final = _batch_norm(channels)
    self.logits = (nn.Linear(channels, num_classes) if num_classes is not None
                   else None)

  def forward(self, images: torch.Tensor,
              conditioning: Optional[torch.Tensor] = None,
              train: bool = False
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], State]:
    film_params = None
    if conditioning is not None:
      if self.film_generator is None:
        raise ValueError("conditioning given to a ResNet built with "
                         "condition_size=0")
      film_params = self.film_generator(conditioning)
    state: State = {}
    x = normalize_image(images, self.dtype).permute(0, 3, 1, 2)
    x = _conv(x, self.conv_stem, 2)
    if self.version == 1:
      x = F.relu(_bn(self, "bn_stem", x, train, state))
    x = flax_layers.max_pool(x, 3, 2)
    endpoints = {}
    for layer, n_blocks in enumerate(self.blocks_per_layer):
      for block in range(n_blocks):
        name = f"layer{layer + 1}_block{block}"
        block_state: State = {}
        x = getattr(self, name)(
            x, None if film_params is None else film_params[layer][block],
            train, block_state)
        state.update({f"{name}.{k}": v for k, v in block_state.items()})
      endpoints[f"block_layer{layer + 1}"] = x.permute(0, 2, 3, 1)
    if self.version == 2:
      x = F.relu(_bn(self, "bn_final", x, train, state))
    x = x.mean(dim=(2, 3))
    endpoints["final_reduce_mean"] = x
    if self.logits is not None:
      x = flax_layers.dense(x, self.logits.weight, self.logits.bias)
      endpoints["logits"] = x
    return x, endpoints, state
