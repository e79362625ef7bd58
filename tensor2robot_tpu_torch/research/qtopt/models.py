"""QT-Opt: the vision-based grasping Q-function (the flagship family).

Counterpart of `tensor2robot_tpu.research.qtopt.models`:

* `GraspingCNN` — the small critic (stride-2 conv stem with LayerNorm,
  the action embedding broadcast-added mid-tower, a dense head, sigmoid).
* `Grasping44` — the reference-scale tower: a 6x6/2 stem conv and
  batch norm, 3x3/3 max-pool, `num_convs[0]` 5x5 convs, 3x3/3 pool, the
  grasp-param blocks (each its own Dense(256), summed in sorted name
  order) -> BN -> Dense(64) -> BN context broadcast-added onto the image
  embedding, `num_convs[1]` 3x3 convs, 2x2/2 pool, `num_convs[2]` VALID
  3x3 convs, flatten, `hid_layers` Dense(64) + BN, a logit and a sigmoid
  (or softmax). Every conv and dense kernel starts from a 0.01 truncated
  normal; batch norm decays at 0.9997 with eps 1e-3.
* `QTOptModel` — the critic with the published recipe: momentum 0.9,
  exponential-decay learning rate, EMA 0.9999, and for Grasping44 a
  decoupled weight decay of 7e-5 on the conv and dense kernels.

The tensors are NCHW inside the towers; the image arrives NHWC, as the
JAX package takes it, and the tower is permuted back to NHWC before its
flatten, so `fc0`'s rows line up with a bridged flax kernel. Module names
follow flax's, so `bridge.py` maps a flax tree onto the `state_dict`.

CEM action batches: grasp params of shape [B, A, P] tile the pooled
image embedding (not the raw image) A times mid-tower and return
predictions [B, A]; rank-2 state vectors are broadcast over A.

The space-to-depth stem (`space_to_depth=True`) folds each 2x2 block of
pixels into channels and runs the 6x6/2 stem as the exactly equivalent
3x3/1 conv `conv1_1_s2d`; `stem_kernel_to_s2d` maps a stem kernel onto
it. `QTOptModel.model_task_losses_fn` gives PCGrad its two tasks.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tensor2robot_tpu_torch import modes as modes_lib
from tensor2robot_tpu_torch.layers import flax_layers
from tensor2robot_tpu_torch.models import heads
from tensor2robot_tpu_torch.models import optimizers as optimizers_lib
from tensor2robot_tpu_torch.ops.image_norm import normalize_image
from tensor2robot_tpu_torch.specs import SpecStruct, TensorSpec
from tensor2robot_tpu_torch.utils import config

__all__ = ["GraspingCNN", "Grasping44", "QTOptModel", "trunc_normal_001_",
           "stem_kernel_to_s2d", "space_to_depth"]

LAYERNORM_EPS = 1e-6  # flax nn.LayerNorm's default, not torch's 1e-5


def trunc_normal_001_(weight: torch.Tensor,
                      generator: torch.Generator) -> None:
  """jax `truncated_normal(stddev=0.01)`: a unit normal truncated at +-2,
  scaled by 0.01 with no std correction (values in [-0.02, 0.02], std
  0.0088) — the same distribution as torch's normal(0, 0.01) truncated
  at +-0.02."""
  nn.init.trunc_normal_(weight, std=0.01, a=-0.02, b=0.02,
                        generator=generator)


def _with_init(layer: nn.Module, init) -> nn.Module:
  """`layer` with its kernel initializer for `T2RModel.init_params`."""
  layer.kernel_init = init
  return layer


def _state_vectors(features, ranks: Tuple[int, ...]):
  """The action, then every other `state/` leaf of a rank in `ranks`
  (not the image), in sorted key order."""
  vectors = [features["action/action"]]
  for key in sorted(features):
    if key.startswith("state/") and key != "state/image" \
        and features[key].ndim in ranks:
      vectors.append(features[key])
  return vectors


def _ceil_div(size: int, stride: int) -> int:
  """A 'SAME' layer's output size."""
  return -(-size // stride)


def _nhwc_flatten(x: torch.Tensor) -> torch.Tensor:
  return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)


def stem_kernel_to_s2d(kernel: torch.Tensor) -> torch.Tensor:
  """Maps an OIHW [O, C, 6, 6] stride-2 stem kernel to the exactly
  equivalent [O, 4C, 3, 3] space-to-depth kernel:
  w_s2d[o, (py * 2 + px) * C + c, ki, kj] = w[o, c, 2 ki + py, 2 kj + px].
  The stem's bias carries over unchanged."""
  o, c, kh, kw = kernel.shape
  if kh != 6 or kw != 6:
    raise ValueError(f"expected an [O, C, 6, 6] stem kernel, got "
                     f"{tuple(kernel.shape)}")
  # [O, C, ki, py, kj, px] -> [O, py, px, C, ki, kj]
  k = kernel.reshape(o, c, 3, 2, 3, 2).permute(0, 3, 5, 1, 2, 4)
  return k.reshape(o, 4 * c, 3, 3)


def space_to_depth(x: torch.Tensor) -> torch.Tensor:
  """NCHW [B, C, H, W] -> [B, 4C, H/2, W/2], channel (py * 2 + px) * C + c
  holding pixel (2i + py, 2j + px) of channel c: the channel order of the
  JAX package's NHWC fold. H and W must be even."""
  b, c, h, w = x.shape
  if h % 2 or w % 2:
    raise ValueError(
        f"space_to_depth stem needs even spatial dims, got {h}x{w}")
  x = x.reshape(b, c, h // 2, 2, w // 2, 2).permute(0, 3, 5, 1, 2, 4)
  return x.reshape(b, 4 * c, h // 2, w // 2)


class GraspingCNN(nn.Module):
  """The small grasping Q-network: stride-2 conv stem + LayerNorm, action
  embedding added mid-tower, dense head, sigmoid Q. `vector_size` is the
  width of the action plus any rank-2 state vectors."""

  def __init__(self, image_size: int, image_channels: int, vector_size: int,
               stem_filters: Sequence[int] = (32, 32, 32),
               post_merge_filters: Sequence[int] = (32, 32),
               action_embedding_size: int = 32,
               head_hidden_sizes: Sequence[int] = (64, 64),
               dtype: Optional[torch.dtype] = None):
    super().__init__()
    self.dtype = dtype
    self.num_stem, self.num_merge = len(stem_filters), len(post_merge_filters)
    self.num_fc = len(head_hidden_sizes)
    channels, size = image_channels, image_size
    for prefix, filters in (("stem", stem_filters),
                            ("merge", post_merge_filters)):
      for i, f in enumerate(filters):
        self.add_module(f"{prefix}_{i}", nn.Conv2d(channels, f, 3))
        self.add_module(f"{prefix}_norm_{i}",
                        nn.LayerNorm(f, eps=LAYERNORM_EPS))
        channels, size = f, _ceil_div(size, 2)
      if prefix == "stem":
        self.action_embed = nn.Linear(vector_size, action_embedding_size)
        self.action_proj = nn.Linear(action_embedding_size, channels)
    width = size * size * channels
    for i, hidden in enumerate(head_hidden_sizes):
      self.add_module(f"fc_{i}", nn.Linear(width, hidden))
      width = hidden
    self.q = nn.Linear(width, 1)

  def _conv_norm(self, name: str, norm: str, x: torch.Tensor) -> torch.Tensor:
    conv, ln = getattr(self, name), getattr(self, norm)
    x = flax_layers.conv2d(x, conv.weight, conv.bias, stride=2)
    return F.relu(flax_layers.layer_norm(x, ln.weight, ln.bias,
                                         LAYERNORM_EPS))

  def forward(self, features, mode: str = modes_lib.PREDICT,
              train: bool = False):
    """(outputs, {}): LayerNorm holds no running statistics."""
    x = normalize_image(features["state/image"], self.dtype)
    x = x.permute(0, 3, 1, 2)  # NHWC -> NCHW
    for i in range(self.num_stem):
      x = self._conv_norm(f"stem_{i}", f"stem_norm_{i}", x)
    context = torch.cat(
        [v.to(x.dtype) for v in _state_vectors(features, (2,))], dim=-1)
    context = self.action_proj(F.relu(self.action_embed(context)))
    x = x + context[:, :, None, None]
    for i in range(self.num_merge):
      x = self._conv_norm(f"merge_{i}", f"merge_norm_{i}", x)
    x = _nhwc_flatten(x)
    for i in range(self.num_fc):
      x = F.relu(getattr(self, f"fc_{i}")(x))
    return SpecStruct({"q_predicted": torch.sigmoid(self.q(x))}), {}


class Grasping44(nn.Module):
  """The reference-scale grasping Q-network (see the module docstring).

  `grasp_param_size` is the width of the action plus any state vectors;
  `grasp_param_names` maps block names to (offset, size) slices of it.
  `goal_spatial_channels` / `goal_vector_size` widen `fc0` for the goal
  merges (flax infers the width when the module is initialised with the
  goal present; torch needs it up front). With `space_to_depth` the stem
  is `conv1_1_s2d`, a 3x3/1 SAME conv over the folded image: its (1, 1)
  padding of the folded rows is the (2, 2) padding flax's SAME gives the
  6x6/2 conv over an even H, so both sum the same 108 products for each
  output."""

  def __init__(self, image_size: int, image_channels: int,
               grasp_param_size: int,
               num_convs: Tuple[int, int, int] = (6, 6, 3),
               filters: int = 64,
               grasp_context_size: int = 64,
               fc_hidden_size: int = 64,
               hid_layers: int = 2,
               num_classes: int = 1,
               softmax: bool = False,
               batch_norm_decay: float = 0.9997,
               batch_norm_epsilon: float = 0.001,
               grasp_param_names: Optional[Dict[str, Tuple[int, int]]] = None,
               space_to_depth: bool = False,
               dtype: Optional[torch.dtype] = None,
               goal_spatial_channels: int = 0,
               goal_vector_size: int = 0):
    super().__init__()
    self.space_to_depth = space_to_depth
    self.dtype = dtype
    self.num_classes = num_classes
    self.softmax = softmax
    self.hid_layers = hid_layers
    self.blocks = (sorted(grasp_param_names.items()) if grasp_param_names
                   else [("fcgrasp", (0, grasp_param_size))])

    def dense(name, n_in, n_out, bias=True):
      self.add_module(name, _with_init(nn.Linear(n_in, n_out, bias=bias),
                                       trunc_normal_001_))

    def conv(name, n_in, kernel, stride=1, bias=False):
      self.add_module(name, _with_init(
          nn.Conv2d(n_in, filters, kernel, stride, bias=bias),
          trunc_normal_001_))

    def bn(name, n, use_scale=True):
      self.add_module(name, flax_layers.BatchNorm(
          n, use_scale=use_scale, momentum=batch_norm_decay,
          epsilon=batch_norm_epsilon))

    if space_to_depth:
      conv("conv1_1_s2d", 4 * image_channels, 3, bias=True)
    else:
      conv("conv1_1", image_channels, 6, stride=2, bias=True)
    bn("conv1_bn", filters, use_scale=False)
    size = _ceil_div(_ceil_div(image_size, 2), 3)  # stem /2, pool /3
    self.conv_names = ([], [], [])
    conv_id = 2
    for stage, kernel in ((0, 5), (1, 3), (2, 3)):
      if stage == 1:
        for name, (_, width) in self.blocks:
          dense(name, width, 256)
        bn("fcgrasp_bn", 256, use_scale=False)
        dense("fcgrasp2", 256, grasp_context_size, bias=False)
        bn("fcgrasp2_bn", grasp_context_size)
        self.has_proj = grasp_context_size != filters
        if self.has_proj:
          dense("fcgrasp_proj", grasp_context_size, filters)
      for _ in range(num_convs[stage]):
        conv(f"conv{conv_id}", filters, kernel)
        bn(f"conv{conv_id}_bn", filters)
        self.conv_names[stage].append(f"conv{conv_id}")
        conv_id += 1
      if stage == 0:
        size = _ceil_div(size, 3)
      elif stage == 1:
        size = _ceil_div(size, 2)
    size -= 2 * num_convs[2]  # VALID 3x3 convs
    width = size * size * (filters + goal_spatial_channels) + goal_vector_size
    for i in range(hid_layers):
      dense(f"fc{i}", width, fc_hidden_size, bias=False)
      bn(f"fc{i}_bn", fc_hidden_size)
      width = fc_hidden_size
    dense("logit", width, num_classes)

  def forward(self, features, mode: str = modes_lib.PREDICT,
              train: bool = False,
              goal_spatial: Optional[torch.Tensor] = None,
              goal_vector: Optional[torch.Tensor] = None):
    """(outputs, new batch-norm running stats): `q_predicted` and
    `logits`, [B, 1] (or [B, A] / [B, A, 1] for a [B, A, P] action
    batch); the stats dict is {} unless `train`."""
    stats: Dict[str, torch.Tensor] = {}

    def bn_relu(name: str, x: torch.Tensor) -> torch.Tensor:
      y, new = getattr(self, name)(x, train)
      stats.update({f"{name}.{k}": v for k, v in new.items()})
      return F.relu(y)

    def conv_bn(name: str, x: torch.Tensor, padding: str = "SAME"):
      layer = getattr(self, name)
      x = flax_layers.conv2d(x, layer.weight, layer.bias,
                             stride=layer.stride[0], padding=padding)
      return bn_relu("conv1_bn" if name.startswith("conv1_1")
                     else f"{name}_bn", x)

    net = normalize_image(features["state/image"], self.dtype)
    net = net.permute(0, 3, 1, 2)  # NHWC -> NCHW
    if self.space_to_depth:
      net = conv_bn("conv1_1_s2d", space_to_depth(net))
    else:
      net = conv_bn("conv1_1", net)
    net = flax_layers.max_pool(net, 3, 3)
    for name in self.conv_names[0]:
      net = conv_bn(name, net)
    net = flax_layers.max_pool(net, 3, 3)

    vectors = _state_vectors(features, (2, 3))
    action_batch = next((v.shape[1] for v in vectors if v.ndim == 3), None)
    if action_batch is not None:  # [B, A, P] CEM megabatch
      vectors = [v if v.ndim == 3 else v[:, None, :].expand(
          -1, action_batch, -1) for v in vectors]
    grasp = torch.cat([v.to(net.dtype) for v in vectors], dim=-1)
    if action_batch is not None:
      grasp = grasp.reshape(-1, grasp.shape[-1])
    fcgrasp = sum(getattr(self, name)(grasp[:, offset:offset + width])
                  for name, (offset, width) in self.blocks)
    fcgrasp = bn_relu("fcgrasp_bn", fcgrasp)
    fcgrasp = bn_relu("fcgrasp2_bn", self.fcgrasp2(fcgrasp))
    if self.has_proj:
      fcgrasp = self.fcgrasp_proj(fcgrasp)
    if action_batch is not None:
      net = torch.repeat_interleave(net, action_batch, dim=0)
    net = net + fcgrasp[:, :, None, None]

    for name in self.conv_names[1]:
      net = conv_bn(name, net)
    net = flax_layers.max_pool(net, 2, 2)
    for name in self.conv_names[2]:
      net = conv_bn(name, net, padding="VALID")

    batch = net.shape[0]
    if goal_spatial is not None:  # NHWC, tiled (not interleaved) as jnp.tile
      goal_spatial = goal_spatial.repeat(batch // goal_spatial.shape[0], 1,
                                         1, 1)
      net = torch.cat([net, goal_spatial.to(net.dtype).permute(0, 3, 1, 2)],
                      dim=1)
    net = _nhwc_flatten(net)
    if goal_vector is not None:
      goal_vector = goal_vector.repeat(batch // goal_vector.shape[0], 1)
      net = torch.cat([net, goal_vector.to(net.dtype)], dim=1)
    for i in range(self.hid_layers):
      net = bn_relu(f"fc{i}_bn", getattr(self, f"fc{i}")(net))
    logits = self.logit(net)
    predictions = (torch.softmax(logits, -1) if self.softmax
                   else torch.sigmoid(logits))
    if action_batch is not None:
      predictions = predictions.reshape(-1, action_batch, self.num_classes)
      if self.num_classes == 1:
        predictions = predictions[..., 0]
      logits = logits.reshape(-1, action_batch, self.num_classes)
    return SpecStruct({"q_predicted": predictions, "logits": logits}), stats


def _decay_mask(params: Dict[str, torch.Tensor]) -> Dict[str, bool]:
  """The leaves of rank > 1: conv and dense kernels, no bias or norm."""
  return {k: v.ndim > 1 for k, v in params.items()}


@config.configurable
class QTOptModel(heads.CriticModel):
  """The grasping critic with the reference's training recipe."""

  def __init__(self,
               image_size: int = 64,
               image_channels: int = 3,
               action_size: int = 4,
               extra_state_vector_size: int = 0,
               learning_rate: float = 1e-4,
               momentum: float = 0.9,
               lr_decay_steps: int = 10000,
               lr_decay_rate: float = 0.999,
               use_pcgrad: bool = False,
               network: str = "small",  # 'small' | 'grasping44'
               num_convs: Tuple[int, int, int] = (6, 6, 3),
               space_to_depth: bool = False,
               grasp_param_names: Optional[Dict[str, Tuple[int, int]]]
               = None,
               l2_regularization: float = 7e-5,
               optimizer_hparams: Optional[Dict] = None,
               **kwargs):
    # The HParams surface also governs EMA: use_avg_model_params and
    # model_weights_averaging map onto the model's EMA and its decay.
    if optimizer_hparams is not None:
      kwargs.setdefault("use_ema",
                        optimizer_hparams.get("use_avg_model_params", True))
      kwargs.setdefault("ema_decay",
                        optimizer_hparams.get("model_weights_averaging",
                                              0.9999))
    kwargs.setdefault("use_ema", True)
    kwargs.setdefault("ema_decay", 0.9999)
    super().__init__(**kwargs)
    if network not in ("small", "grasping44"):
      raise ValueError(f"Unknown network {network!r}")
    self._image_size = image_size
    self._image_channels = image_channels
    self._action_size = action_size
    self._extra_state_vector_size = extra_state_vector_size
    self._learning_rate = learning_rate
    self._momentum = momentum
    self._lr_decay_steps = lr_decay_steps
    self._lr_decay_rate = lr_decay_rate
    self.use_pcgrad = use_pcgrad
    self._network = network
    self._num_convs = tuple(num_convs)
    self._space_to_depth = space_to_depth
    self._grasp_param_names = grasp_param_names
    self._l2_regularization = l2_regularization
    self._optimizer_hparams = optimizer_hparams

  @property
  def network(self) -> str:
    return self._network

  def get_state_specification(self, mode):
    out = SpecStruct({
        "image": TensorSpec(
            shape=(self._image_size, self._image_size,
                   self._image_channels),
            dtype=np.uint8, name="state/image", data_format="jpeg"),
    })
    if self._extra_state_vector_size:
      out["params"] = TensorSpec(
          shape=(self._extra_state_vector_size,), dtype=np.float32,
          name="state/params")
    return out

  def get_action_specification(self, mode):
    return SpecStruct({
        "action": TensorSpec(shape=(self._action_size,), dtype=np.float32,
                             name="action/action"),
    })

  def create_module(self) -> nn.Module:
    dtype = self.compute_dtype if self.use_bfloat16 else None
    vector_size = self._action_size + self._extra_state_vector_size
    if self._network == "grasping44":
      return Grasping44(image_size=self._image_size,
                        image_channels=self._image_channels,
                        grasp_param_size=vector_size,
                        num_convs=self._num_convs,
                        grasp_param_names=self._grasp_param_names,
                        space_to_depth=self._space_to_depth, dtype=dtype)
    return GraspingCNN(image_size=self._image_size,
                       image_channels=self._image_channels,
                       vector_size=vector_size, dtype=dtype)

  def create_optimizer(self) -> optimizers_lib.GradientTransformation:
    if self._optimizer_fn is not None:
      return super().create_optimizer()
    if self._optimizer_hparams is not None:
      base = optimizers_lib.create_optimizer_from_hparams(
          self._optimizer_hparams)
    else:
      schedule = optimizers_lib.create_exponential_decay_learning_rate(
          initial_learning_rate=self._learning_rate,
          decay_steps=self._lr_decay_steps,
          decay_rate=self._lr_decay_rate)
      base = optimizers_lib.create_momentum_optimizer(
          learning_rate=schedule, momentum=self._momentum)
    if self._network == "grasping44" and self._l2_regularization:
      # l2 on the conv and dense kernels, as decoupled weight decay added
      # to the gradient before momentum.
      return optimizers_lib.chain(
          optimizers_lib.add_decayed_weights(self._l2_regularization,
                                             mask=_decay_mask),
          base)
    return base

  def model_task_losses_fn(self, features, labels, inference_outputs,
                           mode) -> Dict[str, torch.Tensor]:
    """The two tasks PCGrad would split: grasp-success regression and a
    Q-value magnitude regularizer."""
    q = inference_outputs[self.q_output_key]
    target = labels[self.reward_label_key]
    return {"bellman": torch.mean((q - target) ** 2),
            "q_regularizer": 1e-3 * torch.mean(q ** 2)}
