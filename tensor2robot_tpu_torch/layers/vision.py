"""Vision towers with FiLM conditioning + pose heads.

Counterpart of `tensor2robot_tpu.layers.vision`: the Berkeley-Net conv
tower (`BerkeleyNet`), its high-res multi-scale variant
(`HighResBerkeleyNet`), FiLM parameter generators (`FilmParams`, `film`)
and the FC pose head with its bias transform (`PoseHead`). Images come in
NHWC (uint8 or float, the feature layout); the towers run NCHW. Layer
names are flax's (`conv_0`, `norm_0`, `film_0.film_proj`, `fc_0`,
`fc_norm_0`, `pose`, `bias_transform`, `spatial_softmax`), so `bridge.py`
carries a JAX tree across by name. torch layers are not lazy: the input
channels and the conditioning width are constructor arguments here.

The JAX package pins its initialisers and norms to the reference's slim
arg scopes; each layer here draws them in `initial_params(generator)`
(the seam `T2RModel.init_params` calls):

* conv kernels xavier uniform; conv biases 0.01, and only on the
  `normalizer='none'` path (a conv under a normalizer has no bias);
* the high-res tower's convs truncated_normal(0.1), zero biases;
* FC kernels truncated_normal(0.01) — flax's, a unit normal cut at +-2
  and scaled by 0.01 with no variance correction (std 0.0088); FC biases
  0.01 (the hidden FCs under layer_norm have none; the `pose` output
  layer does);
* the bias transform 0.01;
* LayerNorm eps 1e-12 (tf.contrib's, not flax's 1e-6), over the
  channels of each pixel (dim 1 of NCHW); BatchNorm momentum 0.99, eps
  1e-4, no scale.

`PipelinedBerkeleyTower` is the tower's conv stack as heterogeneous
pipeline stages (`parallel.pipeline_parallel`): conv -> LayerNorm ->
(FiLM) -> relu per stage, every stage's parameters raveled in flax's key
order and shapes (HWIO kernels) into one [S, P_max] leaf, `pp_stages`,
which `bridge.py` copies as it is; each stage permutes its kernel to
torch's layout when it runs. It returns the NHWC feature map.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tensor2robot_tpu_torch.layers import flax_layers
from tensor2robot_tpu_torch.layers.spatial_softmax import SpatialSoftmax
from tensor2robot_tpu_torch.models import abstract as abstract_model
from tensor2robot_tpu_torch.ops.image_norm import normalize_image
from tensor2robot_tpu_torch.parallel import pipeline_parallel as pp_lib

__all__ = ["FilmParams", "film", "BerkeleyNet", "HighResBerkeleyNet",
           "PipelinedBerkeleyTower", "PoseHead", "xavier_uniform_", "truncated_normal_",
           "BATCH_NORM_DECAY", "BATCH_NORM_EPSILON", "LAYER_NORM_EPSILON"]

BATCH_NORM_DECAY = 0.99
BATCH_NORM_EPSILON = 1e-4
LAYER_NORM_EPSILON = 1e-12
CONV_BIAS = 0.01
FC_BIAS = 0.01
BIAS_TRANSFORM_INIT = 0.01
FC_KERNEL_STDDEV = 0.01
HIGH_RES_KERNEL_STDDEV = 0.1

Init = Callable[[torch.Tensor, torch.Generator], None]


def xavier_uniform_(weight: torch.Tensor, generator: torch.Generator) -> None:
  """flax `xavier_uniform()`: U(+-sqrt(6 / (fan_in + fan_out))), the fans
  counting the kernel's receptive field, as torch's does for OIHW."""
  nn.init.xavier_uniform_(weight, generator=generator)


def truncated_normal_(stddev: float) -> Init:
  """flax `truncated_normal(stddev)`: a unit normal truncated at +-2,
  times `stddev` (no variance correction)."""

  def init(weight: torch.Tensor, generator: torch.Generator) -> None:
    nn.init.trunc_normal_(weight, std=stddev, a=-2 * stddev, b=2 * stddev,
                          generator=generator)

  return init


class _Conv(nn.Conv2d):
  """A conv's parameters with their own initialisers."""

  def __init__(self, in_channels: int, out_channels: int, kernel: int,
               use_bias: bool, kernel_init: Init, bias_value: float):
    super().__init__(in_channels, out_channels, kernel, bias=use_bias)
    self._kernel_init = kernel_init
    self._bias_value = bias_value

  def initial_params(self, generator: torch.Generator
                     ) -> Dict[str, torch.Tensor]:
    weight = torch.empty_like(self.weight, device="cpu")
    self._kernel_init(weight, generator)
    out = {"weight": weight}
    if self.bias is not None:
      out["bias"] = torch.full_like(self.bias, self._bias_value, device="cpu")
    return out


class _Dense(nn.Linear):
  """A dense layer's parameters with their own initialisers."""

  def __init__(self, in_features: int, out_features: int, use_bias: bool,
               kernel_init: Init, bias_value: float):
    super().__init__(in_features, out_features, bias=use_bias)
    self._kernel_init = kernel_init
    self._bias_value = bias_value

  initial_params = _Conv.initial_params


class FilmParams(nn.Module):
  """Per-channel (gamma, beta) from a conditioning vector: one Dense
  `film_proj` (flax's default init) to 2 x channels, split in two."""

  def __init__(self, condition_size: int, num_channels: int):
    super().__init__()
    self.film_proj = nn.Linear(condition_size, 2 * num_channels)

  def forward(self, conditioning: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    gamma, beta = self.film_proj(conditioning).chunk(2, dim=-1)
    return gamma, beta


def film(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor
         ) -> torch.Tensor:
  """Feature-wise linear modulation of NCHW `x`: (1 + gamma) * x + beta."""
  return (1.0 + gamma[:, :, None, None]) * x + beta[:, :, None, None]


def _nhwc(x: torch.Tensor) -> torch.Tensor:
  return x.permute(0, 2, 3, 1)


class BerkeleyNet(nn.Module):
  """Conv tower -> spatial softmax feature points: a few stride-s convs,
  each followed by its normalizer, optional FiLM and relu, then the
  spatial soft arg-max ([B, C_last * 2]); without it the NHWC map,
  flattened ([B, H * W * C]) or not.

  `forward(images, conditioning=None, train=False)` returns (output, new
  batch-norm statistics by name, {} unless batch_norm trains)."""

  def __init__(self, in_channels: int,
               filters: Sequence[int] = (64, 32, 32),
               kernel_sizes: Sequence[int] = (7, 3, 3),
               strides: Sequence[int] = (2, 1, 1),
               use_spatial_softmax: bool = True,
               flatten: bool = True,
               normalizer: str = "layer_norm",
               condition_size: int = 0,
               dtype: Optional[torch.dtype] = None,
               conv_kernel_init: Init = xavier_uniform_,
               conv_bias: float = CONV_BIAS):
    super().__init__()
    if normalizer not in ("layer_norm", "batch_norm", "none"):
      raise ValueError(f"normalizer must be 'layer_norm', 'batch_norm' or "
                       f"'none', got {normalizer!r}")
    layers = list(zip(filters, kernel_sizes, strides))  # as flax zips them
    self.strides = tuple(s for _, _, s in layers)
    self.normalizer = normalizer
    self.use_spatial_softmax = use_spatial_softmax
    self.flatten = flatten
    self.dtype = dtype
    channels = in_channels
    for i, (f, k, _) in enumerate(layers):
      self.add_module(f"conv_{i}", _Conv(channels, f, k,
                                         normalizer == "none",
                                         conv_kernel_init, conv_bias))
      if normalizer == "batch_norm":
        self.add_module(f"norm_{i}", flax_layers.BatchNorm(
            f, use_scale=False, momentum=BATCH_NORM_DECAY,
            epsilon=BATCH_NORM_EPSILON))
      elif normalizer == "layer_norm":
        self.add_module(f"norm_{i}", nn.LayerNorm(f, eps=LAYER_NORM_EPSILON))
      if condition_size:
        self.add_module(f"film_{i}", FilmParams(condition_size, f))
      channels = f
    if use_spatial_softmax:
      self.spatial_softmax = SpatialSoftmax()

  def forward(self, images: torch.Tensor,
              conditioning: Optional[torch.Tensor] = None,
              train: bool = False
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    x = normalize_image(images, self.dtype).permute(0, 3, 1, 2)
    new_state: Dict[str, torch.Tensor] = {}
    for i, stride in enumerate(self.strides):
      conv = getattr(self, f"conv_{i}")
      x = flax_layers.conv2d(x, conv.weight, conv.bias, stride=stride)
      if self.normalizer == "batch_norm":
        x, stats = getattr(self, f"norm_{i}")(x, train)
        new_state.update({f"norm_{i}.{k}": v for k, v in stats.items()})
      elif self.normalizer == "layer_norm":
        norm = getattr(self, f"norm_{i}")
        x = flax_layers.layer_norm(x, norm.weight, norm.bias,
                                   LAYER_NORM_EPSILON)
      if conditioning is not None:
        gamma, beta = getattr(self, f"film_{i}")(conditioning.to(x.dtype))
        x = film(x, gamma, beta)
      x = F.relu(x)
    if self.use_spatial_softmax:
      return self.spatial_softmax(x, train=train), new_state
    x = _nhwc(x)
    return (x.reshape(x.shape[0], -1) if self.flatten else x), new_state


class PipelinedBerkeleyTower(nn.Module):
  """BerkeleyNet's conv stack as heterogeneous pipeline stages, the
  semantics of `BerkeleyNet(normalizer='layer_norm')` without spatial
  softmax: per stage a bias-free SAME conv, a LayerNorm over the channels
  (statistics in float32, eps 1e-12), FiLM from the conditioning vector
  when `condition_size`, relu. Stage parameters live in one [S, P_max]
  leaf `pp_stages`, stage s's flax tree ({`film_bias`, `film_kernel`,
  `kernel` (HWIO), `ln_bias`, `ln_scale`}) raveled in key order and
  zero-padded. Activations travel as flat NHWC rows padded to the widest
  stage's width, the conditioning vector riding at the end.

  torch layers are not lazy: the input's (height, width, channels) are
  constructor arguments. `forward(images, conditioning=None,
  train=False)` returns (the NHWC map [B, H', W', C'], {}). With a `mesh`
  whose `axis_name` has more than one rank the stages run the GPipe
  schedule over `num_microbatches` microbatches, and `pp_stages` is this
  rank's [1, P_max] block (the mesh train step's stage-local leaf).
  Without one, the sequential schedule: the same function."""

  def __init__(self, image_shape: Tuple[int, int, int],
               filters: Sequence[int] = (64, 32, 32),
               kernel_sizes: Sequence[int] = (7, 3, 3),
               strides: Sequence[int] = (2, 1, 1),
               condition_size: int = 0,
               mesh=None, axis_name: str = "pp", batch_axis: str = "data",
               num_microbatches: int = 4,
               dtype: Optional[torch.dtype] = None):
    super().__init__()
    self.filters = tuple(filters)
    self.kernel_sizes = tuple(kernel_sizes)
    self.strides = tuple(strides)
    self.condition_size = condition_size
    self.mesh = mesh
    self.axis_name = axis_name
    self.batch_axis = batch_axis
    self.num_microbatches = num_microbatches
    self.dtype = dtype
    height, width, channels = image_shape
    self.geometry = []
    for f, stride in zip(self.filters, self.strides):
      out_h, out_w = -(-height // stride), -(-width // stride)
      self.geometry.append(((height, width, channels), (out_h, out_w, f)))
      height, width, channels = out_h, out_w, f
    _, self.unravels, self.sizes = pp_lib.ravel_stage_stack(
        [{name: torch.zeros(shape) for name, shape in stage.items()}
         for stage in self._stage_shapes()])
    self.a_max = max(int(np.prod(shape)) for in_out in self.geometry
                     for shape in in_out) + condition_size
    self.pp_stages = nn.Parameter(torch.zeros(len(self.geometry),
                                              max(self.sizes)))

  def _stage_shapes(self):
    """Each stage's flax parameter shapes."""
    stages = []
    for i, ((_, _, cin), (_, _, cout)) in enumerate(self.geometry):
      k = self.kernel_sizes[i]
      shapes = {"kernel": (k, k, cin, cout), "ln_scale": (cout,),
                "ln_bias": (cout,)}
      if self.condition_size:
        shapes["film_kernel"] = (self.condition_size, 2 * cout)
        shapes["film_bias"] = (2 * cout,)
      stages.append(shapes)
    return stages

  def initial_params(self, generator: torch.Generator
                     ) -> Dict[str, torch.Tensor]:
    """flax's: kernels xavier uniform over HWIO fans, LayerNorm scale 1
    and bias 0, FiLM kernels lecun normal, FiLM biases 0."""

    stages = []
    for shapes in self._stage_shapes():
      params = {}
      for name in sorted(shapes):
        shape = shapes[name]
        if name == "kernel":
          k, _, cin, cout = shape
          bound = math.sqrt(6.0 / (k * k * cin + k * k * cout))
          params[name] = (torch.rand(shape, generator=generator) * 2.0
                          - 1.0) * bound
        elif name == "film_kernel":
          weight = torch.empty(shape[::-1])  # torch's [out, in]
          abstract_model.lecun_normal_(weight, generator)
          params[name] = weight.T.contiguous()
        elif name == "ln_scale":
          params[name] = torch.ones(shape)
        else:
          params[name] = torch.zeros(shape)
      stages.append(params)
    stacked, _, _ = pp_lib.ravel_stage_stack(stages)
    return {"pp_stages": stacked}

  def _stage_fn(self, i: int):
    (in_h, in_w, cin), _ = self.geometry[i]
    stride = self.strides[i]
    in_size = in_h * in_w * cin
    cond = self.condition_size

    def stage_fn(p, flat):
      mb = flat.shape[0]
      compute = self.dtype or flat.dtype
      act = flat[:, :in_size].reshape(mb, in_h, in_w, cin).to(compute)
      y = flax_layers.conv2d(act.permute(0, 3, 1, 2),
                             p["kernel"].permute(3, 2, 0, 1).to(compute),
                             stride=stride)
      # LayerNorm over the channels, statistics in float32 (jnp.var).
      wide = y.float()
      mean = wide.mean(dim=1, keepdim=True)
      var = wide.var(dim=1, keepdim=True, unbiased=False)
      y = ((wide - mean) * torch.rsqrt(var + LAYER_NORM_EPSILON)).to(compute)
      y = (y * p["ln_scale"].to(compute)[:, None, None]
           + p["ln_bias"].to(compute)[:, None, None])
      if cond:
        cvec = flat[:, in_size:in_size + cond].to(compute)
        out_film = cvec @ p["film_kernel"].to(compute) \
            + p["film_bias"].to(compute)
        gamma, beta = out_film.chunk(2, dim=-1)
        y = film(y, gamma, beta)
      y = F.relu(y).permute(0, 2, 3, 1).reshape(mb, -1)
      if cond:
        y = torch.cat([y, flat[:, in_size:in_size + cond].to(y.dtype)], -1)
      return y

    return stage_fn

  def forward(self, images: torch.Tensor,
              conditioning: Optional[torch.Tensor] = None,
              train: bool = False
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:

    del train  # no train-mode behaviour
    if bool(self.condition_size) != (conditioning is not None):
      raise ValueError("condition_size and conditioning must agree")
    x = normalize_image(images, self.dtype)
    batch = x.shape[0]
    flat_in = x.reshape(batch, -1)
    if self.condition_size:
      flat_in = torch.cat([flat_in, conditioning.to(flat_in.dtype)], -1)
    flat_in = F.pad(flat_in, (0, self.a_max - flat_in.shape[-1]))
    stage_fns = [self._stage_fn(i) for i in range(len(self.geometry))]
    if self.mesh is not None:
      m = self.num_microbatches
      if batch % m:
        raise ValueError(
            f"batch size {batch} not divisible into {m} microbatches")
      out = pp_lib.pipelined_apply_heterogeneous(
          stage_fns, self.unravels, self.sizes, self.pp_stages,
          flat_in.reshape(m, batch // m, self.a_max), self.mesh,
          axis_name=self.axis_name, batch_axis=self.batch_axis, local=True)
    else:
      out = pp_lib.sequential_apply_heterogeneous(
          stage_fns, self.unravels, self.sizes, self.pp_stages, flat_in[None])
    out_h, out_w, out_c = self.geometry[-1][1]
    features = out.reshape(batch, self.a_max)[:, :out_h * out_w * out_c]
    compute = self.dtype or features.dtype
    return features.reshape(batch, out_h, out_w, out_c).to(compute), {}


class HighResBerkeleyNet(nn.Module):
  """Multi-scale variant: the main tower (its convs truncated_normal(0.1)
  with zero biases) plus a high-resolution stream — one 3x3 stride-1
  conv (`high_res_conv`, with a zero bias), relu, spatial softmax
  (`high_res_ssm`) — their feature points concatenated."""

  def __init__(self, in_channels: int,
               filters: Sequence[int] = (64, 32, 32),
               high_res_filters: int = 16,
               condition_size: int = 0,
               dtype: Optional[torch.dtype] = None):
    super().__init__()
    self.dtype = dtype
    init = truncated_normal_(HIGH_RES_KERNEL_STDDEV)
    self.main = BerkeleyNet(in_channels, filters=filters,
                            condition_size=condition_size, dtype=dtype,
                            conv_kernel_init=init, conv_bias=0.0)
    self.high_res_conv = _Conv(in_channels, high_res_filters, 3, True, init,
                               0.0)
    self.high_res_ssm = SpatialSoftmax()

  def forward(self, images: torch.Tensor,
              conditioning: Optional[torch.Tensor] = None,
              train: bool = False
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    # Normalized once, so both branches see the same scale and dtype.
    images = normalize_image(images, self.dtype)
    points, state = self.main(images, conditioning, train=train)
    hi = flax_layers.conv2d(images.permute(0, 3, 1, 2),
                            self.high_res_conv.weight,
                            self.high_res_conv.bias)
    hi_points = self.high_res_ssm(F.relu(hi), train=train)
    return (torch.cat([points, hi_points], dim=-1),
            {f"main.{k}": v for k, v in state.items()})


class PoseHead(nn.Module):
  """FC pose regression head with an optional bias transform: a learned
  vector (`bias_transform`, initialised at 0.01) concatenated to every
  row's features, the MAML bias-transform trick. Hidden layers under
  `layer_norm` are matmul without bias -> LayerNorm -> relu; with
  `normalizer='none'` plain biased FCs; the output layer `pose` carries
  a 0.01 bias."""

  def __init__(self, in_features: int, output_size: int = 7,
               hidden_sizes: Sequence[int] = (100, 100),
               bias_transform_size: int = 0,
               normalizer: str = "layer_norm",
               dtype: Optional[torch.dtype] = None):
    super().__init__()
    if normalizer not in ("layer_norm", "none"):
      raise ValueError(f"normalizer must be 'layer_norm' or 'none', got "
                       f"{normalizer!r}")
    self.normalizer = normalizer
    self.num_hidden = len(hidden_sizes)
    self.dtype = dtype
    kernel_init = truncated_normal_(FC_KERNEL_STDDEV)
    if bias_transform_size:
      self.bias_transform = nn.Parameter(torch.full((bias_transform_size,),
                                                    BIAS_TRANSFORM_INIT))
    else:
      self.register_parameter("bias_transform", None)
    width = in_features + bias_transform_size
    for i, size in enumerate(hidden_sizes):
      self.add_module(f"fc_{i}", _Dense(width, size, normalizer == "none",
                                        kernel_init, FC_BIAS))
      if normalizer == "layer_norm":
        self.add_module(f"fc_norm_{i}", nn.LayerNorm(size,
                                                     eps=LAYER_NORM_EPSILON))
      width = size
    self.pose = _Dense(width, output_size, True, kernel_init, FC_BIAS)

  def initial_params(self, generator: torch.Generator
                     ) -> Dict[str, torch.Tensor]:
    """The bias transform (the FC layers draw their own)."""
    del generator  # a constant
    if self.bias_transform is None:
      return {}
    return {"bias_transform": torch.full_like(self.bias_transform,
                                              BIAS_TRANSFORM_INIT,
                                              device="cpu")}

  def forward(self, features: torch.Tensor, train: bool = False
              ) -> torch.Tensor:
    del train  # no train-mode behaviour
    x = features
    if self.bias_transform is not None:
      tiled = self.bias_transform[None].to(x.dtype).expand(x.shape[0], -1)
      x = torch.cat([x, tiled], dim=-1)
    for i in range(self.num_hidden):
      x = getattr(self, f"fc_{i}")(x)
      if self.normalizer == "layer_norm":
        norm = getattr(self, f"fc_norm_{i}")
        x = flax_layers.layer_norm(x, norm.weight, norm.bias,
                                   LAYER_NORM_EPSILON, dim=-1)
      x = F.relu(x)
    return self.pose(x)
