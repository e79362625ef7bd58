"""Mixture density network head (diagonal-Gaussian mixtures).

Counterpart of `tensor2robot_tpu.layers.mdn`: the parameter head
(`MDNHead`, one Dense `mdn_proj` to K * (2D + 1) values, computed in the
promoted dtype of its input and weights (bfloat16 under the bfloat16
policy) and cast to float32, log scales clamped at -7 before the
exp), the mixture log-density, ancestral sampling, the approximate mode
and `MDNDecoder`.

`mdn_sample` takes its draws as arguments: `gumbel` noise for the
component (the JAX package's `jax.random.categorical` is the argmax of
logits plus Gumbel noise) and a unit `normal` for the Gaussian, so a
test can hand it the JAX package's draws; `draw_mdn_sample` draws them
from a `torch.Generator` in the JAX package's key-split order
(component, then normal).

A model's output tree is a flat dict of tensors, so the parameters
travel as `<prefix>/logits`, `<prefix>/means` and `<prefix>/scales`
(`as_outputs`, `from_outputs`).
"""

from __future__ import annotations

import math
from typing import Mapping, NamedTuple, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from tensor2robot_tpu_torch.layers import flax_layers

__all__ = ["MDNParams", "MDNHead", "mdn_log_prob", "mdn_sample",
           "draw_mdn_sample", "mdn_approximate_mode", "MDNDecoder",
           "as_outputs", "from_outputs"]

_MIN_LOG_SCALE = -7.0


class MDNParams(NamedTuple):
  """[..., K] mixture logits; [..., K, D] means and (positive) scales."""

  logits: torch.Tensor
  means: torch.Tensor
  scales: torch.Tensor


def as_outputs(params: MDNParams, prefix: str = "mdn_params"):
  """The parameters as flat output keys `<prefix>/<field>`."""
  return {f"{prefix}/{field}": value
          for field, value in zip(MDNParams._fields, params)}


def from_outputs(outputs: Mapping[str, torch.Tensor],
                 prefix: str = "mdn_params") -> MDNParams:
  """`MDNParams` back from the flat keys `as_outputs` wrote."""
  return MDNParams(*(outputs[f"{prefix}/{field}"]
                     for field in MDNParams._fields))


class MDNHead(nn.Module):
  """features [..., in] -> `MDNParams` of K components over D dims."""

  def __init__(self, in_features: int, num_components: int,
               output_size: int):
    super().__init__()
    self.num_components = num_components
    self.output_size = output_size
    self.mdn_proj = nn.Linear(in_features,
                              num_components * (2 * output_size + 1))

  def forward(self, features: torch.Tensor) -> MDNParams:
    k, d = self.num_components, self.output_size
    raw = flax_layers.dense(features, self.mdn_proj.weight,
                            self.mdn_proj.bias)
    raw = raw.to(torch.promote_types(raw.dtype, torch.float32))
    lead = raw.shape[:-1]
    logits = raw[..., :k]
    means = raw[..., k:k + k * d].reshape(lead + (k, d))
    log_scales = raw[..., k + k * d:].reshape(lead + (k, d))
    scales = torch.exp(torch.clamp(log_scales, min=_MIN_LOG_SCALE))
    return MDNParams(logits=logits, means=means, scales=scales)


def mdn_log_prob(params: MDNParams, value: torch.Tensor) -> torch.Tensor:
  """log p(value) under the mixture; value [..., D] -> [...]."""
  value = value[..., None, :]  # broadcast over components
  z = (value - params.means) / params.scales
  component_log_prob = (-0.5 * (z ** 2).sum(-1)
                        - torch.log(params.scales).sum(-1)
                        - 0.5 * value.shape[-1] * math.log(2.0 * math.pi))
  mixture_log_weights = F.log_softmax(params.logits, dim=-1)
  return torch.logsumexp(mixture_log_weights + component_log_prob, dim=-1)


def _select(params: MDNParams, component: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor]:
  # A comparison, not F.one_hot, whose range check vmap cannot trace.
  ids = torch.arange(params.logits.shape[-1], device=component.device)
  one_hot = (component[..., None] == ids).to(params.means.dtype)
  return ((one_hot[..., None] * params.means).sum(-2),
          (one_hot[..., None] * params.scales).sum(-2))


def mdn_sample(params: MDNParams, gumbel: torch.Tensor,
               normal: torch.Tensor) -> torch.Tensor:
  """Ancestral sampling: the component argmax(logits + gumbel) ([..., K]
  noise), then mean + scale * normal ([..., D])."""
  component = torch.argmax(params.logits + gumbel, dim=-1)
  mean, scale = _select(params, component)
  return mean + scale * normal


def draw_mdn_sample(generator: torch.Generator, params: MDNParams
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
  """`mdn_sample`'s (gumbel, normal) draws, drawn on the generator's
  device and moved to the parameters'."""
  shape_k = tuple(params.logits.shape)
  shape_d = shape_k[:-1] + (params.means.shape[-1],)
  uniform = torch.rand(shape_k, generator=generator,
                       device=generator.device, dtype=torch.float64)
  uniform = uniform.clamp(min=torch.finfo(torch.float32).tiny)
  gumbel = -torch.log(-torch.log(uniform))
  normal = torch.randn(shape_d, generator=generator, device=generator.device)
  device, dtype = params.means.device, params.means.dtype
  return gumbel.to(device, dtype), normal.to(device, dtype)


def mdn_approximate_mode(params: MDNParams) -> torch.Tensor:
  """Mean of the most probable component."""
  mean, _ = _select(params, torch.argmax(params.logits, dim=-1))
  return mean


class MDNDecoder(nn.Module):
  """features -> (mode action, params); the loss is -log_prob."""

  def __init__(self, in_features: int, num_components: int,
               output_size: int):
    super().__init__()
    self.head = MDNHead(in_features, num_components, output_size)

  def forward(self, features: torch.Tensor
              ) -> Tuple[torch.Tensor, MDNParams]:
    params = self.head(features)
    return mdn_approximate_mode(params), params

  @staticmethod
  def loss(params: MDNParams, target: torch.Tensor) -> torch.Tensor:
    return -mdn_log_prob(params, target).mean()
