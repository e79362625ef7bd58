"""SNAIL: causal dilated temporal convolutions and causal attention.

Counterpart of `tensor2robot_tpu.layers.snail` over [B, T, C] sequences:
`CausalConv` (a left pad plus a VALID dilated conv; flax's kernel [k, in,
out] is torch's Conv1d weight [out, in, k]), `DenseBlock` (a gated causal
conv whose output joins the input), `TCBlock` (ceil(log2 T) dense blocks
with dilations 1, 2, 4, ...) and `AttentionBlock` (single-head causal
attention whose read joins the input). Module names are flax's (`filter`,
`gate`, `conv`, `dense_{i}`, `keys`, `queries`, `values`).

`dtype` is the compute dtype, as flax's `dtype=`: the convs and denses run
in it when given, else in the promoted dtype of input and parameters. The
attention masks with -1e9 in the logits' dtype and takes its softmax in
float32, then reads in the values' dtype. It is a few frames wide, one
head of 16: plain torch ops, no fused attention.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from tensor2robot_tpu_torch.layers import flax_layers

__all__ = ["CausalConv", "DenseBlock", "TCBlock", "AttentionBlock"]


class CausalConv(nn.Module):
  """1-D causal dilated conv over [B, T, C] -> [B, T, filters]."""

  def __init__(self, in_features: int, filters: int, kernel_size: int = 2,
               dilation: int = 1, dtype: Optional[torch.dtype] = None):
    super().__init__()
    self.pad = dilation * (kernel_size - 1)
    self.dilation = dilation
    self.dtype = dtype
    self.conv = nn.Conv1d(in_features, filters, kernel_size)

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    dtype = self.dtype or torch.promote_types(x.dtype,
                                              self.conv.weight.dtype)
    x = F.pad(x.to(dtype).transpose(1, 2), (self.pad, 0))
    y = F.conv1d(x, self.conv.weight.to(dtype), self.conv.bias.to(dtype),
                 dilation=self.dilation)
    return y.transpose(1, 2)


class DenseBlock(nn.Module):
  """tanh(filter conv) * sigmoid(gate conv), joined onto the input:
  [B, T, C] -> [B, T, C + filters]."""

  def __init__(self, in_features: int, filters: int, dilation: int = 1,
               dtype: Optional[torch.dtype] = None):
    super().__init__()
    self.filter = CausalConv(in_features, filters, dilation=dilation,
                             dtype=dtype)
    self.gate = CausalConv(in_features, filters, dilation=dilation,
                           dtype=dtype)

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    activations = torch.tanh(self.filter(x)) * torch.sigmoid(self.gate(x))
    return torch.cat([x, activations], dim=-1)


class TCBlock(nn.Module):
  """Dense blocks with dilations 1, 2, ..., 2^(n - 1), n = max(1,
  ceil(log2 sequence_length)): [B, T, C] -> [B, T, C + n * filters]."""

  def __init__(self, in_features: int, sequence_length: int, filters: int,
               dtype: Optional[torch.dtype] = None):
    super().__init__()
    self.num_blocks = max(1, int(math.ceil(math.log2(sequence_length))))
    for i in range(self.num_blocks):
      self.add_module(f"dense_{i}", DenseBlock(in_features + i * filters,
                                               filters, dilation=2 ** i,
                                               dtype=dtype))
    self.out_features = in_features + self.num_blocks * filters

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    for i in range(self.num_blocks):
      x = getattr(self, f"dense_{i}")(x)
    return x


class AttentionBlock(nn.Module):
  """Single-head causal attention, its read joined onto the input:
  [B, T, C] -> [B, T, C + value_size]."""

  def __init__(self, in_features: int, key_size: int, value_size: int,
               dtype: Optional[torch.dtype] = None):
    super().__init__()
    self.key_size = key_size
    self.dtype = dtype
    self.keys = nn.Linear(in_features, key_size)
    self.queries = nn.Linear(in_features, key_size)
    self.values = nn.Linear(in_features, value_size)
    self.out_features = in_features + value_size

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    t = x.shape[1]
    keys, queries, values = (
        flax_layers.dense(x, layer.weight, layer.bias, self.dtype)
        for layer in (self.keys, self.queries, self.values))
    logits = queries @ keys.transpose(1, 2) / math.sqrt(self.key_size)
    causal = torch.ones((t, t), dtype=torch.bool,
                        device=x.device).tril()
    logits = torch.where(causal, logits,
                         torch.tensor(-1e9, dtype=logits.dtype,
                                      device=x.device))
    attention = torch.softmax(logits.to(torch.float32), dim=-1)
    read = attention.to(values.dtype) @ values
    return torch.cat([x, read], dim=-1)
