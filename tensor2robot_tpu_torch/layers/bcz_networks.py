"""BC-Z network building blocks.

Counterpart of `tensor2robot_tpu.layers.bcz_networks`:

* `ConvGRUEncoder`: a per-frame `BerkeleyNet` torso (spatial softmax
  points) and a GRU over time, flax's `nn.RNN(nn.GRUCell)`, from a zero
  carry: [B, T, H, W, C] -> [B, T, hidden];
* `SnailEncoder`: TC blocks interleaved with causal attention;
* `MultiHeadMLP`: one MLP head per waypoint, the heads after the first
  fed `features.detach()` so only the first waypoint trains the trunk.

`GRUCell` is flax's cell in the layout `bridge.py` maps: the input denses
`ir`, `iz`, `in` (with biases) stacked by rows into `weight_ih` [3H, in]
and `bias_ih` [3H]; the recurrent denses `hr`, `hz`, `hn` into
`weight_hh` [3H, H], and `hn`'s bias (the only recurrent one, applied
inside r * (...)) as `bias_hn` [H]. As in flax the module sits beside the
torso as `GRUCell_0` (flax binds a cell made in a compact method to that
method's module, not to the `nn.RNN` around it).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from tensor2robot_tpu_torch.layers import flax_layers
from tensor2robot_tpu_torch.layers.snail import AttentionBlock, TCBlock
from tensor2robot_tpu_torch.layers.vision import BerkeleyNet
from tensor2robot_tpu_torch.models import abstract as abstract_model

__all__ = ["GRUCell", "ConvGRUEncoder", "SnailEncoder", "MultiHeadMLP"]


class GRUCell(nn.Module):
  """flax `nn.GRUCell(features=hidden_size, dtype=dtype)` run over [B, T,
  in] from a zero carry; `forward` returns the hidden states [B, T, H].

  r = sigmoid(x W_ir + b_ir + h W_hr), z = sigmoid(x W_iz + b_iz + h W_hz),
  n = tanh(x W_in + b_in + r * (h W_hn + b_hn)), h' = (1 - z) n + z h.
  The products run in `dtype` when given (else the promoted dtype); the
  carry starts as float32 zeros (flax's param dtype) and h' takes the
  promoted dtype of its terms, as in flax."""

  def __init__(self, input_size: int, hidden_size: int,
               dtype: Optional[torch.dtype] = None):
    super().__init__()
    self.hidden_size = hidden_size
    self.dtype = dtype
    self.weight_ih = nn.Parameter(torch.empty(3 * hidden_size, input_size))
    self.bias_ih = nn.Parameter(torch.zeros(3 * hidden_size))
    self.weight_hh = nn.Parameter(torch.empty(3 * hidden_size, hidden_size))
    self.bias_hn = nn.Parameter(torch.zeros(hidden_size))

  def initial_params(self, generator: torch.Generator
                     ) -> Dict[str, torch.Tensor]:
    """flax's initializers per gate: input kernels lecun normal, recurrent
    kernels orthogonal, biases zero (drawn on the CPU)."""
    weight_ih = torch.empty_like(self.weight_ih, device="cpu")
    for gate in weight_ih.chunk(3):
      abstract_model.lecun_normal_(gate, generator)
    weight_hh = torch.empty_like(self.weight_hh, device="cpu")
    for gate in weight_hh.chunk(3):
      nn.init.orthogonal_(gate, generator=generator)
    return {"weight_ih": weight_ih, "weight_hh": weight_hh,
            "bias_ih": torch.zeros_like(self.bias_ih, device="cpu"),
            "bias_hn": torch.zeros_like(self.bias_hn, device="cpu")}

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    x_proj = flax_layers.dense(x, self.weight_ih, self.bias_ih, self.dtype)
    h = x.new_zeros((x.shape[0], self.hidden_size), dtype=torch.float32)
    hs = []
    for step in range(x.shape[1]):
      xr, xz, xn = x_proj[:, step].chunk(3, dim=-1)
      hr, hz, hn = flax_layers.dense(h, self.weight_hh, None,
                                     self.dtype).chunk(3, dim=-1)
      r = torch.sigmoid(xr + hr)
      z = torch.sigmoid(xz + hz)
      n = torch.tanh(xn + r * (hn + self.bias_hn.to(hn.dtype)))
      h = (1.0 - z) * n + z * h
      hs.append(h)
    return torch.stack(hs, dim=1)


class ConvGRUEncoder(nn.Module):
  """Per-frame `BerkeleyNet` (filters, kernels (5, 3, ...), strides (2, 1,
  ...), spatial softmax) -> GRU over time. `forward(frames,
  conditioning=None, train=False)` returns ([B, T, hidden], the torso's
  new batch statistics, {} for its layer norms)."""

  def __init__(self, in_channels: int = 3, hidden_size: int = 128,
               filters: Sequence[int] = (32, 32), condition_size: int = 0,
               dtype: Optional[torch.dtype] = None):
    super().__init__()
    n = len(filters)
    self.torso = BerkeleyNet(in_channels, filters=tuple(filters),
                             kernel_sizes=(5,) + (3,) * (n - 1),
                             strides=(2,) + (1,) * (n - 1),
                             condition_size=condition_size, dtype=dtype)
    self.GRUCell_0 = GRUCell(2 * filters[-1], hidden_size, dtype=dtype)

  def forward(self, frames: torch.Tensor,
              conditioning: Optional[torch.Tensor] = None,
              train: bool = False
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    b, t = frames.shape[:2]
    flat = frames.reshape((b * t,) + tuple(frames.shape[2:]))
    cond = (None if conditioning is None
            else conditioning.repeat_interleave(t, dim=0))
    points, state = self.torso(flat, cond, train=train)
    outputs = self.GRUCell_0(points.reshape(b, t, -1))
    return outputs, {f"torso.{k}": v for k, v in state.items()}


class SnailEncoder(nn.Module):
  """tc1 -> attn1 -> tc2 -> attn2 over [B, T, in_features]."""

  def __init__(self, in_features: int, sequence_length: int,
               filters: int = 32, key_size: int = 16, value_size: int = 16,
               dtype: Optional[torch.dtype] = None):
    super().__init__()
    self.tc1 = TCBlock(in_features, sequence_length, filters, dtype=dtype)
    self.attn1 = AttentionBlock(self.tc1.out_features, key_size, value_size,
                                dtype=dtype)
    self.tc2 = TCBlock(self.attn1.out_features, sequence_length, filters,
                       dtype=dtype)
    self.attn2 = AttentionBlock(self.tc2.out_features, key_size, value_size,
                                dtype=dtype)
    self.out_features = self.attn2.out_features

  def forward(self, features: torch.Tensor,
              train: bool = False) -> torch.Tensor:
    del train  # no train-mode behaviour
    return self.attn2(self.tc2(self.attn1(self.tc1(features))))


class MultiHeadMLP(nn.Module):
  """Waypoint decoder: head w is Dense+relu per hidden size
  (`head{w}_fc{i}`), then `head{w}_out` to the action size; heads w > 0
  see the features detached (with `stop_gradient_future`). Returns [B,
  num_waypoints, action_size]."""

  def __init__(self, in_features: int, num_waypoints: int, action_size: int,
               hidden_sizes: Sequence[int] = (256, 256),
               stop_gradient_future: bool = True,
               dtype: Optional[torch.dtype] = None):
    super().__init__()
    self.num_waypoints = num_waypoints
    self.num_hidden = len(hidden_sizes)
    self.stop_gradient_future = stop_gradient_future
    self.dtype = dtype
    for w in range(num_waypoints):
      width = in_features
      for i, size in enumerate(hidden_sizes):
        self.add_module(f"head{w}_fc{i}", nn.Linear(width, size))
        width = size
      self.add_module(f"head{w}_out", nn.Linear(width, action_size))

  def _dense(self, name: str, x: torch.Tensor) -> torch.Tensor:
    layer = getattr(self, name)
    return flax_layers.dense(x, layer.weight, layer.bias, self.dtype)

  def forward(self, features: torch.Tensor,
              train: bool = False) -> torch.Tensor:
    del train  # no train-mode behaviour
    outputs = []
    for w in range(self.num_waypoints):
      x = features
      if w > 0 and self.stop_gradient_future:
        x = x.detach()
      for i in range(self.num_hidden):
        x = F.relu(self._dense(f"head{w}_fc{i}", x))
      outputs.append(self._dense(f"head{w}_out", x))
    return torch.stack(outputs, dim=1)
