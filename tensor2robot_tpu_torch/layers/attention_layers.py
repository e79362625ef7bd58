"""Multi-head self-attention module over the port's attention ops.

Counterpart of `tensor2robot_tpu.layers.attention_layers`: Q/K/V and
output projections, with the score/softmax/combine done by the plain
`attention` ('reference'), the flash kernel ('flash'), or, over the
`sp_axis` of a mesh, the ring ('ring', each hop's keys streamed in
chunks of `ring_block_k` when set) or Ulysses ('ulysses', whose per-rank
attention is `ulysses_inner`: 'reference' or 'flash'). Under a
sequence-parallel backend the input is this rank's T block.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from tensor2robot_tpu_torch.ops import attention as attention_ops

__all__ = ["MultiHeadAttention"]

_BACKENDS = ("reference", "flash", "ring", "ulysses")


class MultiHeadAttention(nn.Module):
  """[B, T, F] -> [B, T, F] self-attention."""

  def __init__(self, features: int, num_heads: int = 4, head_dim: int = 32,
               causal: bool = False, backend: str = "reference", mesh=None,
               sp_axis: str = "sp", ulysses_inner: str = "reference",
               ring_block_k: Optional[int] = None):
    super().__init__()
    if backend not in _BACKENDS:
      raise ValueError(f"Unknown attention backend {backend!r}")
    if backend in ("ring", "ulysses") and mesh is None:
      raise ValueError(f"{backend} backend requires a mesh.")
    self.mesh = mesh
    self.sp_axis = sp_axis
    self.ulysses_inner = ulysses_inner
    self.ring_block_k = ring_block_k
    self.num_heads = num_heads
    self.head_dim = head_dim
    self.causal = causal
    self.backend = backend
    proj = num_heads * head_dim
    self.q_proj = nn.Linear(features, proj)
    self.k_proj = nn.Linear(features, proj)
    self.v_proj = nn.Linear(features, proj)
    self.out_proj = nn.Linear(proj, features)

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    b, t, _ = x.shape

    def heads(y):  # [B, T, H*D] -> [B, H, T, D]
      return y.reshape(b, t, self.num_heads, self.head_dim).transpose(1, 2)

    q, k, v = heads(self.q_proj(x)), heads(self.k_proj(x)), heads(
        self.v_proj(x))
    if self.backend == "flash":
      out = attention_ops.flash_attention(q, k, v, causal=self.causal)
    elif self.backend == "ring":
      out = attention_ops.ring_attention(q, k, v, self.mesh,
                                         axis_name=self.sp_axis,
                                         causal=self.causal,
                                         block_k=self.ring_block_k)
    elif self.backend == "ulysses":
      out = attention_ops.ulysses_attention(q, k, v, self.mesh,
                                            axis_name=self.sp_axis,
                                            causal=self.causal,
                                            inner=self.ulysses_inner)
    else:
      out = attention_ops.attention(q, k, v, causal=self.causal)
    out = out.transpose(1, 2).reshape(b, t, self.num_heads * self.head_dim)
    return self.out_proj(out)
