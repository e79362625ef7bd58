"""Multi-head self-attention module over the port's attention ops.

Counterpart of `tensor2robot_tpu.layers.attention_layers`: Q/K/V and
output projections, with the score/softmax/combine done by the plain
`attention` ('reference') or the flash kernel ('flash').
"""

from __future__ import annotations

import torch
from torch import nn

from tensor2robot_tpu_torch.ops import attention as attention_ops

__all__ = ["MultiHeadAttention"]

_NOT_PORTED = ("attention backend {!r} is not ported yet (ROADMAP.md, "
               "Queue A item 10: sequence parallelism over "
               "torch.distributed)")


class MultiHeadAttention(nn.Module):
  """[B, T, F] -> [B, T, F] self-attention."""

  def __init__(self, features: int, num_heads: int = 4, head_dim: int = 32,
               causal: bool = False, backend: str = "reference"):
    super().__init__()
    if backend in ("ring", "ulysses"):
      raise NotImplementedError(_NOT_PORTED.format(backend))
    if backend not in ("reference", "flash"):
      raise ValueError(f"Unknown attention backend {backend!r}")
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
    else:
      out = attention_ops.attention(q, k, v, causal=self.causal)
    out = out.transpose(1, 2).reshape(b, t, self.num_heads * self.head_dim)
    return self.out_proj(out)
