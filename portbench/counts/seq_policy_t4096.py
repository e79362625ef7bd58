"""The work of `seq_policy_t4096`, counted from its shapes.

These are the benchmark's own counts, the same whatever implements the
work:

* a dense product of an [N, in] input and an [in, out] kernel is
  2 N in out flops forward, and twice that backward (the input's and the
  kernel's gradient), except that the embedding's input (the
  observations) takes no gradient;
* causal attention over [BH, T, D] is 2 products forward (S = Q K^T,
  O = P V) and 4 backward (dV, dP, dQ, dK), each 2 BH T^2 D halved for
  the causal triangle. Recomputing S in the backward is not counted, so
  a kernel that stops recomputing does not lower the count;
* a kernel's bytes: each input read once and each output written once;
* a decode tick reads each lane's K and V rows below its index once and
  attends over index + 1 positions, 4 H D flops a position.
"""

from __future__ import annotations

from typing import Mapping, Sequence

from portbench import peaks

BF16, F32 = 2, 4


def _dims(cfg: Mapping):
  m = cfg["model"]
  return (m["obs_size"], m["action_size"], m["sequence_length"],
          m["hidden_size"], m["num_blocks"], m["num_heads"], m["mlp_size"])


def dense_params(cfg: Mapping) -> int:
  """Weights of the dense products a token passes through."""
  obs, act, _, hidden, blocks, _, mlp = _dims(cfg)
  return obs * hidden + blocks * (4 * hidden * hidden + 2 * hidden * mlp) \
      + hidden * act


def attention_product(cfg: Mapping, batch: int) -> int:
  """One causal [T, T] x D product over the batch's heads."""
  _, _, t, hidden, _, heads, _ = _dims(cfg)
  return 2 * batch * heads * t * t * (hidden // heads) // 2


def train_step_flops(cfg: Mapping, batch: int) -> int:
  """Model flops of one train step (forward and backward)."""
  obs, _, t, hidden, blocks, _, _ = _dims(cfg)
  tokens = batch * t
  dense = 6 * tokens * dense_params(cfg) - 2 * tokens * obs * hidden
  return dense + blocks * 6 * attention_product(cfg, batch)


def recomputed_flops(cfg: Mapping, batch: int) -> int:
  """The products a backward that recomputes S adds: one in the dQ
  kernel, one in the dK/dV kernel and dP in both, 3 a block."""
  return _dims(cfg)[4] * 3 * attention_product(cfg, batch)


def _attention_bytes(cfg: Mapping, batch: int, tensors: int,
                     elem: int) -> int:
  _, _, t, hidden, _, heads, _ = _dims(cfg)
  return tensors * batch * t * hidden * elem + 2 * batch * heads * t * F32


def flash_fwd_seconds(cfg: Mapping, batch: int, dtype: str) -> float:
  """Least time of one forward call: q, k, v read, o written, lse."""
  elem = BF16 if dtype == "bfloat16" else F32
  return peaks.least_seconds(_attention_bytes(cfg, batch, 4, elem),
                             2 * attention_product(cfg, batch), dtype)


def flash_bwd_seconds(cfg: Mapping, batch: int, dtype: str) -> float:
  """Least time of one backward call: q, k, v, o, dO read, dq, dk, dv
  written, lse and delta; 4 products."""
  elem = BF16 if dtype == "bfloat16" else F32
  return peaks.least_seconds(_attention_bytes(cfg, batch, 8, elem),
                             4 * attention_product(cfg, batch), dtype)


def decode_launch_seconds(cfg: Mapping, index: Sequence[int]) -> float:
  """Least time of one decode-tick launch over lanes at `index` (f32
  arena): K and V rows below each index read, q, k, v read, out and the
  appended K and V rows written."""
  _, _, _, hidden, _, _, _ = _dims(cfg)
  row = hidden * F32
  lanes = len(index)
  moved = 2 * sum(index) * row + 3 * lanes * row + lanes * row \
      + 2 * lanes * row
  flops = 4 * sum(i + 1 for i in index) * hidden
  return peaks.least_seconds(moved, flops, "float32")


def dispatch_seconds(cfg: Mapping, index: Sequence[int]) -> float:
  """Least time of one served tick of lanes at `index` (float32): the
  dense products of each lane, attention over index + 1 positions in
  every block; the weights read once, each block's K and V rows below
  each index read once, the appended rows, observations and actions."""
  obs, act, _, hidden, blocks, _, _ = _dims(cfg)
  lanes = len(index)
  flops = 2 * lanes * dense_params(cfg) \
      + blocks * 4 * sum(i + 1 for i in index) * hidden
  moved = F32 * (dense_params(cfg) + blocks * 2 * sum(index) * hidden
                 + blocks * 2 * lanes * hidden + lanes * (obs + act))
  return peaks.least_seconds(moved, flops, "float32")
