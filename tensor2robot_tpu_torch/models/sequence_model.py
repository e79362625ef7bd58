"""The sequence policies and their session-decode seams.

Counterpart of `tensor2robot_tpu.models.sequence_model`:
`SequenceRegressionModel`, a stack of pre-LN causal attention + MLP
blocks, [B, T, obs] -> [B, T, action]; and `LSTMRegressionModel`, an
LSTM over time and a Dense head, whose session state is the LSTM carry.
Module names follow flax's (`embed`, `ln_attn_{i}`,
`attn_{i}.{q,k,v,out}_proj`, `ln_mlp_{i}`, `mlp_in_{i}`, `mlp_out_{i}`,
`head`), so `bridge.py` maps a flax param tree onto this `state_dict` by
name.

The decode path is plain functions over the same parameter dict the full
forward runs on:

* `decode_step_fn` — one tick per session row against per-session KV
  caches (`cached_attention`), pure: it returns new caches.
* `decode_arena_step_fn` — one tick of a bucket of lanes against the
  WHOLE serving arena: each block's cached attention and KV append is one
  `fused_decode_attention` launch that updates the arena in place, and
  the tick index advances in place once per tick.

LayerNorm eps is 1e-6 (flax's), and gelu is the tanh approximation
(flax's `nn.gelu`).

The LSTM is flax's `nn.RNN(nn.OptimizedLSTMCell)`: gates i, f, g, o
from `x W_i + h W_h + b_h` (the input products have no bias), `c' = f c
+ i g`, `h' = o tanh(c')`, a zero initial carry. Its parameters are
`lstm_cell.weight_ih` [4H, obs], `lstm_cell.weight_hh` [4H, H] and
`lstm_cell.bias_hh` [4H], gates stacked i, f, g, o as torch's LSTM
stacks them (`bridge.py` maps flax's eight kernels onto them). The
trunk and the decode tick run the same cell function on the same
parameters: the input products and then one step per tick, on cuBLAS
(no Pallas kernel stands behind the LSTM).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tensor2robot_tpu_torch import modes as modes_lib
from tensor2robot_tpu_torch.layers import attention_layers
from tensor2robot_tpu_torch.models import abstract as abstract_model
from tensor2robot_tpu_torch.ops import attention as attention_ops
from tensor2robot_tpu_torch.ops import decode_kernels
from tensor2robot_tpu_torch.specs import SpecStruct, TensorSpec
from tensor2robot_tpu_torch.utils import config

__all__ = ["SequenceRegressionModel", "LSTMRegressionModel", "LSTMCell",
           "lstm_cell_step"]

LAYERNORM_EPS = 1e-6  # flax nn.LayerNorm's default, not torch's 1e-5


def _gelu(x: torch.Tensor) -> torch.Tensor:
  return F.gelu(x, approximate="tanh")


def _dense(params, name: str, x: torch.Tensor) -> torch.Tensor:
  return F.linear(x, params[f"{name}.weight"], params[f"{name}.bias"])


def _layernorm(params, name: str, x: torch.Tensor) -> torch.Tensor:
  return F.layer_norm(x, (x.shape[-1],), params[f"{name}.weight"],
                      params[f"{name}.bias"], eps=LAYERNORM_EPS)


class _AttentionTrunk(nn.Module):
  """embed -> N x (pre-LN causal MHA + pre-LN MLP, residual) -> head."""

  def __init__(self, obs_size: int, action_size: int, hidden_size: int,
               num_blocks: int, num_heads: int, backend: str, mesh=None,
               sp_axis: str = "sp", ulysses_inner: str = "reference",
               ring_block_k=None):
    super().__init__()
    self.num_blocks = num_blocks
    self.embed = nn.Linear(obs_size, hidden_size)
    head_dim = hidden_size // num_heads
    for i in range(num_blocks):
      self.add_module(f"ln_attn_{i}",
                      nn.LayerNorm(hidden_size, eps=LAYERNORM_EPS))
      self.add_module(f"attn_{i}", attention_layers.MultiHeadAttention(
          hidden_size, num_heads=num_heads, head_dim=head_dim, causal=True,
          backend=backend, mesh=mesh, sp_axis=sp_axis,
          ulysses_inner=ulysses_inner, ring_block_k=ring_block_k))
      self.add_module(f"ln_mlp_{i}",
                      nn.LayerNorm(hidden_size, eps=LAYERNORM_EPS))
      self.add_module(f"mlp_in_{i}", nn.Linear(hidden_size, 2 * hidden_size))
      self.add_module(f"mlp_out_{i}", nn.Linear(2 * hidden_size, hidden_size))
    self.head = nn.Linear(hidden_size, action_size)

  def forward(self, features, mode: str = modes_lib.PREDICT,
              train: bool = False):
    """(outputs, {}): the trunk holds no mutable state."""
    x = self.embed(features["observation"])  # [B, T, hidden]
    for i in range(self.num_blocks):
      y = getattr(self, f"ln_attn_{i}")(x)
      x = x + getattr(self, f"attn_{i}")(y)
      y = getattr(self, f"ln_mlp_{i}")(x)
      y = getattr(self, f"mlp_out_{i}")(_gelu(getattr(self, f"mlp_in_{i}")(y)))
      x = x + y
    action = self.head(x)  # [B, T, act]
    return SpecStruct({"action": action, "inference_output": action}), {}


@config.configurable
class SequenceRegressionModel(abstract_model.T2RModel):
  """[B, T, obs] -> [B, T, action] causal regression; the attention
  backend is 'reference' (plain attention), 'flash' (the kernel), or
  sequence parallel over the mesh's `sp_axis`: 'ring' or 'ulysses'
  (whose per-rank attention is `ulysses_inner`, 'reference' or
  'flash'); `ring_block_k` (the port's knob; None as in the JAX package)
  streams each ring hop's keys in chunks of that many. The
  sequence-parallel backends need `set_mesh` before the
  module is built, and train on ('data', sp_axis) blocks of the batch
  (`batch_partition_spec`)."""

  def __init__(self, obs_size: int = 16, action_size: int = 7,
               sequence_length: int = 32, hidden_size: int = 64,
               num_blocks: int = 2, num_heads: int = 4,
               attention_backend: str = "reference", sp_axis: str = "sp",
               ulysses_inner: str = "reference",
               ring_block_k: Optional[int] = None, **kwargs):
    super().__init__(**kwargs)
    if attention_backend not in ("reference", "flash", "ring", "ulysses"):
      raise ValueError(f"Unknown attention_backend {attention_backend!r}")
    if hidden_size % num_heads:
      raise ValueError(f"hidden_size {hidden_size} is not divisible by "
                       f"num_heads {num_heads}")
    self._obs_size = obs_size
    self._action_size = action_size
    self._sequence_length = sequence_length
    self._hidden_size = hidden_size
    self._num_blocks = num_blocks
    self._num_heads = num_heads
    self._attention_backend = attention_backend
    self._sp_axis = sp_axis
    self._ulysses_inner = ulysses_inner
    self._ring_block_k = ring_block_k
    self._mesh = None

  def set_mesh(self, mesh) -> None:
    """Receives the training mesh; required before the module is built
    for the 'ring' and 'ulysses' backends."""

    def validate(m):
      if self._attention_backend not in ("ring", "ulysses"):
        return
      sp = m.shape.get(self._sp_axis, 0)
      if not sp:
        raise ValueError(
            f"attention_backend={self._attention_backend!r} needs a "
            f"{self._sp_axis!r} mesh axis; mesh has {dict(m.shape)}")
      if self._sequence_length % sp:
        raise ValueError(
            f"sequence_length {self._sequence_length} not divisible by "
            f"the {sp}-way {self._sp_axis!r} axis")
      if self._attention_backend == "ulysses" and self._num_heads % sp:
        raise ValueError(
            f"num_heads {self._num_heads} not divisible by the {sp}-way "
            f"{self._sp_axis!r} axis (Ulysses shards head groups)")

    self._set_mesh_guarded(mesh, validate)

  @property
  def batch_partition_spec(self):
    """('data', sp_axis) under a sequence-parallel backend on a mesh whose
    `sp_axis` has more than one rank (the train step's `batch_spec`),
    else None."""
    if self._attention_backend in ("ring", "ulysses") \
        and self._mesh is not None \
        and self._mesh.shape.get(self._sp_axis, 1) > 1:
      return ("data", self._sp_axis)
    return None

  @property
  def head_dim(self) -> int:
    return self._hidden_size // self._num_heads

  def get_feature_specification(self, mode):
    return SpecStruct({
        "observation": TensorSpec(
            shape=(self._sequence_length, self._obs_size),
            dtype=np.float32, name="observation"),
    })

  def get_label_specification(self, mode):
    return SpecStruct({
        "action": TensorSpec(
            shape=(self._sequence_length, self._action_size),
            dtype=np.float32, name="action"),
    })

  def create_module(self) -> nn.Module:
    backend = self._attention_backend
    if backend in ("ring", "ulysses") and self._mesh is None:
      raise ValueError(f"attention_backend={backend!r} requires "
                       "set_mesh() before the module is built.")
    return _AttentionTrunk(
        obs_size=self._obs_size, action_size=self._action_size,
        hidden_size=self._hidden_size, num_blocks=self._num_blocks,
        num_heads=self._num_heads, backend=backend, mesh=self._mesh,
        sp_axis=self._sp_axis, ulysses_inner=self._ulysses_inner,
        ring_block_k=self._ring_block_k)

  def model_train_fn(self, features, labels, inference_outputs, mode):
    """Mean squared error over every action entry, reported as 'mse'."""
    loss = torch.mean((inference_outputs["action"] - labels["action"]) ** 2)
    return loss, {"mse": loss}

  # -- session-decode seam ---------------------------------------------------

  @property
  def supports_sessions(self) -> bool:
    return True

  @property
  def decode_observation_spec(self) -> SpecStruct:
    """Per-tick wire layout: the feature spec minus the time dim."""
    return SpecStruct({
        "observation": TensorSpec(shape=(self._obs_size,),
                                  dtype=np.float32, name="observation"),
    })

  @property
  def decode_max_ticks(self) -> int:
    """Decode horizon == KV capacity. A tick at index >= T would write
    past the slot; the engine refuses it with SessionHorizonError."""
    return self._sequence_length

  def init_session_state(self, batch_size: int, device=None
                         ) -> Dict[str, torch.Tensor]:
    """Zeroed KV caches [B, T, H, D] per block (T-major) plus the [B]
    int32 tick index, on `device`."""
    kv_shape = (batch_size, self._sequence_length, self._num_heads,
                self.head_dim)
    state = {"index": torch.zeros((batch_size,), dtype=torch.int32,
                                  device=device)}
    for i in range(self._num_blocks):
      state[f"k_{i}"] = torch.zeros(kv_shape, dtype=torch.float32,
                                    device=device)
      state[f"v_{i}"] = torch.zeros(kv_shape, dtype=torch.float32,
                                    device=device)
    return state

  def decode_step_fn(self):
    """Pure per-tick forward: embed -> N x (pre-LN cached attention +
    pre-LN MLP, residual) -> head, appending this tick's K/V at each
    session's own index. Returns new caches; the inputs are left alone."""
    num_blocks, num_heads, head_dim = (self._num_blocks, self._num_heads,
                                       self.head_dim)

    def decode_step(state, session_state, features):
      params = state.eval_params()
      obs = features["observation"]  # [B, obs]
      b = obs.shape[0]
      index = session_state["index"]
      rows = torch.arange(b, device=obs.device)
      x = _dense(params, "embed", obs)
      new_state = {"index": index + 1}
      for i in range(num_blocks):
        y = _layernorm(params, f"ln_attn_{i}", x)
        q = _dense(params, f"attn_{i}.q_proj", y).reshape(b, num_heads,
                                                          head_dim)
        k_t = _dense(params, f"attn_{i}.k_proj", y).reshape(b, num_heads,
                                                            head_dim)
        v_t = _dense(params, f"attn_{i}.v_proj", y).reshape(b, num_heads,
                                                            head_dim)
        k_cache = session_state[f"k_{i}"].clone()
        v_cache = session_state[f"v_{i}"].clone()
        k_cache[rows, index.long()] = k_t
        v_cache[rows, index.long()] = v_t
        new_state[f"k_{i}"] = k_cache
        new_state[f"v_{i}"] = v_cache
        out = attention_ops.cached_attention(q, k_cache, v_cache, index)
        x = x + _dense(params, f"attn_{i}.out_proj",
                       out.reshape(b, num_heads * head_dim))
        y = _layernorm(params, f"ln_mlp_{i}", x)
        x = x + _dense(params, f"mlp_out_{i}",
                       _gelu(_dense(params, f"mlp_in_{i}", y)))
      action = _dense(params, "head", x)
      return new_state, {"action": action, "inference_output": action}

    return decode_step

  @property
  def supports_decode_kernel(self) -> bool:
    """The arena layout ([S, T, H, D] per block) is what
    `fused_decode_attention` streams."""
    return True

  def decode_arena_step_fn(self):
    """Per-tick forward against the whole arena, in place: the same math
    as `decode_step_fn`, with each block's cached attention and KV append
    as one `fused_decode_attention` launch. The lanes' tick indices are
    read before the index leaf advances (pad lanes add 0 on the null
    slot)."""
    num_blocks, num_heads, head_dim = (self._num_blocks, self._num_heads,
                                       self.head_dim)

    def decode_arena_step(state, arena, slots, features, mask):
      params = state.eval_params()
      obs = features["observation"]  # [B, obs]
      b = obs.shape[0]
      index = arena["index"][slots]  # a copy: read before the advance
      arena["index"].index_add_(0, slots, mask.to(arena["index"].dtype))
      x = _dense(params, "embed", obs)
      for i in range(num_blocks):
        y = _layernorm(params, f"ln_attn_{i}", x)
        q = _dense(params, f"attn_{i}.q_proj", y).reshape(b, num_heads,
                                                          head_dim)
        k_t = _dense(params, f"attn_{i}.k_proj", y).reshape(b, num_heads,
                                                            head_dim)
        v_t = _dense(params, f"attn_{i}.v_proj", y).reshape(b, num_heads,
                                                            head_dim)
        out, _, _ = decode_kernels.fused_decode_attention(
            q, k_t, v_t, arena[f"k_{i}"], arena[f"v_{i}"], slots, index,
            mask)
        x = x + _dense(params, f"attn_{i}.out_proj",
                       out.reshape(b, num_heads * head_dim))
        y = _layernorm(params, f"ln_mlp_{i}", x)
        x = x + _dense(params, f"mlp_out_{i}",
                       _gelu(_dense(params, f"mlp_in_{i}", y)))
      action = _dense(params, "head", x)
      return arena, {"action": action, "inference_output": action}

    return decode_arena_step


# -- the LSTM family -----------------------------------------------------------


def lstm_cell_step(x_proj: torch.Tensor, c: torch.Tensor, h: torch.Tensor,
                   weight_hh: torch.Tensor, bias_hh: torch.Tensor):
  """One OptimizedLSTMCell step: `x_proj` is the input product x W_i
  ([B, 4H]); returns the new (c, h)."""
  gates = F.linear(h, weight_hh, bias_hh) + x_proj
  i, f, g, o = gates.chunk(4, dim=-1)
  c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
  return c, torch.sigmoid(o) * torch.tanh(c)


class LSTMCell(nn.Module):
  """flax `nn.OptimizedLSTMCell`'s parameters in torch's LSTM layout (see
  the module docstring); `forward` runs it over [B, T, in] from a zero
  carry and returns the hidden states [B, T, H]."""

  def __init__(self, input_size: int, hidden_size: int):
    super().__init__()
    self.hidden_size = hidden_size
    self.weight_ih = nn.Parameter(torch.empty(4 * hidden_size, input_size))
    self.weight_hh = nn.Parameter(torch.empty(4 * hidden_size, hidden_size))
    self.bias_hh = nn.Parameter(torch.zeros(4 * hidden_size))

  def initial_params(self, generator: torch.Generator
                     ) -> Dict[str, torch.Tensor]:
    """flax's initializers, per gate: input kernels lecun normal, hidden
    kernels orthogonal, biases zero (drawn on the CPU)."""
    weight_ih = torch.empty_like(self.weight_ih, device="cpu")
    for gate in weight_ih.chunk(4):
      abstract_model.lecun_normal_(gate, generator)
    weight_hh = torch.empty_like(self.weight_hh, device="cpu")
    for gate in weight_hh.chunk(4):
      nn.init.orthogonal_(gate, generator=generator)
    return {"weight_ih": weight_ih, "weight_hh": weight_hh,
            "bias_hh": torch.zeros_like(self.bias_hh, device="cpu")}

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    b, t = x.shape[:2]
    x_proj = F.linear(x, self.weight_ih)  # [B, T, 4H]
    c = h = x.new_zeros((b, self.hidden_size))
    hs = []
    for step in range(t):
      c, h = lstm_cell_step(x_proj[:, step], c, h, self.weight_hh,
                            self.bias_hh)
      hs.append(h)
    return torch.stack(hs, dim=1)


class _LSTMTrunk(nn.Module):
  """obs [B, T, obs] -> LSTM over time -> Dense head -> [B, T, act]."""

  def __init__(self, obs_size: int, action_size: int, hidden_size: int):
    super().__init__()
    self.lstm_cell = LSTMCell(obs_size, hidden_size)
    self.head = nn.Linear(hidden_size, action_size)

  def forward(self, features, mode: str = modes_lib.PREDICT,
              train: bool = False):
    """(outputs, {}): the trunk holds no mutable state."""
    action = self.head(self.lstm_cell(features["observation"]))
    return SpecStruct({"action": action, "inference_output": action}), {}


@config.configurable
class LSTMRegressionModel(abstract_model.T2RModel):
  """[B, T, obs] -> [B, T, action] LSTM regression; its session state is
  the LSTM carry (one cell step per control tick), which
  `SessionEngine` serves through its gather -> tick -> scatter path. The
  carry has no horizon: a session ticks past T."""

  def __init__(self, obs_size: int = 16, action_size: int = 7,
               sequence_length: int = 32, hidden_size: int = 64,
               **kwargs):
    super().__init__(**kwargs)
    self._obs_size = obs_size
    self._action_size = action_size
    self._sequence_length = sequence_length
    self._hidden_size = hidden_size

  def get_feature_specification(self, mode):
    return SpecStruct({
        "observation": TensorSpec(
            shape=(self._sequence_length, self._obs_size),
            dtype=np.float32, name="observation"),
    })

  def get_label_specification(self, mode):
    return SpecStruct({
        "action": TensorSpec(
            shape=(self._sequence_length, self._action_size),
            dtype=np.float32, name="action"),
    })

  def create_module(self) -> nn.Module:
    return _LSTMTrunk(obs_size=self._obs_size,
                      action_size=self._action_size,
                      hidden_size=self._hidden_size)

  def model_train_fn(self, features, labels, inference_outputs, mode):
    """Mean squared error over every action entry, reported as 'mse'."""
    loss = torch.mean((inference_outputs["action"] - labels["action"]) ** 2)
    return loss, {"mse": loss}

  # -- session-decode seam ---------------------------------------------------

  @property
  def supports_sessions(self) -> bool:
    return True

  @property
  def decode_observation_spec(self) -> SpecStruct:
    return SpecStruct({
        "observation": TensorSpec(shape=(self._obs_size,),
                                  dtype=np.float32, name="observation"),
    })

  def init_session_state(self, batch_size: int, device=None
                         ) -> Dict[str, torch.Tensor]:
    """The zero LSTM carry (`carry_c`, `carry_h`: [B, H] f32) and the [B]
    int32 tick index, on `device`."""
    carry = (batch_size, self._hidden_size)
    return {"index": torch.zeros((batch_size,), dtype=torch.int32,
                                 device=device),
            "carry_c": torch.zeros(carry, dtype=torch.float32, device=device),
            "carry_h": torch.zeros(carry, dtype=torch.float32, device=device)}

  def decode_step_fn(self):
    """Pure per-tick forward: one cell step on each row's carry, then the
    head. Returns the new carry and index; the inputs are left alone."""

    def decode_step(state, session_state, features):
      params = state.eval_params()
      obs = features["observation"]  # [B, obs]
      c, h = lstm_cell_step(
          F.linear(obs, params["lstm_cell.weight_ih"]),
          session_state["carry_c"], session_state["carry_h"],
          params["lstm_cell.weight_hh"], params["lstm_cell.bias_hh"])
      action = _dense(params, "head", h)
      new_state = {"index": session_state["index"] + 1,
                   "carry_c": c, "carry_h": h}
      return new_state, {"action": action, "inference_output": action}

    return decode_step
