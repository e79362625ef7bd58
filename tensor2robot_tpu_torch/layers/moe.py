"""Mixture-of-experts layer with expert parallelism.

Counterpart of `tensor2robot_tpu.layers.moe`: a top-k routed MLP whose
expert parameters carry a leading expert dim (`experts_w1` [E, in, h],
`experts_b1` [E, 1, h], `experts_w2` [E, h, out], `experts_b2` [E, 1,
out], flax's layout) that a partition rule shards over a mesh axis
(`expert_axis_param_rule`). Three dispatch modes:

* `dense`: every expert computes every token, the renormalized top-k
  gates zero the rest;
* `sparse`: capacity routing (GShard/Switch). Tokens are packed into
  per-expert [capacity] slots by one-hot dispatch/combine einsums
  (`_pack_combine`): earlier tokens, and earlier of a token's choices,
  claim lower slots; over-capacity choices are dropped and the kept gate
  mass renormalizes. The capacity is the global batch's, as under JAX's
  jit: on a mesh (a batch-sharded train step, `collectives.batch_group`)
  the routing of every rank's tokens is gathered, so each rank packs its
  tokens into the slots the whole batch gives them;
* `alltoall`: the same capacity routing with explicit collectives over
  `ep_axis`: each rank packs its own tokens into [E, C] slots (capacity
  per SOURCE shard, the JAX package's documented delta from `sparse`), an
  all-to-all ships each expert group's slots to the rank that owns those
  experts, the local experts run, and a second all-to-all ships results
  home. Experts must be sharded over the same axis as the tokens
  (`expert_axis_param_rule('data')`); the layer takes this rank's [E/S,
  ...] block of each expert leaf (the train step's stage-local leaf) or
  the whole stack, from which it cuts its block.

The router runs in float32 (its kernel rounded to the compute dtype under
the bfloat16 policy, then widened, as flax promotes); the expert einsums
run in `dtype` when given. Top-k ties go to the lower expert index, as
`jax.lax.top_k`. The Switch load-balancing auxiliary, E * sum(importance
* load), reads both statistics over the global batch (the batch group, or
the `ep_axis` group under `alltoall`) through differentiable sums.

Router noise (train only) is a unit normal from a `torch.Generator`
seeded `NOISE_SEED` on the logits' device, or from `noise_fn(shape,
dtype, device)` where a caller injects it (JAX's threefry draw cannot be
reproduced).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from tensor2robot_tpu_torch.layers import flax_layers
from tensor2robot_tpu_torch.parallel import collectives

__all__ = ["MixtureOfExperts", "EXPERT_AXIS_PARAM_RULE",
           "expert_axis_param_rule", "EXPERT_LEAVES"]

EXPERT_LEAVES = ("experts_w1", "experts_b1", "experts_w2", "experts_b2")
NOISE_SEED = 0
DISPATCHES = ("dense", "sparse", "alltoall")


def expert_axis_param_rule(axis: str = "model"):
  """Partition rule: expert-major params shard their leading dim over
  `axis`. `dispatch='alltoall'` wants the axis the tokens are sharded
  over (`expert_axis_param_rule('data')`)."""
  return (r"experts_", (axis, None, None))


# The default 'model'-axis rule (the sparse and dense layouts).
EXPERT_AXIS_PARAM_RULE = expert_axis_param_rule()


def _lecun_normal_stack(shape, generator: torch.Generator) -> torch.Tensor:
  """flax lecun_normal over an [E, in, out] stack: fan_in in * E, a
  normal truncated at two standard deviations."""
  fan_in = shape[0] * shape[1]
  std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
  out = torch.empty(shape)
  nn.init.trunc_normal_(out, std=std, a=-2 * std, b=2 * std,
                        generator=generator)
  return out


def _global_mean(x: torch.Tensor, group) -> torch.Tensor:
  """The mean over dim 0 of a batch whose rows are split in equal blocks
  over `group` (None: this rank's rows are the batch)."""
  if group is None or group.size == 1:
    return x.mean(0)
  return collectives.all_reduce_sum(x.sum(0), group) / (x.shape[0]
                                                        * group.size)


class MixtureOfExperts(nn.Module):
  """Top-k routed MLP experts over [..., features];
  `forward(x, train=False)` returns (output, aux load-balancing loss)."""

  def __init__(self, input_size: int, num_experts: int = 4,
               hidden_size: int = 64, output_size: int = 64,
               top_k: int = 1, router_noise: float = 0.0,
               dispatch: str = "dense", capacity_factor: float = 1.25,
               mesh=None, ep_axis: str = "data",
               dtype: Optional[torch.dtype] = None):
    super().__init__()
    if dispatch not in DISPATCHES:
      raise ValueError(f"Unknown dispatch mode {dispatch!r}")
    self.num_experts = num_experts
    self.output_size = output_size
    self.top_k = top_k
    self.router_noise = router_noise
    self.dispatch = dispatch
    self.capacity_factor = capacity_factor
    self.mesh = mesh
    self.ep_axis = ep_axis
    self.dtype = dtype
    self.router = nn.Linear(input_size, num_experts)
    e = num_experts
    self.experts_w1 = nn.Parameter(torch.zeros(e, input_size, hidden_size))
    self.experts_b1 = nn.Parameter(torch.zeros(e, 1, hidden_size))
    self.experts_w2 = nn.Parameter(torch.zeros(e, hidden_size, output_size))
    self.experts_b2 = nn.Parameter(torch.zeros(e, 1, output_size))
    self._noise_generators: Dict[str, torch.Generator] = {}
    # (shape, dtype, device) -> a unit normal draw; replace to inject.
    self.noise_fn: Callable[..., torch.Tensor] = self._draw_noise

  def initial_params(self, generator: torch.Generator
                     ) -> Dict[str, torch.Tensor]:
    """The expert stacks: kernels lecun normal, biases zero (the router
    is a Dense, drawn as every Dense is)."""
    return {"experts_w1": _lecun_normal_stack(self.experts_w1.shape,
                                              generator),
            "experts_b1": torch.zeros(self.experts_b1.shape),
            "experts_w2": _lecun_normal_stack(self.experts_w2.shape,
                                              generator),
            "experts_b2": torch.zeros(self.experts_b2.shape)}

  def _draw_noise(self, shape, dtype: torch.dtype,
                  device: torch.device) -> torch.Tensor:
    key = str(device)
    if key not in self._noise_generators:
      self._noise_generators[key] = torch.Generator(
          device=device).manual_seed(NOISE_SEED)
    return torch.randn(shape, dtype=dtype, device=device,
                       generator=self._noise_generators[key])

  def _capacity(self, n_tokens: int) -> int:
    return max(1, int(math.ceil(
        self.top_k * n_tokens / self.num_experts * self.capacity_factor)))

  def route(self, tokens: torch.Tensor, train: bool = False
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(router probabilities [N, E], the top-k probabilities and expert
    indices [N, k]) of [N, features] tokens."""
    logits = flax_layers.dense(tokens.float(), self.router.weight,
                               self.router.bias)
    if train and self.router_noise:
      logits = logits + self.router_noise * self.noise_fn(
          tuple(logits.shape), logits.dtype, logits.device)
    probs = torch.softmax(logits, dim=-1)
    # A stable sort: tied probabilities go to the lower expert index.
    ordered, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    return probs, ordered[:, :self.top_k], order[:, :self.top_k]

  def forward(self, x: torch.Tensor, train: bool = False
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    leading = x.shape[:-1]
    tokens = x.reshape(-1, x.shape[-1])
    probs, top_probs, top_idx = self.route(tokens, train)
    weights = (self.experts_w1, self.experts_b1, self.experts_w2,
               self.experts_b2)
    if self.dtype is not None:
      weights = tuple(w.to(self.dtype) for w in weights)

    if self.dispatch == "alltoall":
      group = self._ep_group()
      combined, load = self._alltoall_dispatch(tokens, top_probs, top_idx,
                                               weights, group)
    else:
      group = collectives.current_batch_group()
      if self.dispatch == "dense":
        combined, load = self._dense_dispatch(tokens, probs, top_probs,
                                              top_idx, weights, group)
      else:
        combined, load = self._sparse_dispatch(tokens, top_probs, top_idx,
                                               weights, group)
    importance = _global_mean(probs, group)
    aux_loss = self.num_experts * (importance * load).sum()
    return combined.reshape(leading + (self.output_size,)), aux_loss

  def _dense_dispatch(self, tokens, probs, top_probs, top_idx, weights,
                      group):
    w1, b1, w2, b2 = weights
    gates = torch.zeros_like(probs).scatter(1, top_idx, top_probs)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    hidden = F.relu(torch.einsum("nf,efh->enh", tokens.to(w1.dtype), w1)
                    + b1)
    expert_out = torch.einsum("enh,eho->eno", hidden, w2) + b2  # [E, N, O]
    combined = torch.einsum("eno,ne->no", expert_out,
                            gates.to(expert_out.dtype))
    return combined, _global_mean(gates.float(), group)

  def _pack_combine(self, top_probs, top_idx, capacity: int, group=None):
    """Packs the top-k choices into per-expert slots: combine [n, E, C]
    for this rank's n tokens. With a `group`, the slot positions count
    the choices of every rank's tokens before these (gathered), as the
    whole batch packs them."""
    n, e = top_probs.shape[0], self.num_experts
    all_idx, offset = top_idx, 0
    if group is not None and group.size > 1:
      all_idx = collectives.all_gather(top_idx.contiguous(), group)
      offset = group.index * n
    combine = torch.zeros((n, e, capacity), dtype=torch.float32,
                          device=top_probs.device)
    counts = torch.zeros((e,), dtype=torch.float32, device=top_probs.device)
    kept_gate_sum = torch.zeros((n,), dtype=torch.float32,
                                device=top_probs.device)
    for slot in range(self.top_k):
      one_hot = F.one_hot(all_idx[:, slot], e).float()       # [N, E]
      pos_within = torch.cumsum(one_hot, dim=0) - one_hot
      pos_all = ((pos_within + counts[None, :]) * one_hot).sum(-1)
      keep_all = (pos_all < capacity).float()
      pos = pos_all[offset:offset + n]
      gate = top_probs[:, slot] * keep_all[offset:offset + n]
      slot_hot = F.one_hot(pos.long().clamp(max=capacity - 1),
                           capacity).float()
      combine = combine + (gate[:, None, None]
                           * one_hot[offset:offset + n, :, None]
                           * slot_hot[:, None, :])
      counts = counts + (one_hot * keep_all[:, None]).sum(0)
      kept_gate_sum = kept_gate_sum + gate
    return combine / torch.clamp(kept_gate_sum, min=1e-9)[:, None, None]

  def _sparse_dispatch(self, tokens, top_probs, top_idx, weights, group):
    w1, b1, w2, b2 = weights
    size = 1 if group is None else group.size
    combine = self._pack_combine(top_probs, top_idx,
                                 self._capacity(tokens.shape[0] * size),
                                 group)
    dispatch = (combine > 0).to(w1.dtype)                   # [n, E, C]
    expert_inputs = torch.einsum("nec,nf->ecf", dispatch,
                                 tokens.to(w1.dtype))
    hidden = F.relu(torch.einsum("ecf,efh->ech", expert_inputs, w1) + b1)
    expert_out = torch.einsum("ech,eho->eco", hidden, w2) + b2
    combined = torch.einsum("nec,eco->no", combine.to(expert_out.dtype),
                            expert_out)
    # The kept gate mass per expert, the dense branch's statistic.
    return combined, _global_mean(combine.sum(-1), group)

  def _ep_group(self):
    if self.mesh is None:
      raise ValueError("dispatch='alltoall' requires a mesh (the model's "
                       "set_mesh hook sets it)")
    group = self.mesh.group(self.ep_axis)
    if self.num_experts % group.size:
      raise ValueError(f"num_experts={self.num_experts} must be divisible "
                       f"by the {self.ep_axis!r} axis size {group.size}")
    return group

  def _alltoall_dispatch(self, tokens, top_probs, top_idx, weights, group):
    """Explicit token routing over the `ep_axis` group: this rank's n
    tokens packed into [E, C] slots, shipped to the experts' owners,
    run there, and shipped home."""
    s, e = group.size, self.num_experts
    e_local = e // s
    if weights[0].shape[0] == e:  # the whole stack: this rank's block
      weights = tuple(w[group.index * e_local:(group.index + 1) * e_local]
                      for w in weights)
    w1, b1, w2, b2 = weights
    capacity = self._capacity(tokens.shape[0])  # per SOURCE shard
    combine = self._pack_combine(top_probs, top_idx, capacity)
    dispatch = (combine > 0).to(w1.dtype)                   # [n, E, C]
    slots = torch.einsum("nec,nf->ecf", dispatch, tokens.to(w1.dtype))
    # [E, C, F] -> [S, E_l, C, F]; after the all-to-all dim 0 is the
    # SOURCE rank and E_l this rank's experts.
    slots = collectives.all_to_all(
        slots.reshape(s, e_local, capacity, -1).contiguous(), group)
    slots = slots.movedim(0, 1).reshape(e_local, s * capacity, -1)
    hidden = F.relu(torch.einsum("ekf,efh->ekh", slots, w1) + b1)
    out = torch.einsum("ekh,eho->eko", hidden, w2) + b2
    # Results back to the token owners, as [E, C, O] in expert order.
    out = out.reshape(e_local, s, capacity, -1).movedim(1, 0).contiguous()
    out = collectives.all_to_all(out, group).reshape(e, capacity, -1)
    combined = torch.einsum("nec,eco->no", combine.to(out.dtype), out)
    load = collectives.all_reduce_sum(combine.sum(-1).mean(0), group) / s
    return combined, load
