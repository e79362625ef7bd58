"""Plain float32 reference of `seq_policy_t4096`: the causal pre-LN
sequence policy, its mean-squared-error loss and its Adam step.

Written from the architecture, not from the program: embed -> N x
(LayerNorm -> causal multi-head attention -> residual, LayerNorm -> MLP
with tanh GELU -> residual) -> head, LayerNorm eps from the
configuration. Attention is softmax(q k^T / sqrt(D)) v over the whole
[T, T] matrix. Adam is optax's (bias correction at count + 1, eps
outside the square root). It imports nothing of the program and takes
only the benchmark's inputs (weights, observations, targets).

`mode` rounds the operands of every product and the tensors each layer
hands on (`portbench.precision`): "float32" is the reference, "fp8" and
"tf32" its controls, "bf16" a witness.
"""

from __future__ import annotations

import math
from typing import Dict, List, Mapping

import torch

from portbench import precision

Params = Dict[str, torch.Tensor]


def _linear(x, p: Params, name: str, mode: str) -> torch.Tensor:
  y = precision.operand(x, mode) @ precision.operand(p[name + ".weight"],
                                                     mode).t()
  bias = p.get(name + ".bias")
  return precision.stored(y if bias is None else y + bias, mode)


def _layernorm(x, p: Params, name: str, eps: float,
               mode: str) -> torch.Tensor:
  mean = x.mean(-1, keepdim=True)
  var = ((x - mean) ** 2).mean(-1, keepdim=True)
  return precision.stored((x - mean) / torch.sqrt(var + eps)
                          * p[name + ".weight"] + p[name + ".bias"], mode)


def _gelu_tanh(x, mode: str) -> torch.Tensor:
  return precision.stored(0.5 * x * (1.0 + torch.tanh(
      math.sqrt(2.0 / math.pi) * (x + 0.044715 * x ** 3))), mode)


def _attention(x, p: Params, i: int, heads: int, mode: str) -> torch.Tensor:
  b, t, width = x.shape
  d = width // heads

  def split(name):
    return _linear(x, p, f"attn_{i}.{name}", mode).view(
        b, t, heads, d).transpose(1, 2)

  q, k, v = split("q_proj"), split("k_proj"), split("v_proj")
  scores = (precision.operand(q, mode)
            @ precision.operand(k, mode).transpose(-1, -2)) / math.sqrt(d)
  causal = torch.ones((t, t), dtype=torch.bool, device=x.device).tril()
  weights = torch.softmax(scores.masked_fill(~causal, float("-inf")), -1)
  out = precision.operand(weights, mode) @ precision.operand(v, mode)
  out = precision.stored(out.transpose(1, 2).reshape(b, t, width), mode)
  return _linear(out, p, f"attn_{i}.out_proj", mode)


def forward(p: Params, obs: torch.Tensor, cfg: Mapping,
            mode: str = "float32") -> torch.Tensor:
  """[B, T, obs] -> [B, T, action]."""
  m = cfg["model"]
  eps = m["layernorm_eps"]
  x = _linear(obs.float(), p, "embed", mode)
  for i in range(m["num_blocks"]):
    x = precision.stored(x + _attention(
        _layernorm(x, p, f"ln_attn_{i}", eps, mode), p, i, m["num_heads"],
        mode), mode)
    y = _layernorm(x, p, f"ln_mlp_{i}", eps, mode)
    x = precision.stored(x + _linear(
        _gelu_tanh(_linear(y, p, f"mlp_in_{i}", mode), mode), p,
        f"mlp_out_{i}", mode), mode)
  return _linear(x, p, "head", mode)


def serve_outputs(p: Params, obs: torch.Tensor, cfg: Mapping,
                  mode: str = "float32", rows: int = 4) -> torch.Tensor:
  """The action at every position of each [T, obs] observation row of
  `obs` ([E, T, obs]), `rows` rows at a time."""
  with torch.no_grad():
    return torch.cat([forward(p, obs[i:i + rows], cfg, mode)
                      for i in range(0, obs.shape[0], rows)])


def train_readings(params0: Params, mutable0: Params, batches: List,
                   cfg: Mapping, mode: str = "float32",
                   rows: int = 2) -> Dict:
  """Adam steps of the loss on each (features, labels) of `batches`, from
  `params0`: {"losses": [...], "first_gradient": {leaf: tensor},
  "after": {"params": ..., "ema": None, "mutable": {}}}. The gradient of
  the mean over the batch is summed over blocks of `rows` rows (the model
  has no term across rows), so the whole batch need not fit at once."""
  del mutable0  # the model keeps no running statistics
  opt = cfg["train"]["optimizer"]
  lr, b1, b2, eps = (opt["learning_rate"], opt["b1"], opt["b2"], opt["eps"])
  p = {k: v.detach().float().clone() for k, v in params0.items()}
  mu = {k: torch.zeros_like(v) for k, v in p.items()}
  nu = {k: torch.zeros_like(v) for k, v in p.items()}
  losses, first = [], None
  for count, (features, labels) in enumerate(batches, start=1):
    obs = features["observation"].float()
    target = labels["action"].float()
    leaves = {k: v.clone().requires_grad_(True) for k, v in p.items()}
    grads = {k: torch.zeros_like(v) for k, v in p.items()}
    loss = 0.0
    for i in range(0, obs.shape[0], rows):
      out = forward(leaves, obs[i:i + rows], cfg, mode)
      part = ((out - target[i:i + rows]) ** 2).sum() / target.numel()
      for k, g in zip(leaves, torch.autograd.grad(part, list(leaves.values()),
                                                  allow_unused=True)):
        if g is not None:
          grads[k] += g
      loss += float(part.detach())
    losses.append(loss)
    if first is None:
      first = {k: g.clone() for k, g in grads.items()}
    bc1 = float(1 - torch.tensor(b1, dtype=torch.float32) ** count)
    bc2 = float(1 - torch.tensor(b2, dtype=torch.float32) ** count)
    for k, g in grads.items():
      mu[k] = (1 - b1) * g + b1 * mu[k]
      nu[k] = (1 - b2) * (g * g) + b2 * nu[k]
      p[k] = p[k] - lr * ((mu[k] / bc1) / (torch.sqrt(nu[k] / bc2) + eps))
  return {"losses": losses, "first_gradient": first,
          "after": {"params": p, "ema": None, "mutable": {}}}
