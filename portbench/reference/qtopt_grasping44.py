"""Plain float32 reference of `qtopt_grasping44`: the QT-Opt Grasping44
critic (Kalashnikov et al. 2018, arXiv:1806.10293), its squared-error
loss against the grasp reward, and its training recipe.

Written from the published tower, not from the program: a 6x6/2 stem
conv with bias and batch norm without scale, 3x3/3 max-pool, six 5x5
convs, 3x3/3 pool, the grasp-param blocks (a Dense(256) each, summed in
sorted name order) -> batch norm -> Dense(64) -> batch norm, added onto
the image embedding, six 3x3 convs, 2x2/2 pool, three VALID 3x3 convs,
flatten (in NHWC order), two Dense(64) + batch norm, a logit and a
sigmoid. Every conv and pool pads 'SAME' as TensorFlow does (the odd
pixel after), pools with -inf. Batch norm in training normalises by the
batch's mean and biased variance E[x^2] - E[x]^2 and moves its running
statistics by `decay`. The step: weight decay on the kernels (rank > 1)
added to the gradient, momentum `t = g + m t`, the learning rate
`lr * rate ** floor(count / steps)`, then the EMA of the parameters.
It imports nothing of the program.

`mode` rounds the operands of every product and the tensors each layer
hands on (`portbench.precision`): "float32" is the reference, "fp8" its
control, "bf16" a witness.
"""

from __future__ import annotations

import math
from typing import Dict, List, Mapping, Tuple

import torch
import torch.nn.functional as F

from portbench import precision

Params = Dict[str, torch.Tensor]


def _same(size: int, kernel: int, stride: int) -> Tuple[int, int]:
  out = -(-size // stride)
  total = max((out - 1) * stride + kernel - size, 0)
  return total // 2, total - total // 2


def _conv(x, p: Params, name: str, stride: int, same: bool, mode: str):
  w = p[name + ".weight"]
  if same:
    top, bottom = _same(x.shape[2], w.shape[2], stride)
    left, right = _same(x.shape[3], w.shape[3], stride)
    x = F.pad(x, (left, right, top, bottom))
  return precision.stored(F.conv2d(
      precision.operand(x, mode), precision.operand(w, mode),
      p.get(name + ".bias"), stride), mode)


def _pool(x, window: int):
  top, bottom = _same(x.shape[2], window, window)
  left, right = _same(x.shape[3], window, window)
  x = F.pad(x, (left, right, top, bottom), value=float("-inf"))
  return F.max_pool2d(x, window, window)


def _dense(x, p: Params, name: str, mode: str):
  y = precision.operand(x, mode) @ precision.operand(p[name + ".weight"],
                                                     mode).t()
  bias = p.get(name + ".bias")
  return precision.stored(y if bias is None else y + bias, mode)


def forward(p: Params, stats: Params, features: Mapping, cfg: Mapping,
            mode: str = "float32"):
  """(q [B, 1], new running statistics) of the training forward."""
  m = cfg["model"]
  decay, eps = m["batch_norm_decay"], m["batch_norm_epsilon"]
  new: Params = {}

  def bn_relu(name, x):
    dims = (0, 2, 3) if x.ndim == 4 else (0,)
    shape = (1, -1, 1, 1) if x.ndim == 4 else (1, -1)
    mean = x.mean(dims)
    var = torch.clamp((x * x).mean(dims) - mean * mean, min=0.0)
    new[name + ".running_mean"] = (decay * stats[name + ".running_mean"]
                                   + (1 - decay) * mean.detach())
    new[name + ".running_var"] = (decay * stats[name + ".running_var"]
                                  + (1 - decay) * var.detach())
    y = (x - mean.view(shape)) * torch.rsqrt(var.view(shape) + eps)
    if name + ".weight" in p:
      y = y * p[name + ".weight"].view(shape)
    return torch.relu(precision.stored(y + p[name + ".bias"].view(shape),
                                       mode))

  convs = m["num_convs"]
  x = precision.stored(features["state/image"].float().div(255.0),
                       mode).permute(0, 3, 1, 2)
  x = _pool(bn_relu("conv1_bn", _conv(x, p, "conv1_1", 2, True, mode)), 3)
  ids = iter(range(2, 2 + sum(convs)))
  for _ in range(convs[0]):
    i = next(ids)
    x = bn_relu(f"conv{i}_bn", _conv(x, p, f"conv{i}", 1, True, mode))
  x = _pool(x, 3)
  grasp = features["action/action"].float()
  blocks = sorted(m["grasp_param_names"].items())
  g = precision.stored(sum(_dense(grasp[:, off:off + width], p, name, mode)
                           for name, (off, width) in blocks), mode)
  g = bn_relu("fcgrasp_bn", g)
  g = bn_relu("fcgrasp2_bn", _dense(g, p, "fcgrasp2", mode))
  x = precision.stored(x + g[:, :, None, None], mode)
  for _ in range(convs[1]):
    i = next(ids)
    x = bn_relu(f"conv{i}_bn", _conv(x, p, f"conv{i}", 1, True, mode))
  x = _pool(x, 2)
  for _ in range(convs[2]):
    i = next(ids)
    x = bn_relu(f"conv{i}_bn", _conv(x, p, f"conv{i}", 1, False, mode))
  x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
  for i in range(m["hid_layers"]):
    x = bn_relu(f"fc{i}_bn", _dense(x, p, f"fc{i}", mode))
  return precision.stored(torch.sigmoid(_dense(x, p, "logit", mode)),
                          mode), new


def train_readings(params0: Params, mutable0: Params, batches: List,
                   cfg: Mapping, mode: str = "float32") -> Dict:
  """Training steps on each (features, labels) of `batches`, from
  `params0` and the running statistics `mutable0`: {"losses": [...],
  "first_gradient": {leaf: tensor}, "after": {"params", "ema",
  "mutable"}}. Batch norm couples the rows, so the whole batch runs at
  once."""
  t = cfg["train"]
  opt = t["optimizer"]
  p = {k: v.detach().float().clone() for k, v in params0.items()}
  ema = {k: v.clone() for k, v in p.items()}
  stats = {k: v.detach().float().clone() for k, v in mutable0.items()}
  trace = {k: torch.zeros_like(v) for k, v in p.items()}
  losses, first = [], None
  for count, (features, labels) in enumerate(batches):
    leaves = {k: v.clone().requires_grad_(True) for k, v in p.items()}
    q, stats = forward(leaves, stats, features, cfg, mode)
    loss = torch.mean((q - labels["reward"].float()) ** 2)
    grads = dict(zip(leaves, torch.autograd.grad(loss,
                                                 list(leaves.values()))))
    losses.append(float(loss.detach()))
    if first is None:
      first = {k: g.clone() for k, g in grads.items()}
    lr = float(torch.tensor(opt["learning_rate"], dtype=torch.float32)
               * torch.tensor(opt["decay_rate"], dtype=torch.float32)
               ** math.floor(count / opt["decay_steps"]))
    for k, g in grads.items():
      if g.ndim > 1:
        g = g + opt["weight_decay"] * p[k]
      trace[k] = g + opt["momentum"] * trace[k]
      p[k] = p[k] - lr * trace[k]
      ema[k] = ema[k] * t["ema_decay"] + (1.0 - t["ema_decay"]) * p[k]
    del leaves, q, loss, grads
  return {"losses": losses, "first_gradient": first,
          "after": {"params": p, "ema": ema, "mutable": stats}}
