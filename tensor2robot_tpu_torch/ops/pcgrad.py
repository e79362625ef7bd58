"""PCGrad gradient surgery for multi-task training.

Counterpart of `tensor2robot_tpu.ops.pcgrad`: each task's gradient is
projected onto the normal plane of every other task's gradient it
conflicts with (a negative dot product), and the projected gradients are
summed. Projection is per leaf, or over the whole flattened gradient.
Gradients are the port's flat dicts of tensors (`state_dict` names).

`allowlist` and `denylist` are regexes over the port's flat names
(`conv1_1.weight`), where the JAX package matches `keystr` paths
(`['conv1_1']['kernel']`): surgery applies only to allowed, non-denied
leaves, which are the only ones the projections see; the others get the
plain sum of the raw task gradients.

The JAX package can shuffle the order in which each task is projected
against the others with a PRNG key. The port takes the draw itself:
`permutations[i]` is the order (a permutation of range(n)) for task i,
its own index skipped. None keeps the order 0..n-1.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Sequence

import torch

__all__ = ["pcgrad_combine"]

Grads = Dict[str, torch.Tensor]

_EPS = 1e-12


def _dot(a: Grads, b: Grads) -> torch.Tensor:
  return sum(torch.sum(a[k] * b[k]) for k in a)


def _project_out(g_task: Grads, g_other: Grads, use_flat: bool) -> Grads:
  """g_task minus its conflicting component along g_other."""
  if use_flat:
    coeff = torch.clamp(_dot(g_task, g_other)
                        / (_dot(g_other, g_other) + _EPS), max=0.0)
    return {k: gt - coeff * g_other[k] for k, gt in g_task.items()}
  out = {}
  for k, gt in g_task.items():
    go = g_other[k]
    coeff = torch.clamp(torch.sum(gt * go) / (torch.sum(go * go) + _EPS),
                        max=0.0)
    out[k] = gt - coeff * go
  return out


def pcgrad_combine(task_grads: Sequence[Grads],
                   permutations: Optional[Sequence[Sequence[int]]] = None,
                   use_flat_projection: bool = False,
                   allowlist: Optional[Sequence[str]] = None,
                   denylist: Optional[Sequence[str]] = None) -> Grads:
  """One gradient dict from per-task gradient dicts by PCGrad surgery
  (see the module docstring for the arguments)."""
  task_grads = list(task_grads)
  n = len(task_grads)
  if n == 1:
    return task_grads[0]
  if permutations is not None and (
      len(permutations) != n
      or any(sorted(int(j) for j in p) != list(range(n))
             for p in permutations)):
    raise ValueError(f"permutations must hold one permutation of "
                     f"range({n}) per task, got {permutations}")

  def keep(name: str) -> bool:
    if denylist and any(re.search(p, name) for p in denylist):
      return False
    if allowlist:
      return any(re.search(p, name) for p in allowlist)
    return True

  masked = bool(allowlist or denylist)
  kept = {name: keep(name) for name in task_grads[0]}
  filtered = task_grads
  if masked:
    filtered = [{k: g if kept[k] else torch.zeros_like(g)
                 for k, g in grads.items()} for grads in task_grads]

  projected: List[Grads] = []
  for i in range(n):
    g = filtered[i]
    order = (range(n) if permutations is None
             else [int(j) for j in permutations[i]])
    for j in order:
      if j != i:
        g = _project_out(g, filtered[j], use_flat_projection)
    projected.append(g)

  combined = {k: sum(p[k] for p in projected) for k in task_grads[0]}
  if masked:
    for k in combined:
      if not kept[k]:
        combined[k] = sum(grads[k] for grads in task_grads)
  return combined
