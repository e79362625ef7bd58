"""The numbers that decide `correct`, from the program's readings and the
reference's.

Training (`train_numbers`), over the first three steps of the object
the window then drives:

* `loss_gap`: the largest of |program loss - reference loss| / |reference
  loss| over the three steps;
* `grad_gap`: by the worst leaf, the gap between the program's and the
  reference's norm of the first gradient as the optimizer got it, over
  the larger of the reference's norm of that leaf and of the median
  leaf;
* `update_gap`: the same of the change of each leaf of the state over
  the three steps (parameters, EMA shadow, batch-norm statistics), each
  group against its own median leaf.

`grad_gap_median` is the median leaf's gap instead of the worst leaf's:
steady from seed to seed where a few small leaves' gaps are rounding
amplified by cancellation (a cell's limits say which it compares).
`update_gap_median` is the largest of the groups' median-leaf gaps of the
change (`update_gap_median.<group>`, each group's median taken alone), so
a group left unchanged (an EMA never updated, batch-norm statistics never
moved) reads about 1 however many leaves the other groups hold. `grad_diff_median` is the median leaf's norm of the
difference of the two first gradients, over the same denominator: it
sees a gradient that points elsewhere with the same norm, as one taken
over half of a long-sequence batch does.

A parameter (and its EMA shadow) whose reference gradient is under a
thousandth of the median leaf's is left out of both: its gradient is
nought but for rounding (a key's bias under softmax, a bias before batch
norm), so the program's reads its rounding, and under Adam it moves by
round-off alone.

Serving (`serve_numbers`): `action_gap`, the largest |served - reference|
over every compared tick and action entry, over the root mean square of
the reference's actions.
"""

from __future__ import annotations

import statistics
from typing import Dict, List, Mapping

import numpy as np
import torch

NOUGHT = 1e-3


def _norm(x: torch.Tensor) -> float:
  return float(x.detach().double().norm())


def _gaps(program: Mapping[str, float], reference: Mapping[str, float],
          leaves, median: float) -> List[float]:
  """Each leaf's gap of norms, over the larger of the reference's norm
  of that leaf and `median`."""
  return [abs(program[k] - reference[k]) / max(reference[k], median, 1e-30)
          for k in leaves]


def train_numbers(program: Mapping, reference: Mapping,
                  params0: Mapping[str, torch.Tensor],
                  mutable0: Mapping[str, torch.Tensor]) -> Dict[str, float]:
  """`program` and `reference` hold "losses", "first_gradient" and
  "after" ({"params", "ema" or None, "mutable"})."""
  loss_gap = max(abs(p - r) / max(abs(r), 1e-30)
                 for p, r in zip(program["losses"], reference["losses"]))
  grads_p = {k: _norm(g) for k, g in program["first_gradient"].items()}
  grads_r = {k: _norm(g) for k, g in reference["first_gradient"].items()}
  median = statistics.median(grads_r.values())
  moving = [k for k, n in grads_r.items() if n >= NOUGHT * median]
  grad = _gaps(grads_p, grads_r, moving, median)
  diff = [_norm(program["first_gradient"][k].float()
                - reference["first_gradient"][k].float())
          / max(grads_r[k], median) for k in moving]
  update, medians = [], {}
  for group, start in (("params", params0), ("ema", params0),
                       ("mutable", mutable0)):
    after_p, after_r = program["after"][group], reference["after"][group]
    if not after_r:
      continue
    leaves = moving if group != "mutable" else list(after_r)
    change_p = {k: _norm(after_p[k].float() - start[k].float())
                for k in leaves}
    change_r = {k: _norm(after_r[k].float() - start[k].float())
                for k in leaves}
    gaps = _gaps(change_p, change_r, leaves,
                 statistics.median(change_r.values()))
    update += gaps
    medians[f"update_gap_median.{group}"] = statistics.median(gaps)
  return {"loss_gap": loss_gap, "grad_gap": max(grad),
          "grad_gap_median": statistics.median(grad),
          "grad_diff_median": statistics.median(diff),
          "update_gap": max(update),
          "update_gap_median": max(medians.values()), **medians}


def serve_numbers(served: np.ndarray, reference: np.ndarray
                  ) -> Dict[str, float]:
  """`served` and `reference`: the same [n, action] ticks."""
  if served.size == 0:
    return {"action_gap": float("inf")}
  rms = float(np.sqrt(np.mean(reference.astype(np.float64) ** 2)))
  gap = float(np.max(np.abs(served.astype(np.float64)
                            - reference.astype(np.float64))))
  return {"action_gap": gap / max(rms, 1e-30)}


UNREAD = 1e300  # a number that is not finite (or was not read) reads so


def judge(numbers: Mapping[str, float], limits: Mapping[str, float]
          ) -> Dict[str, Dict[str, float]]:
  """{name: {"value", "limit"}} of every limited number; a number that
  was not read or is not finite reads `UNREAD`, which fails."""
  def value(name):
    x = float(numbers.get(name, UNREAD))
    return x if np.isfinite(x) else UNREAD

  return {name: {"value": value(name), "limit": float(limit)}
          for name, limit in limits.items()}


def passes(checks: Mapping[str, Mapping[str, float]]) -> bool:
  return bool(checks) and all(c["value"] <= c["limit"]
                              for c in checks.values())
