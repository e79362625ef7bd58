"""Cross-entropy method optimizer.

Counterpart of `tensor2robot_tpu.ops.cem`: the generic CEM the serving
policies use to maximise the critic over actions (defaults 64 samples x 3
iterations, 10 elites).

Two implementations:
* `cross_entropy_method` — torch, on the device of its inputs: the
  sampling, the candidate scoring (one batched forward of the objective)
  and the elite refit stay there; the JAX `lax.fori_loop` becomes a Python
  loop over the iterations. Normals come from an explicit
  `torch.Generator`, or from `draws` (jax threefry and torch Philox never
  agree, so parity tests inject the JAX draws there);
* `CrossEntropyMethod` — the numpy adapter for host-side objective
  functions (a remote predictor), a verbatim copy of the JAX package's.

Elites are the `num_elites` best scores, ties broken towards the lower
index as `jax.lax.top_k` breaks them: a stable descending sort, never
`torch.topk`, whose order among equal scores is unspecified on CUDA (the
critic's q is a bf16 sigmoid, so equal scores among 64 samples happen).
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

__all__ = ["cross_entropy_method", "CrossEntropyMethod"]


def cross_entropy_method(
    objective_fn: Callable[[torch.Tensor], torch.Tensor],
    mean: torch.Tensor,
    stddev: torch.Tensor,
    num_samples: int = 64,
    num_iterations: int = 3,
    num_elites: int = 10,
    low: Optional[torch.Tensor] = None,
    high: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    draws: Optional[torch.Tensor] = None,
    history: Optional[List[dict]] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
  """Maximizes objective_fn over action vectors.

  Args:
    objective_fn: [num_samples, action_dim] -> [num_samples] scores.
    mean / stddev: [action_dim] initial sampling distribution; the
      samples take their device and dtype.
    low / high: optional clipping bounds.
    generator: the source of the standard normals (on the device of
      `mean`); torch's default generator when None.
    draws: [num_iterations, num_samples, action_dim] standard normals
      used in place of the generator's.
    history: when a list, one dict per iteration is appended to it:
      `elite_idx`, and the refitted `mean` and `stddev`.

  Returns:
    (best_action [action_dim], best_score [], final_mean [action_dim]).
  """
  if num_elites < 2:
    # The Bessel-corrected (ddof=1) stddev update is 0/0 on one elite.
    raise ValueError("num_elites must be >= 2 for the stddev update.")
  action_dim = mean.shape[-1]
  shape = (num_iterations, num_samples, action_dim)
  if draws is not None and tuple(draws.shape) != shape:
    raise ValueError(f"draws must have shape {shape}, got "
                     f"{tuple(draws.shape)}")
  best_action = torch.zeros_like(mean)
  best_score = torch.tensor(-float("inf"), dtype=torch.float32,
                            device=mean.device)
  for i in range(num_iterations):
    if draws is not None:
      noise = draws[i].to(mean.device, mean.dtype)
    else:
      noise = torch.randn(shape[1:], generator=generator, device=mean.device,
                          dtype=mean.dtype)
    samples = mean + stddev * noise
    if low is not None:
      samples = torch.clamp(samples, low, high)
    scores = objective_fn(samples)
    elite_idx = torch.sort(scores, descending=True,
                           stable=True).indices[:num_elites]
    elites = samples[elite_idx]
    mean = elites.mean(0)
    # ddof=1 (Bessel), as the reference's normal-CEM update; the 1e-6
    # keeps the next iteration's spread above zero.
    stddev = elites.std(0, correction=1) + 1e-6
    top_idx = elite_idx[0]
    better = scores[top_idx] > best_score
    best_action = torch.where(better, samples[top_idx], best_action)
    best_score = torch.where(better, scores[top_idx], best_score)
    if history is not None:
      history.append({"elite_idx": elite_idx, "mean": mean,
                      "stddev": stddev})
  return best_action, best_score, mean


class CrossEntropyMethod:
  """Host-side numpy CEM with a pluggable objective (reference API)."""

  def __init__(self,
               num_samples: int = 64,
               num_iterations: int = 3,
               num_elites: int = 10,
               early_termination_stddev: float = 0.0,
               seed: Optional[int] = None):
    if num_elites > num_samples:
      raise ValueError("num_elites must be <= num_samples.")
    if num_elites < 2:
      # The Bessel-corrected (ddof=1) stddev update is 0/0 on one elite
      # (the reference's np.std(..., ddof=1) NaNs there too).
      raise ValueError("num_elites must be >= 2 for the stddev update.")
    self._num_samples = num_samples
    self._num_iterations = num_iterations
    self._num_elites = num_elites
    self._early_stddev = early_termination_stddev
    self._rng = np.random.RandomState(seed)

  def optimize(self,
               objective_fn: Callable[[np.ndarray], np.ndarray],
               mean: np.ndarray,
               stddev: np.ndarray,
               low: Optional[np.ndarray] = None,
               high: Optional[np.ndarray] = None
               ) -> Tuple[np.ndarray, float]:
    """Returns (best_action, best_score)."""
    mean = np.asarray(mean, np.float32)
    stddev = np.asarray(stddev, np.float32)
    best_action, best_score = None, -np.inf
    for _ in range(self._num_iterations):
      samples = mean + stddev * self._rng.randn(
          self._num_samples, mean.shape[-1]).astype(np.float32)
      if low is not None:
        samples = np.clip(samples, low, high)
      scores = np.asarray(objective_fn(samples)).reshape(-1)
      elite_idx = np.argsort(scores)[-self._num_elites:]
      elites = samples[elite_idx]
      mean = elites.mean(0)
      # ddof=1 (Bessel): matches the reference normal-CEM update.
      stddev = elites.std(0, ddof=1)
      if scores[elite_idx[-1]] > best_score:
        best_score = float(scores[elite_idx[-1]])
        best_action = samples[elite_idx[-1]]
      if self._early_stddev and float(stddev.max()) < self._early_stddev:
        break
    # Final sampling-distribution parameters, for callers that track the
    # distribution rather than the argmax.
    self.final_mean_ = mean
    self.final_stddev_ = stddev
    return best_action, best_score
