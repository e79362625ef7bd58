"""Scalar/metric logging to a JSONL events file.

Counterpart of `tensor2robot_tpu.utils.summaries` without the optional
TensorBoard mirror: `<log_dir>/metrics.jsonl`, one JSON object per
`write_scalars` call with `step`, `time` and the scalars.

A bad value never kills a train loop. Non-scalar and non-finite values
are skipped — counted in the metrics registry
(`summaries/dropped_non_scalar`, `summaries/dropped_non_finite`) and
warned once per key — so every line stays strictly valid JSON. A 0-dim
tensor is a scalar (reading it syncs its device). `close()` fsyncs; the
writer is also a context manager.
"""

from __future__ import annotations

import json
import logging
import math
import os
import time
from typing import Dict, Mapping, Set

import numpy as np
import torch

from tensor2robot_tpu_torch.obs import metrics as obs_metrics

__all__ = ["SummaryWriter"]

_log = logging.getLogger(__name__)


class SummaryWriter:
  def __init__(self, log_dir: str):
    os.makedirs(log_dir, exist_ok=True)
    self._path = os.path.join(log_dir, "metrics.jsonl")
    self._file = open(self._path, "a")
    self._warned_keys: Set[str] = set()

  @property
  def path(self) -> str:
    return self._path

  def __enter__(self) -> "SummaryWriter":
    return self

  def __exit__(self, exc_type, exc, tb) -> None:
    self.close()

  def _warn_once(self, key: str, reason: str) -> None:
    if key in self._warned_keys:
      return
    self._warned_keys.add(key)
    _log.warning("SummaryWriter: skipping %s value for %r (further drops of "
                 "this key counted silently in summaries/dropped_%s)",
                 reason, key, reason)

  def _clean(self, scalars: Mapping[str, float]) -> Dict[str, float]:
    """Scalar-finite subset of `scalars`; drops are counted + warned."""
    out: Dict[str, float] = {}
    for key, value in scalars.items():
      try:
        if isinstance(value, torch.Tensor):
          value = value.detach().double().cpu().numpy()
        arr = np.asarray(value, dtype=np.float64)
        if arr.size != 1:
          raise ValueError(f"size {arr.size}")
        scalar = float(arr.reshape(()))
      except (TypeError, ValueError):
        obs_metrics.counter("summaries/dropped_non_scalar").inc()
        self._warn_once(key, "non_scalar")
        continue
      if not math.isfinite(scalar):
        obs_metrics.counter("summaries/dropped_non_finite").inc()
        self._warn_once(key, "non_finite")
        continue
      out[key] = scalar
    return out

  def write_scalars(self, step: int, scalars: Mapping[str, float]) -> None:
    record: Dict[str, float] = {"step": int(step), "time": time.time()}
    record.update(self._clean(scalars))
    self._file.write(json.dumps(record) + "\n")
    self._file.flush()

  def close(self) -> None:
    if not self._file.closed:
      self._file.flush()
      os.fsync(self._file.fileno())
      self._file.close()
