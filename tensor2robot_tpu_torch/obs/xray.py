"""graftscope-xray, first part: memory accounting of a train state.

The port's subset of the JAX package's `obs.xray`. `memory_accounting`
prices a `TrainState` (+ optional batch) in bytes — params, optimizer
state, EMA shadow, mutable state, batch — and `hbm_watermark_estimate`
turns that into the per-device watermark estimate the run record carries
(`memory.hbm_watermark_bytes`): resident state + resident batch + the
scratch a train step needs, whose floor is the parameter bytes again
(the gradients). An ESTIMATE, not an allocator readout: the run record
carries the allocator's own peak beside it (`utils.backend`).

The port runs one device, so the per-shard figures equal the global
ones. The compile half of the JAX module (`XrayedFunction`,
`analyze_jit`: compile time, program size, cost and memory analysis of a
compiled executable) waits for the torch analogue of that tooling
(ROADMAP.md, Queue A item 15); until then `records()` is always empty
and a run record has no compile block. Framework-free at import: leaves
are priced by their `nbytes`, or `shape` and `dtype` when they have no
`nbytes`.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Mapping

__all__ = ["memory_accounting", "hbm_watermark_estimate", "pytree_bytes",
           "records", "clear_records"]

_RECORDS: List[Dict[str, Any]] = []
_LOCK = threading.Lock()


def records() -> List[Dict[str, Any]]:
  """Compile records collected since the last `clear_records()` (none
  yet in the port: module docstring)."""
  with _LOCK:
    return list(_RECORDS)


def clear_records() -> None:
  """Drops collected records (run start, alongside trace/metrics reset)."""
  with _LOCK:
    _RECORDS.clear()


def _leaves(tree) -> List[Any]:
  """The leaves of nested dicts, lists and tuples (a tensor or array, or
  anything else, is a leaf)."""
  if isinstance(tree, Mapping):
    return [leaf for value in tree.values() for leaf in _leaves(value)]
  if isinstance(tree, (list, tuple)):
    return [leaf for value in tree for leaf in _leaves(value)]
  if tree is None:
    return []
  return [tree]


def _leaf_nbytes(leaf) -> int:
  """Logical bytes of one tensor or array leaf (0 for anything else)."""
  nbytes = getattr(leaf, "nbytes", None)
  if nbytes is not None:
    return int(nbytes)
  shape = getattr(leaf, "shape", None)
  itemsize = getattr(getattr(leaf, "dtype", None), "itemsize", None)
  if shape is None or itemsize is None:
    return 0
  size = 1
  for dim in shape:
    size *= int(dim)
  return size * int(itemsize)


def pytree_bytes(tree) -> int:
  """Total logical bytes over every tensor/array leaf of `tree`."""
  return sum(_leaf_nbytes(x) for x in _leaves(tree))


def memory_accounting(state=None, batch=None) -> Dict[str, float]:
  """Prices a TrainState (+ optional batch) in bytes under the JAX
  package's keys (`<field>_bytes` and, equal on one device,
  `<field>_bytes_per_shard`). `state` is duck-typed on the TrainState
  fields (`params`, `opt_state`, `ema_params`, `mutable_state`); any may
  be absent."""
  out: Dict[str, float] = {}
  state_total = 0
  for field, key in (("params", "params"), ("opt_state", "opt_state"),
                     ("ema_params", "ema"), ("mutable_state", "mutable")):
    tree = getattr(state, field, None)
    if tree is None:
      continue
    total = pytree_bytes(tree)
    out[f"{key}_bytes"] = out[f"{key}_bytes_per_shard"] = float(total)
    state_total += total
  if state is not None:
    out["state_bytes"] = out["state_bytes_per_shard"] = float(state_total)
  if batch is not None:
    out["batch_bytes"] = out["batch_bytes_per_shard"] = float(
        pytree_bytes(batch))
  return out


def hbm_watermark_estimate(memory: Dict[str, float],
                           compile_records=()) -> float:
  """Per-device watermark estimate in bytes: resident state + resident
  batch + the step's scratch — a compile record's `temp_bytes` when one
  reports it, else the parameter bytes again (the gradient buffers a
  train step materializes, the floor for any backward pass)."""
  temp = max((float(r.get("temp_bytes") or 0.0) for r in compile_records),
             default=0.0)
  scratch = max(temp, memory.get("params_bytes_per_shard", 0.0))
  return (memory.get("state_bytes_per_shard", 0.0)
          + memory.get("batch_bytes_per_shard", 0.0) + scratch)
