"""Process-wide metrics registry: counters, gauges, streaming histograms.

The port's own copy of `tensor2robot_tpu.obs.metrics`, kept separate so
that the PyTorch port never imports the JAX package. It records
everything that is NOT a per-step training scalar: pipeline wait times, serving latencies,
episode counts, bench probe outcomes. Components record into the global
registry from any thread; `snapshot()` flattens the whole registry into
plain floats for the JSONL event stream (`utils/summaries.py`) or a
bench JSON record.

Naming scheme: metric names are
`component/metric_unit` (e.g. `data/prefetch_wait_ms`,
`serve/predict_ms`); snapshot keys are prefixed by kind —
`counter/<name>`, `gauge/<name>`, `hist/<name>/<stat>` with stats
`count, mean, min, max, p50, p90, p99`.

Histograms are streaming: a bounded reservoir (Vitter's algorithm R with
a deterministic per-histogram RNG) keeps an unbiased sample of an
unbounded value stream; percentiles are exact until the reservoir fills
(numpy linear interpolation, as `np.percentile` gives). Backend-free by
construction: never imports torch.
"""

from __future__ import annotations

import contextlib
import random
import threading
import time
import zlib
from typing import Dict, Iterable, List, Optional, Sequence

import numpy as np

__all__ = ["Counter", "Gauge", "Histogram", "Registry", "get_registry",
           "counter", "gauge", "histogram", "snapshot", "reset",
           "isolated", "percentiles"]

DEFAULT_RESERVOIR_SIZE = 4096
_PCTS = (50.0, 90.0, 99.0)


def percentiles(values: Sequence[float],
                pcts: Iterable[float] = _PCTS) -> List[float]:
  """Linear-interpolation percentiles (np.percentile semantics)."""
  if not len(values):
    return [float("nan") for _ in pcts]
  return [float(v) for v in np.percentile(np.asarray(values, np.float64),
                                          list(pcts))]


class Counter:
  """Monotonic event count."""

  def __init__(self, name: str):
    self.name = name
    self._lock = threading.Lock()
    self._value = 0

  def inc(self, n: int = 1) -> None:
    with self._lock:
      self._value += n

  @property
  def value(self) -> int:
    return self._value


class Gauge:
  """Last-write-wins instantaneous value."""

  def __init__(self, name: str):
    self.name = name
    self._value = float("nan")

  def set(self, value: float) -> None:
    self._value = float(value)

  @property
  def value(self) -> float:
    return self._value


class _HistTimer:
  """Context manager recording an elapsed-milliseconds observation."""

  __slots__ = ("_hist", "_start_ns")

  def __init__(self, hist: "Histogram"):
    self._hist = hist
    self._start_ns = 0

  def __enter__(self) -> "_HistTimer":
    self._start_ns = time.perf_counter_ns()
    return self

  def __exit__(self, exc_type, exc, tb) -> None:
    self._hist.record((time.perf_counter_ns() - self._start_ns) / 1e6)


class Histogram:
  """Streaming value distribution with reservoir-sampled percentiles."""

  def __init__(self, name: str,
               reservoir_size: int = DEFAULT_RESERVOIR_SIZE):
    self.name = name
    self._lock = threading.Lock()
    self._reservoir_size = reservoir_size
    # Deterministic RNG (seeded off a stable digest of the name — NOT
    # hash(), which PYTHONHASHSEED salts per process) so a re-run of
    # the same workload snapshots the same percentiles — diffable
    # telemetry.
    self._rng = random.Random(zlib.crc32(name.encode("utf-8")))
    self._sample: List[float] = []
    self._count = 0
    self._total = 0.0
    self._min = float("inf")
    self._max = float("-inf")
    # Exemplar: the label (a graftrace trace_id) of the WORST sample
    # seen since the last `clear_exemplar()` — the link from a p99
    # regression in runs.jsonl back to its timeline entry. Kept out of
    # `snapshot()` (whose contract is numeric-only values); read via
    # `exemplar()` / `Registry.exemplars()`.
    self._ex_value = float("-inf")
    self._ex_label: Optional[str] = None

  def record(self, value: float, exemplar: Optional[str] = None) -> None:
    value = float(value)
    with self._lock:
      self._record_locked(value)
      if exemplar is not None and value >= self._ex_value:
        self._ex_value = value
        self._ex_label = str(exemplar)

  def record_many(self, values: Iterable[float]) -> None:
    """Records a batch of observations under ONE lock acquisition.

    The hot-path amortization primitive: per-item `record` costs a lock
    round trip per observation, which the data-pipeline consumer loop
    pays once per batch (`data/pipeline.prefetch`). Callers that can
    buffer a few observations locally flush them here instead —
    statistics (count/mean/min/max/reservoir) are IDENTICAL to the
    equivalent sequence of `record` calls, including the deterministic
    reservoir RNG stream.
    """
    with self._lock:
      for value in values:
        self._record_locked(float(value))

  def _record_locked(self, value: float) -> None:
    self._count += 1
    self._total += value
    self._min = min(self._min, value)
    self._max = max(self._max, value)
    if len(self._sample) < self._reservoir_size:
      self._sample.append(value)
    else:
      # Algorithm R: keep each of the n observations with prob k/n.
      idx = self._rng.randrange(self._count)
      if idx < self._reservoir_size:
        self._sample[idx] = value

  def time_ms(self) -> _HistTimer:
    """`with hist.time_ms(): ...` records the window's milliseconds."""
    return _HistTimer(self)

  @property
  def count(self) -> int:
    return self._count

  @property
  def mean(self) -> float:
    return self._total / self._count if self._count else float("nan")

  def percentile(self, pct: float) -> float:
    with self._lock:
      return percentiles(self._sample, [pct])[0]

  def values(self) -> List[float]:
    """Snapshot of the reservoir sample (an unbiased sample of the full
    observation stream once it exceeds the reservoir). Consumers that
    derive policy from observed traffic — the traffic-derived bucket
    ladder (`serving.engine.traffic_bucket_ladder`) reads the
    `serve/request_rows` reservoir — use this instead of reaching into
    `_sample`."""
    with self._lock:
      return list(self._sample)

  def stats(self) -> Dict[str, float]:
    with self._lock:
      p50, p90, p99 = percentiles(self._sample)
      return {"count": float(self._count), "mean": self.mean,
              "min": self._min if self._count else float("nan"),
              "max": self._max if self._count else float("nan"),
              "p50": p50, "p90": p90, "p99": p99}

  def exemplar(self) -> Optional[Dict[str, object]]:
    """The worst-sample exemplar since the last clear, or None."""
    with self._lock:
      if self._ex_label is None:
        return None
      return {"value": self._ex_value, "trace_id": self._ex_label}

  def clear_exemplar(self) -> None:
    """Starts a fresh exemplar window (called by the shard-snapshot
    writer so each metrics shard carries its own window's worst)."""
    with self._lock:
      self._ex_value = float("-inf")
      self._ex_label = None


class Registry:
  """Get-or-create metric store; one per process (see `get_registry`)."""

  def __init__(self):
    self._lock = threading.Lock()
    self._counters: Dict[str, Counter] = {}
    self._gauges: Dict[str, Gauge] = {}
    self._histograms: Dict[str, Histogram] = {}

  def counter(self, name: str) -> Counter:
    with self._lock:
      if name not in self._counters:
        self._counters[name] = Counter(name)
      return self._counters[name]

  def gauge(self, name: str) -> Gauge:
    with self._lock:
      if name not in self._gauges:
        self._gauges[name] = Gauge(name)
      return self._gauges[name]

  def histogram(self, name: str,
                reservoir_size: int = DEFAULT_RESERVOIR_SIZE) -> Histogram:
    with self._lock:
      if name not in self._histograms:
        self._histograms[name] = Histogram(name, reservoir_size)
      return self._histograms[name]

  def snapshot(self, prefix: Optional[str] = None) -> Dict[str, float]:
    """Flat {kind/name[/stat]: float} view of every metric.

    Suitable for `SummaryWriter.write_scalars` (all values are plain
    floats; empty histograms are omitted rather than emitting NaNs).
    With `prefix`, only metrics whose name starts with it are included.
    """
    with self._lock:
      counters = list(self._counters.values())
      gauges = list(self._gauges.values())
      hists = list(self._histograms.values())
    out: Dict[str, float] = {}
    for c in counters:
      if prefix is None or c.name.startswith(prefix):
        out[f"counter/{c.name}"] = float(c.value)
    for g in gauges:
      if prefix is None or g.name.startswith(prefix):
        out[f"gauge/{g.name}"] = g.value
    for h in hists:
      if (prefix is None or h.name.startswith(prefix)) and h.count:
        for stat, value in h.stats().items():
          out[f"hist/{h.name}/{stat}"] = value
    return out

  def stamped_snapshot(self, prefix: Optional[str] = None
                       ) -> Dict[str, object]:
    """`snapshot()` plus the paired monotonic/epoch clock stamp the
    graftrace shards carry (one back-to-back read): consumers that hold
    snapshots over time — the graftwatch SLO engine, staleness
    reporting in `graftscope watch` — get "when was this true" without
    changing the numeric-only `snapshot()` contract."""
    return {
        "clock": {"perf_ns": time.perf_counter_ns(),
                  "epoch_ns": time.time_ns()},
        "snapshot": self.snapshot(prefix),
    }

  def exemplars(self, prefix: Optional[str] = None,
                clear: bool = False) -> Dict[str, Dict[str, object]]:
    """{name: {"value", "trace_id"}} for every histogram holding an
    exemplar. Separate from `snapshot()` on purpose: snapshot values
    are plain floats consumed by scalar writers; trace ids are not.
    With `clear`, each returned exemplar's window is reset (the
    per-snapshot-window semantics the shard writer wants)."""
    with self._lock:
      hists = list(self._histograms.values())
    out: Dict[str, Dict[str, object]] = {}
    for h in hists:
      if prefix is not None and not h.name.startswith(prefix):
        continue
      ex = h.exemplar()
      if ex is not None:
        out[h.name] = ex
        if clear:
          h.clear_exemplar()
    return out

  def reset(self) -> None:
    """Drops every metric. Called by tests and by `train_eval_model` at
    run start (alongside the trace-buffer clear) so a run's final
    snapshot covers exactly that run, not earlier runs in the same
    process."""
    with self._lock:
      self._counters.clear()
      self._gauges.clear()
      self._histograms.clear()


_GLOBAL = Registry()


def get_registry() -> Registry:
  """The process-wide registry the shipped instrumentation records into."""
  return _GLOBAL


def counter(name: str) -> Counter:
  return _GLOBAL.counter(name)


def gauge(name: str) -> Gauge:
  return _GLOBAL.gauge(name)


def histogram(name: str,
              reservoir_size: int = DEFAULT_RESERVOIR_SIZE) -> Histogram:
  return _GLOBAL.histogram(name, reservoir_size)


def snapshot(prefix: Optional[str] = None) -> Dict[str, float]:
  return _GLOBAL.snapshot(prefix)


def reset() -> None:
  _GLOBAL.reset()


@contextlib.contextmanager
def isolated(registry: Optional[Registry] = None):
  """Swaps the process-global registry for a fresh one within the scope.

  Hermetic-test support: unlike `reset()` — which destroys whatever
  other suites recorded into the shared singleton — this snapshots the
  current global, installs `registry` (default: a fresh `Registry`),
  and restores the original on exit, so tests cannot leak counters into
  each other OR wipe state that outlives them. Components that captured
  the registry object before entry keep writing to the old one; the
  shipped instrumentation resolves `get_registry()` / the module-level
  helpers at call time and lands in the isolated registry.
  """
  global _GLOBAL
  previous = _GLOBAL
  _GLOBAL = registry if registry is not None else Registry()
  try:
    yield _GLOBAL
  finally:
    _GLOBAL = previous
