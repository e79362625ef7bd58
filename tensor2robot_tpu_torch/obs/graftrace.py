"""graftrace: end-to-end request/causality tracing + shard export.

The port's own copy of the JAX package's `obs.graftrace`, writing the
same `graftrace` v1 shards, so `graftscope timeline` / `watch` of either
package read a directory written by either. The span tracer
(`obs/trace.py`), the metrics registry and the sentinel are per-process;
graftrace makes one request (or one session tick) followable across the
threads and processes that serve it:

* **Trace contexts** — (trace_id, span_id, parent_id) triples minted at
  admission seams (`MicroBatcher.predict`, `SessionBatcher.step`) and
  propagated on a thread-local (`current()` / `activate()`), so worker
  threads and nested dispatch layers attach the SAME ids without any
  call-signature changes. `obs.trace` injects the active context's ids
  into every span/instant via the context-provider hook installed at
  import.
* **Stage decomposition** — per-request latency split into named stages
  (`queue_wait`/`batch_form`/`dispatch`/`split` sum to the end-to-end
  `serve/request_ms`; `pad`/`device` are informational sub-stages of
  dispatch) recorded into `serve/stage/<name>_ms` histograms and
  summarized by `stage_breakdown()`.
* **Causality links** — span args may carry `links` (a list of source
  span_ids); `obs.aggregate` synthesizes Perfetto flow events from
  `parent_id`/`links` at merge time (request -> batch dispatch, session
  tick -> session batch).
* **Shard export** — `configure(dir)` arms a per-process exporter;
  `flush()` drains the tracer ring into `trace-<pid>-<gen>.json` (with
  a monotonic<->epoch clock-alignment stamp, ring-bounded to `max_gens`
  generations per pid) plus a `metrics-<pid>-<gen>.json` registry
  snapshot with histogram exemplars. Subprocess workers arm themselves
  from `GRAFTRACE_DIR` / `GRAFTRACE_ROLE` (`init_from_env`);
  `GRAFTRACE_EPOCH_SKEW_NS` skews the stamped wall clock so tests can
  emit shards from processes with skewed clocks.

Framework-free: never imports torch; `flush()` never raises (telemetry
must not take a worker down); a process that never calls `configure()`
pays one dict read per `flush()` call.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
from typing import Any, Dict, Iterable, Optional

from tensor2robot_tpu_torch.obs import metrics as obs_metrics
from tensor2robot_tpu_torch.obs import trace as obs_trace

__all__ = ["TraceContext", "mint", "current", "activate",
           "request_context", "record_stage", "record_stage_many",
           "stage_breakdown", "configure", "init_from_env",
           "is_configured", "export_dir", "flush", "SUMMED_STAGES",
           "INFO_STAGES", "STAGE_PREFIX"]

STAGE_PREFIX = "serve/stage/"
# The stages whose per-request sum reconciles with the end-to-end
# `serve/request_ms` window (within 5%). `pad` and `device` happen
# INSIDE the dispatch window (engine-side sub-stages) and are reported
# but excluded from the sum — counting them twice would break the
# reconciliation by construction.
SUMMED_STAGES = ("queue_wait", "batch_form", "dispatch", "split")
INFO_STAGES = ("pad", "device")

# Process-unique id source: pid + a random per-process salt + a counter.
# The salt keeps ids unique across a pid reuse without touching
# time-of-day.
_ID_SALT = int.from_bytes(os.urandom(4), "big")
_id_lock = threading.Lock()
_id_counter = 0


def _next_id() -> str:
  global _id_counter
  with _id_lock:
    _id_counter += 1
    n = _id_counter
  return f"{os.getpid():x}.{_ID_SALT:08x}.{n:x}"


class TraceContext:
  """One causality node: (trace_id, span_id, parent_id)."""

  __slots__ = ("trace_id", "span_id", "parent_id")

  def __init__(self, trace_id: str, span_id: str,
               parent_id: Optional[str] = None):
    self.trace_id = trace_id
    self.span_id = span_id
    self.parent_id = parent_id

  def child(self) -> "TraceContext":
    """A new span under the same trace, parented on this one."""
    return TraceContext(self.trace_id, _next_id(), self.span_id)

  def args(self) -> Dict[str, str]:
    """The trace-event args the aggregator stitches flows from."""
    out = {"trace_id": self.trace_id, "span_id": self.span_id}
    if self.parent_id is not None:
      out["parent_id"] = self.parent_id
    return out

  def __repr__(self) -> str:  # debugging aid only
    return (f"TraceContext(trace={self.trace_id}, span={self.span_id}, "
            f"parent={self.parent_id})")


def mint() -> TraceContext:
  """A fresh root context (new trace_id, no parent)."""
  return TraceContext(_next_id(), _next_id(), None)


_TLS = threading.local()


def current() -> Optional[TraceContext]:
  """The thread's active context, or None."""
  return getattr(_TLS, "ctx", None)


@contextlib.contextmanager
def activate(ctx: Optional[TraceContext]):
  """Installs `ctx` as the thread's active context for the scope."""
  previous = getattr(_TLS, "ctx", None)
  _TLS.ctx = ctx
  try:
    yield ctx
  finally:
    _TLS.ctx = previous


def request_context() -> TraceContext:
  """The admission-seam helper: a child of the active context when one
  is installed (an upstream router already minted the trace), a fresh
  root otherwise (direct batcher/engine clients)."""
  ctx = current()
  return ctx.child() if ctx is not None else mint()


def _context_args() -> Optional[Dict[str, str]]:
  ctx = current()
  return ctx.args() if ctx is not None else None


# Every obs.trace span/instant recorded while a context is active gets
# the context's ids injected into its args — the existing span surface
# (engine predict, session dispatch) becomes causally linkable without
# touching its call sites.
obs_trace.set_context_provider(_context_args)


# -- stage decomposition ------------------------------------------------------


def record_stage(name: str, ms: float,
                 ctx: Optional[TraceContext] = None,
                 start_ns: Optional[int] = None) -> None:
  """Records one per-request stage sample: always into the
  `serve/stage/<name>_ms` histogram; additionally as a trace event
  when the tracer is enabled and the caller took the clock reads."""
  obs_metrics.histogram(STAGE_PREFIX + name + "_ms").record(ms)
  if start_ns is not None:
    obs_trace.add_complete(STAGE_PREFIX + name, start_ns,
                           int(ms * 1e6), cat="stage",
                           args=ctx.args() if ctx is not None else None)


def record_stage_many(name: str, values_ms: Iterable[float]) -> None:
  """Batch-amortized histogram path (one lock round trip per batch —
  the `Histogram.record_many` contract); no trace events."""
  obs_metrics.histogram(STAGE_PREFIX + name + "_ms").record_many(
      values_ms)


def stage_breakdown() -> Optional[Dict[str, Any]]:
  """Per-stage p50/p95/p99 plus the reconciliation of the summed stage
  means against the end-to-end `serve/request_ms` mean. Returns None
  when no stage was recorded in the current registry window (e.g. a
  traffic shape that never touched the batcher)."""
  registry = obs_metrics.get_registry()
  stages: Dict[str, Dict[str, float]] = {}
  summed_mean = 0.0
  for name in SUMMED_STAGES + INFO_STAGES:
    hist = registry.histogram(STAGE_PREFIX + name + "_ms")
    if not hist.count:
      continue
    p50, p95, p99 = obs_metrics.percentiles(hist.values(),
                                            (50.0, 95.0, 99.0))
    stages[name] = {"count": float(hist.count),
                    "mean_ms": round(hist.mean, 3),
                    "p50_ms": round(p50, 3), "p95_ms": round(p95, 3),
                    "p99_ms": round(p99, 3)}
    if name in SUMMED_STAGES:
      summed_mean += hist.mean
  if not stages:
    return None
  request = registry.histogram("serve/request_ms")
  request_mean = request.mean if request.count else float("nan")
  ratio = (summed_mean / request_mean
           if request.count and request_mean else None)
  return {
      "stages": stages,
      "summed": [s for s in SUMMED_STAGES if s in stages],
      "stage_sum_mean_ms": round(summed_mean, 3),
      "request_mean_ms": (round(request_mean, 3)
                          if request.count else None),
      # ~1.0 when the decomposition accounts for the whole request
      # window (within 5%); the residual is client wakeup + completion
      # bookkeeping.
      "reconciliation_ratio": (round(ratio, 4)
                               if ratio is not None else None),
  }


# -- cross-process shard export ----------------------------------------------

_export_lock = threading.Lock()
_EXPORT: Dict[str, Any] = {"dir": None, "role": "worker", "gen": 0,
                           "max_gens": 8, "skew_ns": 0}


def configure(directory: str, role: str = "worker", max_gens: int = 8,
              skew_ns: Optional[int] = None, enable: bool = True) -> None:
  """Arms the per-process shard exporter (and, by default, the tracer).

  `skew_ns` defaults to `GRAFTRACE_EPOCH_SKEW_NS` (the deliberate
  clock-skew knob the cross-process merge test injects); `max_gens`
  ring-bounds this pid's shard generations on disk.
  """
  os.makedirs(directory, exist_ok=True)
  if skew_ns is None:
    try:
      skew_ns = int(os.environ.get("GRAFTRACE_EPOCH_SKEW_NS", "0"))
    except ValueError:
      skew_ns = 0
  with _export_lock:
    _EXPORT["dir"] = os.path.abspath(directory)
    _EXPORT["role"] = str(role)
    _EXPORT["gen"] = 0
    _EXPORT["max_gens"] = max(int(max_gens), 1)
    _EXPORT["skew_ns"] = int(skew_ns)
  if enable:
    obs_trace.enable()


def init_from_env() -> bool:
  """Subprocess-worker arming: configures from `GRAFTRACE_DIR` /
  `GRAFTRACE_ROLE` when the parent exported them. Returns whether the
  exporter was armed."""
  directory = os.environ.get("GRAFTRACE_DIR")
  if not directory:
    return False
  configure(directory, role=os.environ.get("GRAFTRACE_ROLE", "worker"))
  return True


def is_configured() -> bool:
  return _EXPORT["dir"] is not None


def export_dir() -> Optional[str]:
  """The armed shard directory (None when not configured) — parents
  hand it to subprocess workers via `GRAFTRACE_DIR`."""
  return _EXPORT["dir"]


def _prune_ring_locked(directory: str, pid: int, newest_gen: int,
                       max_gens: int) -> None:
  floor = newest_gen - max_gens + 1
  if floor <= 0:
    return
  for prefix in ("trace", "metrics"):
    marker = f"{prefix}-{pid}-"
    try:
      names = os.listdir(directory)
    except OSError:
      return
    for name in names:
      if not (name.startswith(marker) and name.endswith(".json")):
        continue
      try:
        gen = int(name[len(marker):-len(".json")])
      except ValueError:
        continue
      if gen < floor:
        try:
          os.remove(os.path.join(directory, name))
        except OSError:
          pass


def flush() -> Optional[str]:
  """Drains the tracer ring into the next shard generation and writes a
  metrics snapshot beside it; returns the trace shard's path. No-op
  (None) unless `configure`d; NEVER raises (None on a failed write) —
  this is called from worker teardown paths (batcher and session
  batcher close, a dying worker) where telemetry failure must not mask
  the real shutdown. A caller that relies on the shard checks the path."""
  try:
    with _export_lock:
      directory = _EXPORT["dir"]
      if directory is None:
        return None
      gen = _EXPORT["gen"]
      _EXPORT["gen"] = gen + 1
      role = _EXPORT["role"]
      skew_ns = _EXPORT["skew_ns"]
      max_gens = _EXPORT["max_gens"]
    tracer = obs_trace.get_tracer()
    events = tracer.events()
    tracer.clear()  # drain: shard generations are disjoint windows
    pid = os.getpid()
    # The clock-alignment stamp: ONE (monotonic, epoch) pair read
    # back-to-back. Event `ts` values are perf_counter microseconds;
    # the aggregator maps them onto the epoch timeline as
    # ts + (epoch_ns - perf_ns)/1e3.
    perf_ns, epoch_ns = obs_trace.clock_stamp()
    epoch_ns += skew_ns
    payload = {"graftrace": "v1", "role": role, "pid": pid, "gen": gen,
               "clock": {"perf_ns": perf_ns, "epoch_ns": epoch_ns},
               "traceEvents": events, "displayTimeUnit": "ms"}
    path = os.path.join(directory, f"trace-{pid}-{gen:06d}.json")
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
      json.dump(payload, f)
    os.replace(tmp, path)
    registry = obs_metrics.get_registry()
    # The metrics shard carries the SAME paired clock stamp as the
    # trace shard: `graftscope watch` computes metric staleness from it
    # (now - epoch_ns) and skips a dead worker's final shard once it
    # ages past the staleness bound.
    metrics_payload = {"graftrace": "v1", "role": role, "pid": pid,
                       "gen": gen, "epoch_ns": epoch_ns,
                       "clock": {"perf_ns": perf_ns,
                                 "epoch_ns": epoch_ns},
                       "snapshot": registry.snapshot(),
                       "exemplars": registry.exemplars(clear=True)}
    mpath = os.path.join(directory, f"metrics-{pid}-{gen:06d}.json")
    mtmp = mpath + ".tmp"
    with open(mtmp, "w") as f:
      json.dump(metrics_payload, f)
    os.replace(mtmp, mpath)
    _prune_ring_locked(directory, pid, gen, max_gens)
    return path
  except Exception:  # noqa: BLE001 - teardown telemetry must not raise
    return None


def _reset_for_tests() -> None:
  """Disarms the exporter (test isolation; not part of the public API)."""
  with _export_lock:
    _EXPORT["dir"] = None
    _EXPORT["role"] = "worker"
    _EXPORT["gen"] = 0
    _EXPORT["max_gens"] = 8
    _EXPORT["skew_ns"] = 0
