"""Low-overhead span tracer exporting Chrome trace-event JSON.

The port's own copy of `tensor2robot_tpu.obs.trace`, kept separate so
that the PyTorch port never imports the JAX package (as with
`obs/metrics.py`). Context-manager / decorator spans on monotonic clocks
(`time.perf_counter_ns`), one ring buffer per tracer (bounded memory,
oldest events dropped), thread-aware (per-thread `tid` + thread-name
metadata), exported in the Chrome trace-event format that
`chrome://tracing` and https://ui.perfetto.dev load directly.

Every event also carries its OS thread id (`os_tid`), the id
`torch.profiler` records beside each CUDA launch, read from the thread's
object, which caches it (`threading.get_native_id()` is a syscall on
every call). `clock_stamp()` pairs the monotonic clock with the epoch
clock that `torch.profiler` stamps its events with; `epoch_ns(ts_us,
stamp)` maps an event's `ts` onto it, so a span can be laid against a
device trace.

Stdlib only: a disabled tracer costs a single attribute check per span.
"""

from __future__ import annotations

import collections
import functools
import json
import os
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

__all__ = ["Tracer", "Span", "Phases", "get_tracer", "enable", "disable",
           "span", "phases", "traced", "instant", "add_complete", "save",
           "clear", "set_context_provider", "clock_stamp", "epoch_ns"]

# Optional trace-context hook (a request tracer may install it): a zero-arg
# callable returning the active request/causality ids as an args dict
# (or None). Every recorded event gets those ids merged into its args —
# explicit per-event args win on key collision — which is how the whole
# existing span surface becomes causally linkable without changing any
# call site. Module-level (not per-Tracer): the context is a property
# of the running thread, not of the buffer it lands in.
_CONTEXT_PROVIDER = None


def set_context_provider(provider) -> None:
  global _CONTEXT_PROVIDER
  _CONTEXT_PROVIDER = provider

# Chrome trace events use microsecond timestamps; perf_counter_ns is the
# monotonic source (wall clocks can step backwards mid-span).
_NS_PER_US = 1000.0


def clock_stamp() -> Tuple[int, int]:
  """(perf_ns, epoch_ns): the monotonic clock spans are stamped with and
  the epoch clock (`time.time_ns`, the clock `torch.profiler` stamps its
  events with), read back to back. The one place that reads the pair."""
  perf_ns = time.perf_counter_ns()
  return perf_ns, time.time_ns()


def epoch_ns(ts_us: float, stamp: Tuple[int, int]) -> int:
  """An event's `ts` (perf_counter microseconds) on the epoch clock of
  `stamp`: ts + (epoch_ns - perf_ns)."""
  perf_ns, epoch = stamp
  return round(ts_us * _NS_PER_US) + epoch - perf_ns


class Span:
  """One in-flight span; records a complete ('X') event on exit.

  Re-entrant use is wrong (one Span = one window); allocate via
  `Tracer.span`. A span created while the tracer is disabled is the
  shared no-op instance and records nothing.
  """

  __slots__ = ("_tracer", "_name", "_cat", "_args", "_start_ns")

  def __init__(self, tracer: Optional["Tracer"], name: str, cat: str,
               args: Optional[Dict[str, Any]]):
    self._tracer = tracer
    self._name = name
    self._cat = cat
    self._args = args
    self._start_ns = 0

  def __enter__(self) -> "Span":
    if self._tracer is not None:
      self._start_ns = time.perf_counter_ns()
    return self

  def __exit__(self, exc_type, exc, tb) -> None:
    if self._tracer is not None:
      end_ns = time.perf_counter_ns()
      self._tracer._record(self._name, self._cat, self._start_ns,
                           end_ns - self._start_ns, self._args)


_NULL_SPAN = Span(None, "", "", None)


class Phases:
  """A parent span cut into consecutive children: `next(name)` ends the
  running child and starts `name` at the same clock read, so the
  children tile the parent; `end()` records the last child and the
  parent. Allocate via `Tracer.phases`; while the tracer is disabled it
  is the shared no-op instance."""

  __slots__ = ("_tracer", "_name", "_cat", "_start_ns", "_child",
               "_child_args", "_child_ns")

  def __init__(self, tracer: Optional["Tracer"], name: str, cat: str,
               first: str):
    self._tracer = tracer
    self._name = name
    self._cat = cat
    self._child = first
    self._child_args: Optional[Dict[str, Any]] = None
    self._start_ns = self._child_ns = (
        time.perf_counter_ns() if tracer is not None else 0)

  def next(self, name: str, **args: Any) -> None:
    if self._tracer is None:
      return
    now = time.perf_counter_ns()
    self._tracer._record(self._child, self._cat, self._child_ns,
                         now - self._child_ns, self._child_args)
    self._child, self._child_args, self._child_ns = name, args or None, now

  def end(self) -> None:
    if self._tracer is None:
      return
    now = time.perf_counter_ns()
    self._tracer._record(self._child, self._cat, self._child_ns,
                         now - self._child_ns, self._child_args)
    self._tracer._record(self._name, self._cat, self._start_ns,
                         now - self._start_ns, None)


_NULL_PHASES = Phases(None, "", "", "")


def _event_size(event: Dict[str, Any]) -> int:
  """Cheap per-event byte estimate for the ring's byte bound: fixed
  framing + name/cat + per-arg framing + string payload lengths.
  Deliberately NOT json.dumps or str(args) (either would dominate the
  cost of every append — str(args) alone was ~40% of the traced-arm
  fleet-bench overhead); non-string values count a flat 8, so the
  estimate only needs to be proportional, the bound is approximate."""
  size = 96 + len(event.get("name", "")) + len(event.get("cat", ""))
  args = event.get("args")
  if args:
    size += 16 * len(args)
    for key, value in args.items():
      size += len(key) + (len(value) if type(value) is str else 8)
  return size


class Tracer:
  """Bounded in-memory event buffer with Chrome-trace JSON export.

  Bounded BOTH by event count and by estimated bytes (`max_bytes`):
  a count-only ring lets a few arg-heavy spans (rung traces, fat
  request args) hold megabytes hostage in an always-on worker. Oldest
  events are dropped first; `dropped_events` counts them.
  """

  def __init__(self, max_events: int = 200_000,
               max_bytes: int = 64 << 20):
    self._events: "collections.deque" = collections.deque()
    self._sizes: "collections.deque" = collections.deque()
    self._bytes = 0
    self._max_events = max_events
    self._max_bytes = max_bytes
    self._dropped = 0
    self._lock = threading.Lock()
    self._thread_names: Dict[int, str] = {}
    self._enabled = False
    # Cached: one getpid() syscall per EVENT is measurable on the
    # serving hot path. Refreshed after fork (register_at_fork below).
    self._pid = os.getpid()

  def _refresh_pid(self) -> None:
    self._pid = os.getpid()

  # -- lifecycle ------------------------------------------------------------

  @property
  def enabled(self) -> bool:
    return self._enabled

  @property
  def dropped_events(self) -> int:
    return self._dropped

  @property
  def buffered_bytes(self) -> int:
    return self._bytes

  def enable(self) -> None:
    self._enabled = True

  def disable(self) -> None:
    self._enabled = False

  def clear(self) -> None:
    with self._lock:
      self._events.clear()
      self._sizes.clear()
      self._bytes = 0
      self._dropped = 0
      self._thread_names.clear()

  # -- recording ------------------------------------------------------------

  def span(self, name: str, cat: str = "span", **args: Any) -> Span:
    """Context manager timing a code window as one complete event."""
    if not self._enabled:
      return _NULL_SPAN
    return Span(self, name, cat, args or None)

  def phases(self, name: str, first: str, cat: str = "span") -> Phases:
    """A span `name` whose first child `first` starts with it; see
    `Phases`."""
    if not self._enabled:
      return _NULL_PHASES
    return Phases(self, name, cat, first)

  def traced(self, name: Optional[str] = None, cat: str = "span"):
    """Decorator form of `span` (one event per call)."""

    def wrap(fn):
      span_name = name or getattr(fn, "__qualname__", fn.__name__)

      @functools.wraps(fn)
      def inner(*a, **kw):
        with self.span(span_name, cat=cat):
          return fn(*a, **kw)

      return inner

    return wrap

  def instant(self, name: str, cat: str = "instant", **args: Any) -> None:
    """Zero-duration marker event."""
    if not self._enabled:
      return
    now = time.perf_counter_ns()
    self._append({"name": name, "cat": cat, "ph": "i",
                  "ts": now / _NS_PER_US, "s": "t",
                  "pid": self._pid, "tid": threading.get_ident(),
                  "os_tid": threading.current_thread().native_id,
                  **({"args": args} if args else {})})

  def add_complete(self, name: str, start_ns: int, dur_ns: int,
                   cat: str = "span",
                   args: Optional[Dict[str, Any]] = None) -> None:
    """Records an externally timed window (clock reads already taken by
    the caller — e.g. stepstats' barrier-bounded step windows)."""
    if not self._enabled:
      return
    self._record(name, cat, start_ns, dur_ns, args)

  def _record(self, name: str, cat: str, start_ns: int, dur_ns: int,
              args: Optional[Dict[str, Any]]) -> None:
    self._append({"name": name, "cat": cat, "ph": "X",
                  "ts": start_ns / _NS_PER_US,
                  "dur": max(dur_ns, 0) / _NS_PER_US,
                  "pid": self._pid, "tid": threading.get_ident(),
                  "os_tid": threading.current_thread().native_id,
                  **({"args": args} if args else {})})

  def _append(self, event: Dict[str, Any]) -> None:
    provider = _CONTEXT_PROVIDER
    if provider is not None:
      try:
        ctx_args = provider()
      except Exception:  # noqa: BLE001 - a hook must not break recording
        ctx_args = None
      if ctx_args:
        merged = dict(ctx_args)
        merged.update(event.get("args") or {})
        event["args"] = merged
    size = _event_size(event)
    tid = event["tid"]
    with self._lock:
      if tid not in self._thread_names:
        self._thread_names[tid] = threading.current_thread().name
      self._events.append(event)
      self._sizes.append(size)
      self._bytes += size
      while self._events and (len(self._events) > self._max_events
                              or self._bytes > self._max_bytes):
        self._events.popleft()
        self._bytes -= self._sizes.popleft()
        self._dropped += 1

  # -- export ---------------------------------------------------------------

  def events(self) -> List[Dict[str, Any]]:
    """Snapshot of buffered events plus thread-name metadata events."""
    with self._lock:
      events = list(self._events)
      names = dict(self._thread_names)
    pid = os.getpid()
    meta = [{"name": "thread_name", "ph": "M", "pid": pid, "tid": tid,
             "args": {"name": thread_name}}
            for tid, thread_name in sorted(names.items())]
    return meta + events

  def save(self, path: str) -> str:
    """Writes the Chrome trace-event JSON object format; returns path.

    Open the file in Perfetto (https://ui.perfetto.dev) or
    chrome://tracing — both consume this format unmodified.
    """
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    payload = {"traceEvents": self.events(), "displayTimeUnit": "ms"}
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
      json.dump(payload, f)
    os.replace(tmp, path)
    return path


_GLOBAL = Tracer()
# The cached pid must not survive a fork (events would carry the
# parent's pid and the aggregator would fold two processes into one
# timeline row).
os.register_at_fork(after_in_child=lambda: _GLOBAL._refresh_pid())


def get_tracer() -> Tracer:
  """The process-wide tracer the shipped instrumentation records into."""
  return _GLOBAL


def enable() -> None:
  _GLOBAL.enable()


def disable() -> None:
  _GLOBAL.disable()


def span(name: str, cat: str = "span", **args: Any) -> Span:
  return _GLOBAL.span(name, cat=cat, **args)


def phases(name: str, first: str, cat: str = "span") -> Phases:
  return _GLOBAL.phases(name, first, cat=cat)


def traced(name: Optional[str] = None, cat: str = "span"):
  return _GLOBAL.traced(name, cat=cat)


def instant(name: str, cat: str = "instant", **args: Any) -> None:
  _GLOBAL.instant(name, cat=cat, **args)


def add_complete(name: str, start_ns: int, dur_ns: int, cat: str = "span",
                 args: Optional[Dict[str, Any]] = None) -> None:
  _GLOBAL.add_complete(name, start_ns, dur_ns, cat=cat, args=args)


def save(path: str) -> str:
  return _GLOBAL.save(path)


def clear() -> None:
  _GLOBAL.clear()
