"""Crash/hang flight recorder: bounded ring buffers + postmortem bundles.

The port's own copy of the JAX package's `obs.flightrec`, writing the
same `graftscope-postmortem-v1` bundle. When a run dies, the scalars it
flushed say little about its last healthy steps, the incident sequence
or when the device stopped answering; this recorder keeps that evidence.

The `FlightRecorder` keeps O(1)-memory ring buffers of recent step
records and sentinel incidents, and on a fatal event dumps a bundle —
the last N steps, incidents, the heartbeat timeline
(`utils.backend.tunnel_health()`: on a local card, the health of the
step-stats barrier), a metrics registry snapshot, the buffered trace
spans, and (for crashes) the exception traceback — into
`<out_dir>/postmortem-<stamp>-<reason>/`. Dump triggers:

* **unhandled exception** — the train loop wraps its body and calls
  `dump("exception", exc=e)` before re-raising;
* **SIGTERM** — an installed handler that records and flushes
  HOST-side state only and never touches the device (a device call from
  a signal handler may block behind the very work that hung), then
  chains to the previous disposition so the process still terminates.
  It is installed on the main thread only: a trainer run on another
  thread (a continuous evaluator's, a served model's) skips it and goes
  on working;
* **watchdog hang timeout** — a daemon thread dumps when the loop has
  not called `touch()` within `hang_timeout_secs` (a stalled device call
  blocks forever; the bundle is written while the hang is LIVE, from
  host state only);
* **fatal sentinel incident** — `record_incident` auto-dumps once per
  fatal kind (NaN loss/params).

Everything in a bundle is host-side state that already existed;
`graftscope postmortem <dir>` renders it. Framework-free: this module
never imports torch.
"""

from __future__ import annotations

import collections
import json
import math
import os
import re
import signal
import sys
import threading
import time
import traceback
from typing import Any, Deque, Dict, List, Mapping, Optional

from tensor2robot_tpu_torch.obs import metrics as metrics_lib
from tensor2robot_tpu_torch.obs import trace as trace_lib

__all__ = ["FlightRecorder", "POSTMORTEM_SCHEMA", "BUNDLE_FILENAME",
           "FLIGHTREC_DIRNAME", "find_bundles"]

POSTMORTEM_SCHEMA = "graftscope-postmortem-v1"
POSTMORTEM_SCHEMA_VERSION = 1
BUNDLE_FILENAME = "postmortem.json"
BUNDLE_PREFIX = "postmortem-"
FLIGHTREC_DIRNAME = "flightrec"
TRACE_FILENAME = "trace.graftscope.json"


def _json_safe(value):
  """Strict-JSON scalar: non-finite floats become repr strings (a NaN
  loss is exactly the datum a postmortem exists to keep)."""
  try:
    value = float(value)
  except (TypeError, ValueError):
    return str(value)
  if math.isfinite(value):
    return value
  return repr(value)


def find_bundles(path: str) -> List[str]:
  """Bundle JSON paths under `path`, oldest first.

  Accepts a bundle dir, a flightrec dir, a model_dir (searched
  recursively for `postmortem-*/postmortem.json`), or a bundle JSON
  file directly.
  """
  if os.path.isfile(path):
    return [path]
  direct = os.path.join(path, BUNDLE_FILENAME)
  if os.path.isfile(direct):
    return [direct]
  found = []
  for dirpath, dirnames, filenames in os.walk(path):
    dirnames[:] = sorted(d for d in dirnames
                         if d not in ("checkpoints", "__pycache__", ".git"))
    if (BUNDLE_FILENAME in filenames
        and os.path.basename(dirpath).startswith(BUNDLE_PREFIX)):
      found.append(os.path.join(dirpath, BUNDLE_FILENAME))
  return sorted(found)


class FlightRecorder:
  """Host-side ring buffers + postmortem dumping for one run."""

  def __init__(self,
               out_dir: str,
               capacity: int = 256,
               hang_timeout_secs: Optional[float] = None,
               registry: Optional[metrics_lib.Registry] = None,
               tracer: Optional[trace_lib.Tracer] = None,
               clock=time.time):
    self._out_dir = out_dir
    self._capacity = int(capacity)
    self._hang_timeout = (float(hang_timeout_secs)
                          if hang_timeout_secs else None)
    self._registry = registry  # None = resolve the global at dump time
    self._tracer = tracer
    self._clock = clock
    # Re-entrant ON PURPOSE: the SIGTERM handler runs on the main
    # thread and may interrupt record_step/record_incident between
    # bytecodes WHILE this thread holds the lock — a plain Lock would
    # deadlock the handler's dump() and leave the process unkillable
    # by SIGTERM (strictly worse than no handler).
    self._lock = threading.RLock()
    self._steps: Deque[Dict[str, Any]] = collections.deque(
        maxlen=self._capacity)
    self._incidents: Deque[Dict[str, Any]] = collections.deque(
        maxlen=self._capacity)
    self._dumps: List[str] = []
    self._dump_seq = 0
    self._fatal_dumped: set = set()
    self._last_touch = time.monotonic()
    self._hang_dumped = False
    self._watchdog: Optional[threading.Thread] = None
    self._watchdog_stop = threading.Event()
    self._prev_sigterm = None
    self._signal_installed = False

  # -- recording (cheap, host-only) -----------------------------------------

  def record_step(self, step: int, record: Mapping[str, Any]) -> None:
    """Appends one step/window record (the recorder-observer
    signature); values are sanitized to strict-JSON scalars."""
    entry = {"step": int(step)}
    for key, value in record.items():
      entry[str(key)] = _json_safe(value)
    with self._lock:
      self._steps.append(entry)

  def record_incident(self, incident: Mapping[str, Any]) -> None:
    """Appends a sentinel incident; auto-dumps once per FATAL kind."""
    incident = dict(incident)
    with self._lock:
      self._incidents.append(incident)
    if incident.get("severity") == "fatal":
      kind = str(incident.get("kind", "?"))
      if kind not in self._fatal_dumped:
        self._fatal_dumped.add(kind)
        self.dump(f"incident:{kind}")

  def touch(self) -> None:
    """Watchdog heartbeat — call once per loop iteration."""
    self._last_touch = time.monotonic()
    self._hang_dumped = False

  # -- lifecycle ------------------------------------------------------------

  def install(self) -> None:
    """Arms the SIGTERM handler (main thread only; silently skipped
    elsewhere) and the hang watchdog (when a timeout is configured)."""
    if self._hang_timeout and self._watchdog is None:
      self._last_touch = time.monotonic()
      self._watchdog_stop.clear()
      self._watchdog = threading.Thread(
          target=self._watchdog_main, daemon=True,
          name="flightrec-watchdog")
      self._watchdog.start()
    try:
      self._prev_sigterm = signal.signal(signal.SIGTERM,
                                         self._handle_sigterm)
      self._signal_installed = True
    except ValueError:
      self._signal_installed = False  # not the main thread

  def close(self) -> None:
    """Disarms watchdog + signal handler (restores the previous one)."""
    if self._watchdog is not None:
      self._watchdog_stop.set()
      self._watchdog.join(timeout=5.0)
      self._watchdog = None
    if self._signal_installed:
      try:
        # _prev_sigterm is None when the pre-existing handler was
        # installed outside Python (signal.signal reports None for it);
        # passing None back raises TypeError, so restore the default.
        signal.signal(signal.SIGTERM,
                      self._prev_sigterm if self._prev_sigterm is not None
                      else signal.SIG_DFL)
      except (TypeError, ValueError):
        pass
      self._signal_installed = False

  def __enter__(self) -> "FlightRecorder":
    self.install()
    return self

  def __exit__(self, exc_type, exc, tb) -> None:
    self.close()

  def _watchdog_main(self) -> None:
    poll = min(max(self._hang_timeout / 10.0, 0.05), 5.0)
    while not self._watchdog_stop.wait(poll):
      stalled = time.monotonic() - self._last_touch
      if stalled > self._hang_timeout and not self._hang_dumped:
        # Dump while the hang is LIVE (host state only — the stalled
        # device call keeps hanging undisturbed); latched until the
        # loop touches again so one hang is one bundle.
        self._hang_dumped = True
        self.dump("hang")

  def _handle_sigterm(self, signum, frame) -> None:
    # Host memory + file IO only: no framework import, no device call,
    # no fetch.
    try:
      self.dump("sigterm")
    finally:
      prev = self._prev_sigterm
      if prev is signal.SIG_IGN:
        return
      if callable(prev):
        prev(signum, frame)
        return
      # Default disposition: restore it and re-deliver so the process
      # still dies with the SIGTERM status the sender expects.
      signal.signal(signum, signal.SIG_DFL)
      os.kill(os.getpid(), signum)

  # -- dumping --------------------------------------------------------------

  def dump(self, reason: str, exc: Optional[BaseException] = None) -> str:
    """Writes one postmortem bundle dir; returns its path.

    Never raises (a failing dump must not mask the original crash) —
    on failure it prints to stderr and returns "".
    """
    try:
      return self._dump(reason, exc)
    except Exception as e:  # noqa: BLE001 - see docstring
      print(f"flightrec: postmortem dump failed "
            f"({type(e).__name__}: {e})", file=sys.stderr)
      return ""

  def _dump(self, reason: str, exc: Optional[BaseException]) -> str:
    with self._lock:
      steps = list(self._steps)
      incidents = list(self._incidents)
      self._dump_seq += 1
      seq = self._dump_seq
    registry = self._registry or metrics_lib.get_registry()
    try:
      snapshot = {k: _json_safe(v) for k, v in registry.snapshot().items()}
    except Exception:  # noqa: BLE001 - telemetry-of-telemetry
      snapshot = {}
    heartbeat = None
    try:
      # utils.backend is torch-free at module level; tunnel_health()
      # reads the host-side monitor only — safe from handlers and
      # watchdogs.
      from tensor2robot_tpu_torch.utils import backend

      heartbeat = backend.tunnel_health()
    except Exception:  # noqa: BLE001 - heartbeat is optional context
      pass
    exception = None
    if exc is not None:
      exception = {
          "type": type(exc).__name__,
          "message": str(exc),
          "traceback": "".join(traceback.format_exception(
              type(exc), exc, exc.__traceback__))[-20_000:],
      }
    bundle = {
        "schema": POSTMORTEM_SCHEMA,
        "schema_version": POSTMORTEM_SCHEMA_VERSION,
        "reason": reason,
        "unix_time": self._clock(),
        "pid": os.getpid(),
        "steps": steps,
        "incidents": incidents,
        "heartbeat": heartbeat,
        "metrics": snapshot,
        "watchdog": {
            "hang_timeout_secs": self._hang_timeout,
            "stalled_secs": time.monotonic() - self._last_touch,
        },
        "exception": exception,
    }
    stamp = time.strftime("%Y%m%dT%H%M%S")
    slug = re.sub(r"[^a-zA-Z0-9_.-]+", "_", reason)[:48]
    bundle_dir = os.path.join(self._out_dir,
                              f"{BUNDLE_PREFIX}{stamp}-{seq:02d}-{slug}")
    os.makedirs(bundle_dir, exist_ok=True)
    path = os.path.join(bundle_dir, BUNDLE_FILENAME)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
      json.dump(bundle, f, allow_nan=False, sort_keys=True)
      f.flush()
      os.fsync(f.fileno())  # SIGTERM path: the bundle must hit disk NOW
    os.replace(tmp, path)
    tracer = self._tracer or trace_lib.get_tracer()
    try:
      if tracer.events():
        tracer.save(os.path.join(bundle_dir, TRACE_FILENAME))
    except Exception:  # noqa: BLE001 - the JSON bundle is the contract
      pass
    with self._lock:
      self._dumps.append(bundle_dir)
    try:
      registry.counter("flightrec/dumps").inc()
    except Exception:  # noqa: BLE001
      pass
    print(f"flightrec: postmortem bundle ({reason}) -> {bundle_dir}",
          file=sys.stderr)
    return bundle_dir

  def dumps(self) -> List[str]:
    """Bundle dirs written by this recorder, oldest first."""
    with self._lock:
      return list(self._dumps)
