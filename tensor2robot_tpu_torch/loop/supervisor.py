"""graftloop supervisor: worker registration, heartbeats, restarts.

Counterpart of `tensor2robot_tpu.loop.supervisor`. An actor that dies
mid-episode or hangs on a stuck dispatch must come back without an
operator, and a worker that keeps dying must escalate instead of
restarting forever.

`Supervisor.spawn(name, target)` is the one registration seam for the
loop's worker threads. Each worker runs `target(worker)`, where `worker`
is a generation-bound `WorkerView`:

* `worker.beat()`        — heartbeat (once per iteration; only the live
                           generation's beats land);
* `worker.should_stop`   — this generation's stop event (pinned, so an
                           abandoned hung thread that recovers after its
                           replacement started sees its own set event and
                           exits);
* `worker.generation`    — which restart of the logical worker this is.

The monitor thread watches every registered worker:

* CRASH (target raised): restart under the `utils.retry.RetryPolicy`
  schedule (jittered growing backoff), counted `loop/worker_restarts`,
  incident `loop_worker_restart` (warn). A clean return is COMPLETION
  (state STOPPED, no restart);
* HANG (`heartbeat_timeout_s` without a beat): the thread cannot be
  killed from Python; its stop event is set, it is abandoned, and a
  fresh generation starts in its place, counted `loop/worker_hangs`;
* ESCALATION: restarts within one instability window are budgeted by
  the policy's `max_attempts`; past it the worker is FAILED, emits
  `loop_worker_lost` (fatal) and is not restarted. A worker that stays
  up `healthy_reset_s` earns its budget back.

Telemetry: `loop/worker_restarts`, `loop/worker_hangs`,
`loop/worker_escalations` counters; `loop/workers_alive` gauge;
`loop/worker_downtime_ms` histogram (death detected to restart).

Imports no torch (threading and `obs` only).
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List, Mapping, Optional

from tensor2robot_tpu_torch.obs import graftrace
from tensor2robot_tpu_torch.obs import metrics as obs_metrics
from tensor2robot_tpu_torch.obs import runlog as runlog_lib
from tensor2robot_tpu_torch.obs import sentinel as sentinel_lib
from tensor2robot_tpu_torch.utils import retry as retry_lib

__all__ = ["Supervisor", "WorkerHandle", "WorkerView", "RUNNING",
           "RESTARTING", "FAILED", "STOPPED"]

# Worker states. RUNNING has a live thread; RESTARTING is between a
# detected death and the scheduled restart; FAILED exhausted its budget
# (terminal until operator action); STOPPED was shut down by close().
RUNNING = "running"
RESTARTING = "restarting"
FAILED = "failed"
STOPPED = "stopped"


class WorkerHandle:
  """One supervised worker: the target, its live thread, and the
  restart accounting. The object handed to `target` as its only
  argument — targets use `beat()` / `should_stop` / `generation`."""

  def __init__(self, name: str, target: Callable[["WorkerHandle"], Any]):
    self.name = name
    self.target = target
    self.thread: Optional[threading.Thread] = None
    self.should_stop = threading.Event()
    self.state = RESTARTING  # becomes RUNNING at first _start
    self.generation = 0
    self.attempts = 0  # restarts inside the current instability window
    self.started_s = 0.0
    self.last_beat_s = 0.0
    self.next_restart_s = 0.0  # monotonic time the next restart is due
    self.down_since_s: Optional[float] = None
    self.last_error: Optional[BaseException] = None
    self.completed = False  # target returned normally (not a crash)

  def beat(self) -> None:
    """Heartbeat — call once per work-loop iteration."""
    self.last_beat_s = time.monotonic()

  @property
  def alive(self) -> bool:
    return self.thread is not None and self.thread.is_alive()


class WorkerView:
  """The generation-bound surface a `target` actually receives.

  Why not the handle itself: the handle's `should_stop` is REPLACED on
  every restart, so an ABANDONED hung thread that later recovers would
  re-read the new generation's (unset) event and keep running forever —
  a zombie collecting alongside its replacement. The view pins the
  generation's own stop event, and its `beat()` only lands while this
  generation is still the live one (a recovered zombie must not mask
  its replacement's hang)."""

  def __init__(self, handle: WorkerHandle, generation: int,
               should_stop: threading.Event):
    self._handle = handle
    self.generation = generation
    self.should_stop = should_stop

  def beat(self) -> None:
    if self._handle.generation == self.generation:
      self._handle.last_beat_s = time.monotonic()

  @property
  def completed(self) -> bool:
    return self._handle.completed


class Supervisor:
  """Worker registration + restart/escalation machinery (module doc)."""

  def __init__(self,
               name: str = "loop",
               restart_policy: Optional[retry_lib.RetryPolicy] = None,
               heartbeat_timeout_s: Optional[float] = None,
               healthy_reset_s: float = 30.0,
               poll_interval_s: float = 0.05,
               sinks: Optional[List[Callable[[Mapping[str, Any]],
                                             Any]]] = None):
    self._name = name
    self._policy = restart_policy or retry_lib.RetryPolicy(
        name="loop_worker_restart", max_attempts=5, base_delay_s=0.05,
        multiplier=2.0, max_delay_s=2.0, jitter=0.5)
    self._heartbeat_timeout_s = heartbeat_timeout_s
    self._healthy_reset_s = healthy_reset_s
    self._poll_interval_s = poll_interval_s
    self._sinks = list(sinks or [])
    self._lock = threading.Lock()
    self._workers: Dict[str, WorkerHandle] = {}
    self._abandoned: List[threading.Thread] = []
    self._closed = False
    self._monitor: Optional[threading.Thread] = None
    self._wake = threading.Event()

  # -- introspection --------------------------------------------------------

  def worker(self, name: str) -> WorkerHandle:
    return self._workers[name]

  def states(self) -> Dict[str, str]:
    with self._lock:
      return {name: w.state for name, w in self._workers.items()}

  def all_running(self) -> bool:
    with self._lock:
      return bool(self._workers) and all(
          w.state == RUNNING and w.alive for w in self._workers.values())

  def _emit_incident(self, kind: str, worker: str, reason: str,
                     severity: str) -> None:
    record = runlog_lib.make_incident(
        kind, step=0, severity=severity, value=0.0,
        detail={"worker": worker, "reason": reason,
                "supervisor": self._name})
    for sink in self._sinks:
      try:
        sink(record)
      except Exception:  # noqa: BLE001 - a sink must not break supervision
        pass

  def _alive_gauge_locked(self) -> None:
    alive = sum(1 for w in self._workers.values()
                if w.state == RUNNING and w.alive)
    obs_metrics.gauge("loop/workers_alive").set(float(alive))

  # -- registration (THE seam) ----------------------------------------------

  def spawn(self, name: str,
            target: Callable[["WorkerView"], Any]) -> WorkerHandle:
    """Registers AND starts a supervised worker thread. `target(worker)`
    runs on the thread with a generation-bound `WorkerView` (beat /
    should_stop / generation — NOT the handle: see WorkerView for the
    zombie hazard). Raising counts as a crash and enters the restart
    schedule; a clean return is COMPLETION (STOPPED, no restart — see
    the module docstring). Returns the `WorkerHandle` for
    introspection (state / completed / alive)."""
    with self._lock:
      if self._closed:
        raise RuntimeError(f"supervisor {self._name!r} is closed")
      if name in self._workers:
        raise ValueError(f"worker {name!r} already registered")
      handle = WorkerHandle(name, target)
      self._workers[name] = handle
      self._start_locked(handle)
      if self._monitor is None:
        self._monitor = threading.Thread(
            target=self._monitor_main, daemon=True,
            name=f"{self._name}-supervisor")
        self._monitor.start()
    return handle

  def _start_locked(self, handle: WorkerHandle) -> None:
    handle.generation += 1
    handle.should_stop = threading.Event()
    handle.state = RUNNING
    handle.completed = False
    handle.last_error = None
    now = time.monotonic()
    handle.started_s = now
    handle.last_beat_s = now
    if handle.down_since_s is not None:
      obs_metrics.histogram("loop/worker_downtime_ms").record(
          (now - handle.down_since_s) * 1e3)
      handle.down_since_s = None

    view = WorkerView(handle, handle.generation, handle.should_stop)

    def _run(h=handle, gen=handle.generation, v=view):
      try:
        h.target(v)
        if gen == h.generation:
          # Clean return = the worker FINISHED (a learner hitting its
          # step target, an actor told to stop) — not a crash.
          h.completed = True
      except BaseException as e:  # noqa: BLE001 - the monitor classifies
        if gen == h.generation:
          h.last_error = e

    handle.thread = threading.Thread(
        target=_run, daemon=True,
        name=f"{self._name}-{handle.name}-g{handle.generation}")
    handle.thread.start()
    self._alive_gauge_locked()

  # -- the monitor ----------------------------------------------------------

  def _monitor_main(self) -> None:
    while True:
      self._wake.wait(timeout=self._poll_interval_s)
      self._wake.clear()
      incidents: List[tuple] = []
      with self._lock:
        if self._closed:
          return
        now = time.monotonic()
        for handle in self._workers.values():
          if handle.state == RUNNING:
            if handle.alive:
              # Budget amnesty: a sustained healthy run clears the
              # instability window, so rare unrelated faults over a
              # multi-day loop never accrue into escalation.
              if (handle.attempts
                  and now - handle.started_s > self._healthy_reset_s):
                handle.attempts = 0
              if (self._heartbeat_timeout_s is not None
                  and now - handle.last_beat_s
                  > self._heartbeat_timeout_s):
                incidents.append(
                    self._declare_down_locked(handle, now, hang=True))
            elif handle.completed:
              handle.state = STOPPED
              self._alive_gauge_locked()
            else:
              incidents.append(
                  self._declare_down_locked(handle, now, hang=False))
          if (handle.state == RESTARTING
              and now >= handle.next_restart_s):
            self._start_locked(handle)
            obs_metrics.counter("loop/worker_restarts").inc()
      # Sinks run OUTSIDE the lock: a sink that routes back into the
      # supervisor — or blocks — must not deadlock the monitor.
      for kind, worker, reason, severity in incidents:
        self._emit_incident(kind, worker, reason, severity)

  def _declare_down_locked(self, handle: WorkerHandle, now: float,
                           hang: bool) -> tuple:
    """Classifies a detected death and schedules the restart (or
    escalates past the budget). Called under the lock; returns the
    incident tuple the monitor emits after releasing it."""
    if hang:
      # The thread cannot be killed: signal it, abandon it, and let a
      # fresh generation take the name. close() still joins it with a
      # timeout so a recovered straggler is collected.
      handle.should_stop.set()
      # Prune recovered stragglers first: over a multi-week loop the
      # abandoned list must not accrue one dead Thread per hang.
      self._abandoned = [t for t in self._abandoned if t.is_alive()]
      if handle.thread is not None:
        self._abandoned.append(handle.thread)
      handle.thread = None
      obs_metrics.counter("loop/worker_hangs").inc()
      # Abandonment is a teardown path: export what the hung worker's
      # window recorded before its events age out of the ring (no-op
      # unless the exporter is armed; flush never raises).
      graftrace.flush()
      reason = (f"heartbeat stalled > {self._heartbeat_timeout_s}s "
                f"(generation {handle.generation} abandoned)")
    else:
      error = handle.last_error
      reason = (f"{type(error).__name__}: {error}" if error is not None
                else "worker thread exited")
    handle.down_since_s = now
    handle.attempts += 1
    if handle.attempts >= self._policy.max_attempts:
      handle.state = FAILED
      obs_metrics.counter("loop/worker_escalations").inc()
      self._alive_gauge_locked()
      return (sentinel_lib.LOOP_WORKER_LOST, handle.name,
              f"restart budget exhausted after: {reason}", "fatal")
    handle.state = RESTARTING
    handle.next_restart_s = now + self._policy.backoff_s(
        handle.attempts - 1)
    self._alive_gauge_locked()
    return (sentinel_lib.LOOP_WORKER_RESTART, handle.name, reason, "warn")

  # -- lifecycle ------------------------------------------------------------

  def stop_worker(self, name: str) -> None:
    """Signals one worker to stop (no restart; state -> STOPPED)."""
    with self._lock:
      handle = self._workers[name]
      handle.state = STOPPED
      handle.should_stop.set()
      self._alive_gauge_locked()

  def revive_worker(self, name: str) -> None:
    """Operator action: clears a FAILED worker's budget and restarts it
    (the `mark_healthy` of the supervision layer)."""
    with self._lock:
      handle = self._workers[name]
      if handle.state not in (FAILED, STOPPED):
        raise ValueError(f"worker {name!r} is {handle.state}, not "
                         "failed/stopped")
      handle.attempts = 0
      handle.last_error = None
      self._start_locked(handle)

  def close(self, timeout_s: float = 10.0) -> None:
    """Stops the monitor, signals every worker and joins them (bounded).
    Idempotent; never raises for a straggler — abandoning a stuck
    worker thread at teardown is the documented hang disposition."""
    with self._lock:
      if self._closed:
        return
      self._closed = True
      monitor = self._monitor
      self._monitor = None
      handles = list(self._workers.values())
      for handle in handles:
        if handle.state in (RUNNING, RESTARTING):
          handle.state = STOPPED
        handle.should_stop.set()
      abandoned = list(self._abandoned)
      self._alive_gauge_locked()
    self._wake.set()
    if monitor is not None:
      monitor.join(timeout=5.0)
    deadline = time.monotonic() + timeout_s
    for handle in handles:
      thread = handle.thread
      if thread is not None and thread.is_alive():
        thread.join(timeout=max(deadline - time.monotonic(), 0.1))
    for thread in abandoned:
      if thread.is_alive():
        thread.join(timeout=max(deadline - time.monotonic(), 0.1))
    graftrace.flush()

  def __enter__(self) -> "Supervisor":
    return self

  def __exit__(self, exc_type, exc_value, traceback) -> bool:
    self.close()
    return False
