"""graftloop publisher: verified checkpoint -> fleet rollout, fenced.

Counterpart of `tensor2robot_tpu.loop.publish`. A checkpoint reaches the
actors only through:

  1. **manifest verification**: the step must pass its checksummed
     manifest (`checkpoints.verify_step_files`). A torn or bit-flipped
     step is refused (counted `loop/publish_rejected`, incident
     `loop_publish_rejected`); the fleet keeps serving the last verified
     version.
  2. **`ServingFleet.rollout()`**: the canary-first zero-downtime swap
     under live actor traffic; a canary that fails verification aborts
     with the rest of the fleet on the old checkpoint.

**The publish/rollout fence.** `publish()` serializes under one lock: a
checkpoint published while a rollout is in flight waits, so two
rollouts never interleave and leave the fleet at mixed versions. Publish
requests coalesce latest-wins (`request_publish` + `drain_pending`).

**Rewinds** (`note_rewind`): a learner divergence rewind drops pending
publish requests above the rewind target. Published versions stay
published: actors keep serving the last verified checkpoint.

Telemetry: `loop/publishes`, `loop/publish_rejected`,
`loop/publish_aborted` counters; `loop/publish_to_serve_ms` histogram
(checkpoint available to rollout complete); `loop/published_version`
gauge.

Imports no torch (the fleet and checkpoints bring their own).
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List, Mapping, Optional

from tensor2robot_tpu_torch.obs import graftrace
from tensor2robot_tpu_torch.obs import metrics as obs_metrics
from tensor2robot_tpu_torch.obs import runlog as runlog_lib
from tensor2robot_tpu_torch.obs import sentinel as sentinel_lib
from tensor2robot_tpu_torch.obs import trace as obs_trace

__all__ = ["CheckpointPublisher"]


class CheckpointPublisher:
  """Verified checkpoint publication into a serving fleet (module doc).

  `fleet` needs the `rollout()` / `global_step` surface
  (`serving.ServingFleet` or a duck-type); `checkpoint_dir` is the
  learner's `<model_dir>/checkpoints` directory the manifests live
  under."""

  def __init__(self,
               fleet,
               checkpoint_dir: str,
               probe_request: Optional[Mapping[str, Any]] = None,
               verify: Optional[Callable[[Mapping[str, Any]], bool]] = None,
               drain_timeout_s: float = 30.0,
               manifest_timeout_s: float = 20.0,
               sinks: Optional[List[Callable[[Mapping[str, Any]],
                                             Any]]] = None,
               name: str = "loop/publish"):
    self._fleet = fleet
    self._checkpoint_dir = checkpoint_dir
    self._probe_request = probe_request
    self._verify = verify
    self._drain_timeout_s = drain_timeout_s
    self._manifest_timeout_s = manifest_timeout_s
    self._sinks = list(sinks or [])
    self._name = name
    # THE fence: every rollout the loop performs goes through this lock.
    self._rollout_lock = threading.Lock()
    self._state_lock = threading.Lock()
    self._pending: Optional[int] = None
    self._pending_event = threading.Event()
    # step -> ordinal (1-based publish count) for CURRENTLY-SERVABLE
    # verified publishes; the staleness bound counts ORDINALS ("K
    # published versions behind"), not raw step deltas. A published
    # step whose bytes later rot is DEMOTED out of this map (publish()
    # rejection path) so `published_version` falls back — but stays in
    # `_ever_published`: the served-version audit must keep crediting
    # actions taken while it WAS verified.
    self._published_ordinal: Dict[int, int] = {}
    self._ordinal_counter = 0
    self._ever_published: set = set()
    self._publish_time_s: Dict[int, float] = {}
    self._history: List[Dict[str, Any]] = []
    # Causality (graftrace): the learner-round context captured at
    # `request_publish(step)` and, per SERVED step, the span_id of its
    # `loop/publish` event — `_note_version` parents the first-action
    # instant on it, closing the episode->...->first_action chain.
    self._request_ctx: Dict[int, Any] = {}
    self._publish_span_ids: Dict[int, str] = {}

  # -- introspection --------------------------------------------------------

  @property
  def published_version(self) -> Optional[int]:
    """The MOST RECENTLY published still-servable step (highest
    ordinal, not max step — after a rewind republishes a lower step, or
    a published step's bytes rot and it is demoted, the repair path
    must re-roll what is actually servable, not a dead newer step).
    None before the first publish."""
    with self._state_lock:
      if not self._published_ordinal:
        return None
      return max(self._published_ordinal,
                 key=self._published_ordinal.get)

  @property
  def published_count(self) -> int:
    """Distinct steps ever successfully published (demotion of a
    later-rotted step does not un-count its publish)."""
    with self._state_lock:
      return len(self._ever_published)

  def was_published(self, step: Optional[int]) -> bool:
    """True iff `step` went through a successful verified publish at
    ANY point — the served-version audit's question (an action taken
    while the step was verified stays legitimate even after the step's
    bytes rot and it is demoted)."""
    if step is None:
      return False
    with self._state_lock:
      return int(step) in self._ever_published

  def ordinal_of(self, step: Optional[int]) -> Optional[int]:
    """Publish ordinal of a served step (None = never published — the
    initial random-init version actors start on reads as ordinal 0)."""
    if step is None:
      return None
    with self._state_lock:
      if step <= 0:
        return 0
      return self._published_ordinal.get(int(step))

  def staleness_of(self, step: Optional[int]) -> int:
    """How many published versions behind a served step is (0 = current
    or nothing published yet). An unknown step — served params that
    never went through a verified publish — reads as the full ordinal
    distance, which trips any staleness bound; the loop's audit treats
    it as a hard failure separately."""
    with self._state_lock:
      latest = max(self._published_ordinal.values(), default=0)
      if latest == 0:
        return 0
      if step is not None and step <= 0:
        ordinal = 0
      else:
        ordinal = self._published_ordinal.get(int(step or -1), 0)
      return latest - ordinal

  def publish_time(self, step: int) -> Optional[float]:
    with self._state_lock:
      return self._publish_time_s.get(int(step))

  def publish_span_id(self, step: Optional[int]) -> Optional[str]:
    """Span id of the `loop/publish` event that made `step` servable
    (None for unpublished steps) — the parent of the first-action
    instant."""
    if step is None:
      return None
    with self._state_lock:
      return self._publish_span_ids.get(int(step))

  def history(self) -> List[Dict[str, Any]]:
    with self._state_lock:
      return [dict(h) for h in self._history]

  def _emit_incident(self, kind: str, step: int, reason: str,
                     severity: str = "warn") -> None:
    record = runlog_lib.make_incident(
        kind, step=int(step), severity=severity, value=float(step),
        detail={"step": int(step), "reason": reason,
                "publisher": self._name})
    for sink in self._sinks:
      try:
        sink(record)
      except Exception:  # noqa: BLE001 - a sink must not break publishing
        pass

  # -- the fenced publish ---------------------------------------------------

  def publish(self, step: int) -> Dict[str, Any]:
    """Verifies `step` and rolls it out (module docstring). Serialized
    under the publish/rollout fence; returns a report dict and never
    raises for verification/rollout failures — the loop keeps serving
    the last verified version either way."""
    from tensor2robot_tpu_torch import checkpoints as checkpoints_lib

    step = int(step)
    report: Dict[str, Any] = {"step": step, "published": False}
    with self._state_lock:
      request_ctx = self._request_ctx.pop(step, None)
    publish_ctx = (request_ctx.child() if request_ctx is not None
                   else graftrace.mint())
    with self._rollout_lock:
      t0 = time.perf_counter()
      t0_ns = time.perf_counter_ns()
      # The learner's saves are ASYNC and the manifest is written only
      # once the step directory is renamed into place, so
      # `after_checkpoint` (and so this publish) races both. Wait bounded
      # for a manifest verdict; a step that never produces one is
      # REFUSED, as a failing one is: only manifest-verified bytes are
      # published.
      deadline = time.monotonic() + self._manifest_timeout_s
      while True:
        verdict = checkpoints_lib.verify_step_files(self._checkpoint_dir,
                                                    step)
        if verdict is not None or time.monotonic() >= deadline:
          break
        time.sleep(0.05)
      report["verified"] = verdict
      if verdict is not True:
        # False: the manifest says the bytes on disk are not the bytes
        # the learner saved. None: the save never committed a manifest
        # inside the window. Either way this checkpoint must NEVER
        # reach an actor.
        obs_metrics.counter("loop/publish_rejected").inc()
        report["reason"] = ("manifest verification failed"
                            if verdict is False else
                            "no manifest within "
                            f"{self._manifest_timeout_s}s")
        with self._state_lock:
          if step in self._published_ordinal:
            # Previously-published bytes now FAIL verification (rotted
            # on disk after their verified publish, quarantine
            # incoming): demote the step so `published_version` — and
            # with it the staleness-repair re-roll — falls back to the
            # newest STILL-verified published step instead of
            # re-requesting this dead one forever. `_ever_published`
            # keeps it: past actions on it stay audit-legitimate.
            del self._published_ordinal[step]
        self._emit_incident(sentinel_lib.LOOP_PUBLISH_REJECTED, step,
                            report["reason"])
        self._record_history(report)
        return report
      rollout = self._fleet.rollout(
          probe_request=self._probe_request, verify=self._verify,
          drain_timeout_s=self._drain_timeout_s)
      report["rollout"] = {k: rollout.get(k) for k in
                           ("swapped", "aborted", "parity_ok",
                            "fresh_warms", "canary_index")}
      if rollout.get("aborted") is not None or not rollout.get("swapped"):
        obs_metrics.counter("loop/publish_aborted").inc()
        report["reason"] = f"rollout aborted: {rollout.get('aborted')}"
        self._emit_incident(sentinel_lib.LOOP_PUBLISH_REJECTED, step,
                            report["reason"])
        self._record_history(report)
        return report
      # What the fleet actually serves now: the verified-restore walk
      # inside each replica's restore() may land BELOW the requested
      # step (e.g. the newest step tore between save and restore) — the
      # published version must be the truth, not the intent.
      served = int(self._fleet.global_step)
      elapsed_ms = (time.perf_counter() - t0) * 1e3
      with self._state_lock:
        if served not in self._published_ordinal:
          self._ordinal_counter += 1
          self._published_ordinal[served] = self._ordinal_counter
          self._ever_published.add(served)
          self._publish_time_s[served] = time.monotonic()
        ordinal = self._published_ordinal[served]
        self._publish_span_ids[served] = publish_ctx.span_id
      obs_trace.add_complete(
          "loop/publish", t0_ns, time.perf_counter_ns() - t0_ns,
          cat="loop", args={**publish_ctx.args(), "step": step,
                            "served": served, "ordinal": ordinal})
      obs_metrics.counter("loop/publishes").inc()
      obs_metrics.histogram("loop/publish_to_serve_ms").record(elapsed_ms)
      obs_metrics.gauge("loop/published_version").set(float(served))
      report.update(published=True, served_step=served,
                    publish_to_serve_ms=elapsed_ms)
      self._record_history(report)
      return report

  def _record_history(self, report: Dict[str, Any]) -> None:
    with self._state_lock:
      self._history.append(dict(report))

  # -- the coalescing request queue (publisher worker) ----------------------

  def request_publish(self, step: int) -> None:
    """Non-blocking: notes that `step` wants publication. Latest wins —
    the learner must never block on a rollout. The caller's active
    trace context (the learner round's, via the `after_checkpoint`
    hook) is captured so the eventual `loop/publish` span parents on
    it."""
    ctx = graftrace.current()
    with self._state_lock:
      if self._pending is None or step > self._pending:
        self._pending = int(step)
      if ctx is not None:
        self._request_ctx[int(step)] = ctx
    self._pending_event.set()

  def note_rewind(self, target_step: int) -> None:
    """Learner divergence rewind (train_eval `after_rewind` hook): drop
    pending publish requests ABOVE the rewind target — those steps are
    quarantined or about to be re-trained, and publishing them would
    race the replay."""
    with self._state_lock:
      if self._pending is not None and self._pending > int(target_step):
        self._pending = None
    obs_metrics.counter("loop/learner_rewinds_seen").inc()

  def drain_pending(self, timeout_s: float = 0.2) -> Optional[Dict[str, Any]]:
    """Publisher-worker body helper: waits up to `timeout_s` for a
    pending request, publishes the newest one, returns its report (None
    when nothing was pending)."""
    if not self._pending_event.wait(timeout=timeout_s):
      return None
    with self._state_lock:
      step = self._pending
      self._pending = None
      self._pending_event.clear()
    if step is None:
      return None
    return self.publish(step)
