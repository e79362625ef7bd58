"""graftloop actor: the supervised per-actor episode loop.

Counterpart of `tensor2robot_tpu.loop.actor`. One actor is one env and
one policy served by the fleet, run as a supervisor worker. Each
iteration collects episodes through `envs.run_env` (the same episode
telemetry, replay writing and session teardown as every other collect
path) and streams the transitions into the `ReplayRecordSink`.

**Policy-staleness bound.** Before each burst the actor reads the
fleet's serving version (`serving_version_fn`: min over healthy
replicas) and asks the publisher how many published versions behind
that is. An actor more than `max_staleness_versions` behind is drained
and re-pinned: it aborts its open session (`policy.abort_episode`),
asks the publisher to re-roll the current version
(`request_publish`), and skips collecting until the fleet catches up.
Counted `loop/stale_repins` (one per fresh -> stale transition) and
`loop/stale_skips` (every skipped iteration).

**Fault points.** `loop.actor_crash` (key = actor index) raises out of
the worker: the supervisor's restart path; `loop.actor_hang`
(spec.arg = seconds) stalls without a heartbeat: the hang detector.

Telemetry: `loop/episodes` counter, `loop/staleness` gauge,
`loop/stale_repins`, `loop/stale_skips`, `loop/actor_backoffs` (a
serving-side shed or refusal taken as backpressure, not a crash)
counters.
"""

from __future__ import annotations

import logging
import time
from typing import Any, Callable, Dict, Optional

from tensor2robot_tpu_torch.obs import faultlab as faultlab_lib
from tensor2robot_tpu_torch.obs import graftrace
from tensor2robot_tpu_torch.obs import metrics as obs_metrics
from tensor2robot_tpu_torch.obs import trace as obs_trace

__all__ = ["EpisodeActor"]

_log = logging.getLogger(__name__)


class EpisodeActor:
  """One supervised collection worker (module docstring).

  `env_factory(index)` / `policy_factory(index)` build the per-actor
  env and policy INSIDE the worker thread (a restart gets fresh ones —
  a crashed actor must not resurrect poisoned state).
  `serving_version_fn()` returns the fleet's current serving step;
  `staleness_fn(step)` maps it to published-ordinals-behind (the
  publisher's `staleness_of`); `note_version(step, staleness)` is the
  loop's audit/first-action-latency callback."""

  def __init__(self,
               index: int,
               env_factory: Callable[[int], Any],
               policy_factory: Callable[[int], Any],
               sink,
               episode_to_transitions_fn: Optional[Callable] = None,
               serving_version_fn: Optional[Callable[[], Optional[int]]]
               = None,
               staleness_fn: Optional[Callable[[Optional[int]], int]] = None,
               note_version: Optional[Callable[[Optional[int], int], None]]
               = None,
               request_repair: Optional[Callable[[], None]] = None,
               max_staleness_versions: int = 1,
               episodes_per_iteration: int = 1,
               max_episode_steps: Optional[int] = None,
               explore_schedule: Optional[Callable[[int], float]] = None,
               stale_backoff_s: float = 0.05,
               pause_s: float = 0.0,
               tag: str = "collect"):
    self._index = index
    self._env_factory = env_factory
    self._policy_factory = policy_factory
    self._sink = sink
    self._episode_to_transitions_fn = episode_to_transitions_fn
    self._serving_version_fn = serving_version_fn
    self._staleness_fn = staleness_fn
    self._note_version = note_version
    self._request_repair = request_repair
    self._max_staleness = max(int(max_staleness_versions), 0)
    self._episodes_per_iteration = max(int(episodes_per_iteration), 1)
    self._max_episode_steps = max_episode_steps
    self._explore_schedule = explore_schedule
    self._stale_backoff_s = stale_backoff_s
    self._pause_s = float(pause_s)
    self._tag = tag
    self.episodes = 0
    self.last_stats: Dict[str, float] = {}

  # -- the supervisor target ------------------------------------------------

  def run(self, worker) -> None:
    """`Supervisor.spawn(name, actor.run)` body: collect until told to
    stop. Raises propagate to the supervisor's restart machinery."""
    from tensor2robot_tpu_torch.envs import run_env as run_env_lib
    from tensor2robot_tpu_torch.serving import batcher as batcher_lib
    from tensor2robot_tpu_torch.serving import session as session_lib

    env = self._env_factory(self._index)
    policy = self._policy_factory(self._index)
    stale = False
    try:
      while not worker.should_stop.is_set():
        worker.beat()
        self._maybe_inject_faults()
        step = (self._serving_version_fn()
                if self._serving_version_fn is not None else None)
        staleness = (self._staleness_fn(step)
                     if self._staleness_fn is not None else 0)
        obs_metrics.gauge("loop/staleness").set(float(staleness))
        if staleness > self._max_staleness:
          # Drain + re-pin, never act: the staleness BOUND. The abort
          # releases any session slot pinned to the stale replica; the
          # repair request asks the publisher to re-roll the current
          # version (idempotent), which equalizes lagging replicas.
          # Drain/repair fire once per fresh->stale TRANSITION (there
          # is one session to release and the repair coalesces);
          # `loop/stale_skips` still counts every skipped iteration.
          if not stale:
            stale = True
            self._drain_and_repin(policy)
          obs_metrics.counter("loop/stale_skips").inc()
          if worker.should_stop.wait(timeout=self._stale_backoff_s):
            return
          continue
        stale = False
        if self._note_version is not None:
          self._note_version(step, staleness)
        try:
          # One trace context per collection burst: the replay sink
          # reads it off the thread (graftrace.current()) when the
          # episode's transitions land, which is how a collect span
          # becomes walkable into its replay shard -> learner round ->
          # publish -> first served action (the graftrace loop chain).
          episode_ctx = graftrace.mint()
          with graftrace.activate(episode_ctx), \
              obs_trace.span("loop/episode", cat="loop",
                             actor=self._index,
                             serving_step=int(step or 0)):
            self.last_stats = run_env_lib.run_env(
                env=env, policy=policy,
                num_episodes=self._episodes_per_iteration,
                explore_schedule=self._explore_schedule,
                global_step=int(step or 0), tag=self._tag,
                episode_to_transitions_fn=self._episode_to_transitions_fn,
                replay_writer=(self._sink if self._episode_to_transitions_fn
                               is not None else None),
                max_episode_steps=self._max_episode_steps,
                log_stats=False)
        except (batcher_lib.ShedError, session_lib.SessionError):
          # Transient serving-side refusal — queue-bound shed, every
          # replica mid-swap during a rollout, a session slot-capacity
          # refusal, or an episode-lifecycle outcome (evicted /
          # horizon): BACKPRESSURE or a restartable episode, not an
          # actor fault. run_env already aborted the episode (freeing
          # any session state); back off and retry with a fresh
          # episode instead of burning a supervisor restart.
          obs_metrics.counter("loop/actor_backoffs").inc()
          if worker.should_stop.wait(timeout=self._stale_backoff_s):
            return
          continue
        self.episodes += self._episodes_per_iteration
        obs_metrics.counter("loop/episodes").inc(
            self._episodes_per_iteration)
        # Collection pacing: on a host with few cores an unthrottled
        # actor pool starves the learner of the interpreter (warm actors
        # hold the GIL). The pause caps the pool's duty cycle; 0
        # disables it on hosts with cores to spare.
        if self._pause_s and worker.should_stop.wait(
            timeout=self._pause_s):
          return
    finally:
      # Release the actor's serving-side state (an open session slot is
      # denial-of-service under shed admission) WITHOUT closing the
      # policy's predictor — the fleet is shared loop infrastructure.
      # Guarded: a failing teardown must not REPLACE the worker's real
      # error in the supervisor's incident attribution (the same
      # discipline run_env's own abort path follows).
      abort = getattr(policy, "abort_episode", None)
      if abort is not None:
        try:
          abort()
        except Exception:  # noqa: BLE001 - teardown must not mask the error
          _log.exception("graftloop actor %d: teardown abort failed",
                            self._index)

  # -- internals ------------------------------------------------------------

  def _maybe_inject_faults(self) -> None:
    spec = faultlab_lib.maybe_fire(faultlab_lib.LOOP_ACTOR_HANG,
                                   key=self._index)
    if spec is not None:
      # Stall WITHOUT heartbeating: the supervisor's hang detector is
      # the component under test.
      time.sleep(float(spec.arg or 1.0))
    if faultlab_lib.maybe_fire(faultlab_lib.LOOP_ACTOR_CRASH,
                               key=self._index) is not None:
      raise faultlab_lib.InjectedActorCrash(
          f"faultlab: injected crash of loop actor {self._index}")

  def _drain_and_repin(self, policy) -> None:
    """One fresh->stale transition: release the session, nudge a
    repair. `loop/stale_repins` counts DRAIN EVENTS, not wait
    iterations (the bound's dashboards read it as episodes-of-
    staleness)."""
    obs_metrics.counter("loop/stale_repins").inc()
    abort = getattr(policy, "abort_episode", None)
    if abort is not None:
      try:
        abort()
      except Exception:  # noqa: BLE001 - draining must not kill the worker
        _log.exception("graftloop actor %d: drain abort failed",
                          self._index)
    if self._request_repair is not None:
      try:
        self._request_repair()
      except Exception:  # noqa: BLE001 - a repair nudge must not kill us
        pass
