"""GraftLoop: the always-on actor/learner loop in one supervised process.

Counterpart of `tensor2robot_tpu.loop.loop`:

  actors ──(episodes)──> ReplayRecordSink ──(TFRecord shards)──┐
    ▲                                                          ▼
  ServingFleet <──rollout()── CheckpointPublisher <── train_eval rounds
                                                     (the learner)

* The ACTOR POOL (`EpisodeActor` x N, supervised) runs env episodes
  through policies served by the shared `ServingFleet` and streams
  transitions into the bounded, byte-capped sink.
* The LEARNER trains in resumable ROUNDS of `train_eval.train_eval_model`
  over the sink's finished shards (`DefaultRecordInputGenerator`),
  checkpointing at each round's end, with train_eval's divergence
  rewind, verified restore and manifests. A learner crash is a
  supervisor restart that resumes from the newest verified checkpoint:
  progress is read from disk, never from thread state.
* The PUBLISHER worker drains coalesced publish requests (the
  `after_checkpoint` hook -> `request_publish`) through the fenced
  verify-then-rollout path; `after_rewind` drops pending publishes above
  the rewind target. A rewind does not stop collection.
* STALENESS: actors act on a version at most `max_staleness_versions`
  published versions behind (drain and re-pin otherwise, `actor.py`).

The learner and the default replicas run on `device` (CUDA unless the
caller passes 'cpu'); with `devices`, the fleet carves them into replica
groups and pins each replica's predictor to its group's first device.

`summary()` returns the loop's accounting: episode goodput, publish
history, publish-to-first-action latency, the served-version audit
(every version actors acted on must be the initial one or a verified
publish), the staleness observed, worker restarts and escalations, the
SLO state and the fleet's utilization.

Imports no torch; `run_graftloop` is the configurable entry point that
`configs/loop_qtopt.gin` binds and `bin/run_graftloop.py` drives.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional

from tensor2robot_tpu_torch.loop import actor as actor_lib
from tensor2robot_tpu_torch.loop import publish as publish_lib
from tensor2robot_tpu_torch.loop import replay as replay_lib
from tensor2robot_tpu_torch.loop import supervisor as supervisor_lib
from tensor2robot_tpu_torch.obs import graftrace
from tensor2robot_tpu_torch.obs import metrics as obs_metrics
from tensor2robot_tpu_torch.obs import runlog as runlog_lib
from tensor2robot_tpu_torch.obs import slo as slo_lib
from tensor2robot_tpu_torch.obs import trace as obs_trace
from tensor2robot_tpu_torch.utils import config
from tensor2robot_tpu_torch.utils import retry as retry_lib

__all__ = ["GraftLoop", "run_graftloop"]

CHECKPOINT_DIRNAME = "checkpoints"

_log = logging.getLogger(__name__)


class GraftLoop:
  """Supervised always-on actor/learner loop (module docstring).

  Callable seams (all invoked INSIDE worker threads):
    model_factory()            -> a fresh T2RModel (learner + replicas
                                  each get their own instance);
    env_factory(actor_index)   -> a fresh env;
    policy_factory(predictor)  -> a policy over the SHARED fleet (the
                                  fleet duck-types the predictor
                                  surface: predict / open / step /
                                  close_session);
    replica_factory(i, devices)-> optional override for the default
                                  CheckpointPredictor+BucketedEngine
                                  replica.
  """

  def __init__(self,
               model_factory: Callable[[], Any],
               model_dir: str,
               env_factory: Callable[[int], Any],
               policy_factory: Callable[[Any], Any],
               episode_to_transitions_fn: Callable,
               replica_factory: Optional[Callable[[int, Any], Any]] = None,
               num_actors: int = 2,
               num_replicas: int = 2,
               devices: Optional[Any] = None,
               max_batch_size: int = 8,
               train_batch_size: int = 16,
               steps_per_round: int = 10,
               num_rounds: int = 3,
               min_start_shards: int = 1,
               max_staleness_versions: int = 1,
               replay_max_bytes: int = 64 << 20,
               episodes_per_shard: int = 8,
               replay_on_full: str = "drop_oldest",
               max_episode_steps: Optional[int] = 8,
               episodes_per_iteration: int = 1,
               explore_schedule: Optional[Callable[[int], float]] = None,
               actor_pause_s: float = 0.0,
               heartbeat_timeout_s: Optional[float] = None,
               restart_policy: Optional[retry_lib.RetryPolicy] = None,
               trainer_kwargs: Optional[Dict[str, Any]] = None,
               input_generator_factory: Optional[Callable[[str], Any]] = None,
               device=None,
               seed: int = 0,
               executable_cache_dir: Optional[str] = None):
    self._model_factory = model_factory
    self._model_dir = os.path.abspath(model_dir)
    os.makedirs(self._model_dir, exist_ok=True)
    # One executable cache for the loop ("auto" = <model_dir>/excache):
    # the default replicas compile their rungs under one 'serve/loop'
    # namespace (the first stores, the rest load) and every learner
    # round compiles its train step against it (the learner's later
    # rounds load). None (the default, unlike the JAX loop's "auto")
    # keeps both eager, as `train_eval_model` does.
    if executable_cache_dir == "auto":
      executable_cache_dir = os.path.join(self._model_dir, "excache")
    self._executable_cache_dir = executable_cache_dir or None
    self._device = device
    # BEFORE any replica is built: CheckpointPredictor resolves its
    # polling directory at construction — if `<model_dir>/checkpoints`
    # does not exist yet it falls back to polling model_dir itself and
    # would never see the learner's checkpoints.
    os.makedirs(os.path.join(self._model_dir, CHECKPOINT_DIRNAME),
                exist_ok=True)
    self._env_factory = env_factory
    self._policy_factory = policy_factory
    self._episode_to_transitions_fn = episode_to_transitions_fn
    self._replica_factory = replica_factory
    self._num_actors = max(int(num_actors), 1)
    self._num_replicas = max(int(num_replicas), 1)
    self._devices = devices
    self._max_batch_size = max_batch_size
    self._train_batch_size = train_batch_size
    self._steps_per_round = max(int(steps_per_round), 1)
    self._num_rounds = max(int(num_rounds), 1)
    self._min_start_shards = max(int(min_start_shards), 1)
    self._max_staleness = max(int(max_staleness_versions), 0)
    self._max_episode_steps = max_episode_steps
    self._episodes_per_iteration = episodes_per_iteration
    self._explore_schedule = explore_schedule
    self._actor_pause_s = float(actor_pause_s)
    self._trainer_kwargs = dict(trainer_kwargs or {})
    self._input_generator_factory = input_generator_factory
    self._seed = int(seed)
    self._incidents_path = os.path.join(self._model_dir,
                                        runlog_lib.INCIDENTS_FILENAME)
    incident_sink = self._incident_sink
    self.sink = replay_lib.ReplayRecordSink(
        os.path.join(self._model_dir, "replay"),
        max_bytes=replay_max_bytes,
        episodes_per_shard=episodes_per_shard,
        on_full=replay_on_full)
    self.supervisor = supervisor_lib.Supervisor(
        name="graftloop",
        restart_policy=restart_policy,
        heartbeat_timeout_s=heartbeat_timeout_s,
        sinks=[incident_sink])
    # Fleet + publisher are built lazily in run() (the fleet factory
    # touches the backend; construction here keeps imports clean).
    self.fleet = None
    self.publisher: Optional[publish_lib.CheckpointPublisher] = None
    self._probe_request = None
    self._actors: List[actor_lib.EpisodeActor] = []
    # Served-version audit (note_version): every (step, staleness) an
    # actor acted under, plus first-action latency per published step.
    self._audit_lock = threading.Lock()
    self._served_steps: Dict[int, int] = {}  # step -> episodes started
    self._max_seen_staleness = 0
    self._first_action_s: Dict[int, float] = {}
    self._wall_start = None
    self._wall_s = 0.0
    # graftwatch: continuous SLO evaluation over the loop's own
    # telemetry (staleness bound, publish-to-serve latency), fanned to
    # the same incident sink as sentinel/supervisor incidents. Built
    # here (backend-free) so summary() can read it even if run() died
    # before the fleet came up.
    self._slo_engine = slo_lib.SloEngine(
        slo_lib.default_loop_slos(
            staleness_bound=float(self._max_staleness)),
        sinks=[incident_sink])

  # -- incident fan-out -----------------------------------------------------

  def _incident_sink(self, record) -> None:
    try:
      runlog_lib.append_record(self._incidents_path, record)
    except Exception:  # noqa: BLE001 - telemetry must not break the loop
      _log.exception("graftloop: incident append failed")

  # -- fleet / versions -----------------------------------------------------

  def _default_replica_factory(self, index: int, devices) -> Any:
    from tensor2robot_tpu_torch.predictors import predictors as predictors_lib
    from tensor2robot_tpu_torch.serving import engine as engine_lib

    predictor = predictors_lib.CheckpointPredictor(
        model=self._model_factory(), model_dir=self._model_dir,
        device=self._device)
    if not predictor.restore():
      # Fresh loop: identical random init on every replica = serving
      # version 0 (the pre-first-publish ordinal the audit treats as
      # the sanctioned initial version).
      predictor.init_randomly()
    if devices:
      predictor.place_on_device(devices[0])
    return engine_lib.BucketedEngine(predictor=predictor,
                                     max_batch_size=self._max_batch_size,
                                     cache=self._executable_cache_dir,
                                     cache_namespace="serve/loop")

  def _build_fleet(self) -> None:
    from tensor2robot_tpu_torch import specs as specs_lib
    from tensor2robot_tpu_torch.serving import fleet as fleet_lib

    factory = self._replica_factory or self._default_replica_factory
    holder: List[Any] = []
    self.fleet = fleet_lib.ServingFleet(
        replica_factory=factory,
        num_replicas=self._num_replicas,
        devices=self._devices,
        max_batch_size=self._max_batch_size,
        warmup=True,
        name="serve/loop",
        sinks=[self._incident_sink],
        probation_probe=lambda: holder[0])
    self._probe_request = dict(specs_lib.make_random_numpy(
        self.fleet.replica(0).get_feature_specification(), batch_size=1,
        seed=0).items())
    holder.append(self._probe_request)
    # The sanctioned pre-first-publish versions: a fresh loop serves the
    # identical random init (step 0); a RESTARTED loop's replicas
    # restored the newest verified checkpoint at build — both are
    # legitimate without a publish, and the audit must not flag them.
    self._initial_versions = {0, int(self.fleet.global_step)}
    self.publisher = publish_lib.CheckpointPublisher(
        self.fleet,
        os.path.join(self._model_dir, CHECKPOINT_DIRNAME),
        probe_request=self._probe_request,
        sinks=[self._incident_sink])

  def serving_version(self) -> Optional[int]:
    """The fleet's current SERVING step: min over healthy replicas (the
    worst version a routed request can land on). None when no replica
    is healthy — actors then skip collecting (nothing can serve)."""
    fleet = self.fleet
    if fleet is None:
      return None
    versions = []
    for index in fleet.healthy_replicas():
      version = getattr(fleet.replica(index), "model_version", None)
      if isinstance(version, (int, float)):
        versions.append(int(version))
    return min(versions) if versions else None

  def _staleness_of(self, step: Optional[int]) -> int:
    if step is None:
      # No healthy replica: infinitely stale — the actor must not act.
      return self._max_staleness + 1
    return self.publisher.staleness_of(step)

  def _note_version(self, step: Optional[int], staleness: int) -> None:
    if step is None:
      return
    now = time.monotonic()
    # Publish-time lookup BEFORE latching first-action: an actor can
    # observe a fresh version in the window between the last replica
    # swap inside rollout() and the publisher recording its publish
    # time — latching then would silently drop the publish-to-first-
    # action sample for that version. An unpublished step (the initial
    # version) just never latches; the lookup is a dict get.
    published = (self.publisher.publish_time(int(step))
                 if step > 0 and self.publisher is not None else None)
    with self._audit_lock:
      self._served_steps[int(step)] = \
          self._served_steps.get(int(step), 0) + 1
      self._max_seen_staleness = max(self._max_seen_staleness, staleness)
      first = int(step) not in self._first_action_s
      if first and (published is not None or step == 0):
        self._first_action_s[int(step)] = now
    if first and published is not None:
      obs_metrics.histogram("loop/publish_to_first_action_ms").record(
          (now - published) * 1e3)
      # The chain's terminal event: an instant parented on the publish
      # span that made this version servable — the scalar above becomes
      # a walkable edge in the merged timeline.
      first_ctx = graftrace.mint()
      obs_trace.instant(
          "loop/first_action", cat="loop", step=int(step),
          trace_id=first_ctx.trace_id, span_id=first_ctx.span_id,
          parent_id=self.publisher.publish_span_id(int(step)))

  def _request_repair(self) -> None:
    """Staleness repair: re-roll the current published version (rollout
    is idempotent — every serving replica re-restores the newest
    verified step, equalizing a replica readmitted with old params)."""
    current = self.publisher.published_version
    if current is not None:
      self.publisher.request_publish(current)

  # -- workers --------------------------------------------------------------

  def _spawn_actors(self) -> None:
    for index in range(self._num_actors):
      episode_actor = actor_lib.EpisodeActor(
          index=index,
          env_factory=self._env_factory,
          policy_factory=lambda i: self._policy_factory(self.fleet),
          sink=self.sink,
          episode_to_transitions_fn=self._episode_to_transitions_fn,
          serving_version_fn=self.serving_version,
          staleness_fn=self._staleness_of,
          note_version=self._note_version,
          request_repair=self._request_repair,
          max_staleness_versions=self._max_staleness,
          episodes_per_iteration=self._episodes_per_iteration,
          max_episode_steps=self._max_episode_steps,
          explore_schedule=self._explore_schedule,
          pause_s=self._actor_pause_s)
      self._actors.append(episode_actor)
      self.supervisor.spawn(f"actor-{index}", episode_actor.run)

  def _publisher_worker(self, worker) -> None:
    last_flush = time.monotonic()
    while not worker.should_stop.is_set():
      worker.beat()
      try:
        self.publisher.drain_pending(timeout_s=0.2)
      except Exception:  # noqa: BLE001 - a failed publish must not kill
        _log.exception("graftloop: publish failed")  # the worker
      now = time.monotonic()
      # Continuous SLO evaluation rides the publisher tick (~5 Hz): one
      # registry snapshot of the loop's telemetry per drain, pure
      # arithmetic per spec. A burning objective emits through the
      # incident sink; the engine never raises.
      try:
        self._slo_engine.observe(obs_metrics.snapshot(prefix="loop/"),
                                 now=now)
      except Exception:  # noqa: BLE001 - telemetry must not kill the loop
        _log.exception("graftloop: SLO evaluation failed")
      # Periodic shard flush (no-op unless graftrace.configure armed
      # the exporter): an always-on loop exports its trace/metrics
      # windows continuously, not only at teardown.
      if now - last_flush >= 5.0:
        last_flush = now
        graftrace.flush()

  def _make_input_generator(self):
    if self._input_generator_factory is not None:
      return self._input_generator_factory(self.sink.file_patterns)
    from tensor2robot_tpu_torch.data import input_generators

    return input_generators.DefaultRecordInputGenerator(
        file_patterns=self.sink.file_patterns,
        batch_size=self._train_batch_size, seed=self._seed)

  def _learner(self, worker) -> None:
    """Round-based continuous learner: progress is derived from DISK
    (latest checkpoint step), so a supervisor restart resumes instead
    of repeating — and train_eval's auto-resume + verified-restore walk
    does the heavy lifting."""
    from tensor2robot_tpu_torch import checkpoints as checkpoints_lib
    from tensor2robot_tpu_torch import train_eval

    ckpt_dir = os.path.join(self._model_dir, CHECKPOINT_DIRNAME)
    total_steps = self._steps_per_round * self._num_rounds
    while not worker.should_stop.is_set():
      worker.beat()
      # Data gate: at least min_start_shards finished shards AND at
      # least one training batch of finished RECORDS before the (first)
      # round. The record floor is load-bearing, not cosmetic: a
      # drop_remainder pipeline over a glob holding fewer records than
      # one batch yields ZERO batches per epoch and spins empty epochs
      # forever: the first fetch never returns and the learner wedges
      # while actors collect (warm actors rotate shard 0 out in under a
      # second, so a shards-only gate can pass on one 8-record file).
      # Later rounds re-glob and see everything new.
      while ((len(self.sink.finished_shards()) < self._min_start_shards
              or self.sink.finished_records() < self._train_batch_size)
             and not worker.should_stop.is_set()):
        worker.beat()
        self.sink.flush()  # make the in-progress shard visible
        if worker.should_stop.wait(timeout=0.05):
          return
      if worker.should_stop.is_set():
        return
      done = checkpoints_lib.latest_step(ckpt_dir) or 0
      if done >= total_steps:
        return  # the loop's training target is met: a clean finish
      target = min(done + self._steps_per_round, total_steps)
      _log.info("graftloop learner: round to step %d (of %d)", target,
                   total_steps)
      kwargs = dict(
          mode="train",
          max_train_steps=target,
          checkpoint_every_n_steps=self._steps_per_round,
          log_every_n_steps=1,
          reset_run_telemetry=False,
          device=self._device,
          seed=self._seed,
          executable_cache_dir=self._executable_cache_dir)
      kwargs.update(self._trainer_kwargs)
      # The beat hook matters: the round is otherwise a heartbeat-silent
      # stretch, and any heartbeat_timeout_s shorter than a full round
      # would falsely declare the learner hung and start a SECOND
      # learner on this model_dir.
      kwargs["hook_builders"] = (
          list(kwargs.get("hook_builders") or [])
          + [_LoopHookBuilder(self.publisher, worker)])
      # One trace context per round, LINKED to the replay shards the
      # round's input glob can see: the causal edge shard -> round. The
      # activation makes `after_checkpoint` -> `request_publish` capture
      # this context, so the eventual publish parents on the round.
      round_ctx = graftrace.mint()
      shard_links = sorted(set(self.sink.shard_spans().values()))
      round_ns = time.perf_counter_ns()
      with graftrace.activate(round_ctx):
        train_eval.train_eval_model(
            model=self._model_factory(),
            model_dir=self._model_dir,
            input_generator_train=self._make_input_generator(),
            **kwargs)
      obs_trace.add_complete(
          "loop/learner/round", round_ns,
          time.perf_counter_ns() - round_ns, cat="loop",
          args={**round_ctx.args(), "target_step": target,
                "links": shard_links})
      obs_metrics.counter("loop/learner_rounds").inc()

  # -- lifecycle ------------------------------------------------------------

  def run(self, wall_timeout_s: float = 600.0) -> Dict[str, Any]:
    """Runs the loop until the learner reaches its training target (or
    the timeout), then drains and closes everything. Returns
    `summary()`."""
    self._wall_start = time.monotonic()
    try:
      # Inside the try: a failure PARTWAY through fleet construction
      # (replicas built + warmup live, then the probe-request build or
      # publisher raises) must still tear everything down via close().
      self._build_fleet()
      self.supervisor.spawn("publisher", self._publisher_worker)
      self._spawn_actors()
      learner = self.supervisor.spawn("learner", self._learner)
      deadline = time.monotonic() + wall_timeout_s
      while time.monotonic() < deadline:
        state = self.supervisor.states()["learner"]
        if state in (supervisor_lib.STOPPED, supervisor_lib.FAILED):
          break
        if learner.completed and not learner.alive:
          break
        time.sleep(0.05)
      else:
        _log.warning("graftloop: wall timeout after %.1fs",
                        wall_timeout_s)
    finally:
      self.close()
    return self.summary()

  def close(self) -> None:
    if self._wall_start is not None and self._wall_s == 0.0:
      self._wall_s = time.monotonic() - self._wall_start
    self.supervisor.close()
    self.sink.close()
    if self.fleet is not None:
      self.fleet.close()
    graftrace.flush()

  # -- accounting -----------------------------------------------------------

  def summary(self) -> Dict[str, Any]:
    """Loop-level accounting (module docstring). `unverified_served`
    MUST be empty: every version actors acted on is either the initial
    random init (step 0 / a pre-loop checkpoint present at fleet build)
    or went through the publisher's verify-then-rollout path."""
    episodes = sum(a.episodes for a in self._actors)
    wall = self._wall_s or (
        time.monotonic() - self._wall_start if self._wall_start else 0.0)
    with self._audit_lock:
      served = dict(self._served_steps)
      max_staleness = self._max_seen_staleness
    initial_steps = getattr(self, "_initial_versions", {0})
    published = {s for s in served
                 if self.publisher is not None
                 and self.publisher.was_published(s)}
    unverified = sorted(s for s in served
                        if s not in initial_steps and s not in published)
    snap = obs_metrics.snapshot(prefix="loop/")
    first_action_ms = snap.get("hist/loop/publish_to_first_action_ms/max")
    return {
        "episodes": episodes,
        "wall_sec": round(wall, 3),
        "episodes_per_sec": round(episodes / wall, 3) if wall else 0.0,
        "served_versions": {str(k): v for k, v in sorted(served.items())},
        "unverified_served": unverified,
        "max_seen_staleness": max_staleness,
        "staleness_bound": self._max_staleness,
        "staleness_bound_held": max_staleness <= self._max_staleness,
        "publishes": (self.publisher.published_count
                      if self.publisher else 0),
        "publish_history": (self.publisher.history()
                            if self.publisher else []),
        "publish_to_first_action_ms_max": first_action_ms,
        "publish_to_serve_ms_max": snap.get(
            "hist/loop/publish_to_serve_ms/max"),
        "worker_restarts": snap.get("counter/loop/worker_restarts", 0.0),
        "worker_hangs": snap.get("counter/loop/worker_hangs", 0.0),
        "worker_escalations": snap.get(
            "counter/loop/worker_escalations", 0.0),
        "stale_skips": snap.get("counter/loop/stale_skips", 0.0),
        "actor_backoffs": snap.get("counter/loop/actor_backoffs", 0.0),
        "publish_rejected": snap.get("counter/loop/publish_rejected", 0.0),
        "replay": self.sink.stats(),
        "learner_rounds": snap.get("counter/loop/learner_rounds", 0.0),
        "worker_states": self.supervisor.states(),
        # graftwatch blocks: per-objective budget state and the fleet's
        # device-time ledger (None when run() never built the fleet).
        "slo": self._slo_engine.state(),
        "utilization": (self.fleet.utilization_summary()
                        if self.fleet is not None else None),
    }


class _LoopHookBuilder:
  """Builds the learner-round hooks: the publisher feed (checkpoint
  boundaries -> publish queue; rewinds retract pending publishes above
  the target) and the supervisor heartbeat (beats on every hook event,
  so hang detection stays armed while the learner trains; the longest
  silent stretch left is one step or one checkpoint save).

  The hook classes SUBCLASS `hooks.core.Hook`, made lazily (hooks.core
  imports torch, and this module imports none): train_eval calls every
  hook method, so a duck-typed hook would break on the next method the
  Hook surface gains."""

  def __init__(self, publisher: publish_lib.CheckpointPublisher, worker):
    self._publisher = publisher
    self._worker = worker

  def create_hooks(self, model, model_dir):
    from tensor2robot_tpu_torch.hooks import core as hooks_lib

    publisher = self._publisher
    worker = self._worker

    class _PublisherHook(hooks_lib.Hook):

      def after_checkpoint(self, ctx, step) -> None:
        publisher.request_publish(step)

      def after_rewind(self, ctx, step) -> None:
        obs_metrics.counter("loop/learner_rewinds").inc()
        publisher.note_rewind(step)

    class _WorkerBeatHook(hooks_lib.Hook):

      def begin(self, ctx) -> None:
        worker.beat()

      def after_step(self, ctx, step, metrics) -> None:
        worker.beat()

      def after_checkpoint(self, ctx, step) -> None:
        worker.beat()

      def after_rewind(self, ctx, step) -> None:
        worker.beat()

      def after_eval(self, ctx, step, metrics) -> None:
        worker.beat()

      def end(self, ctx) -> None:
        worker.beat()

    return [_PublisherHook(), _WorkerBeatHook()]


@config.configurable
def run_graftloop(model_ctor=config.REQUIRED,
                  env_ctor=config.REQUIRED,
                  policy_ctor=config.REQUIRED,
                  episode_to_transitions_fn=config.REQUIRED,
                  model_dir: str = config.REQUIRED,
                  num_actors: int = 2,
                  num_replicas: int = 2,
                  max_batch_size: int = 8,
                  train_batch_size: int = 16,
                  steps_per_round: int = 10,
                  num_rounds: int = 3,
                  max_staleness_versions: int = 1,
                  replay_max_mb: float = 64.0,
                  episodes_per_shard: int = 8,
                  max_episode_steps: Optional[int] = 8,
                  actor_pause_s: float = 0.0,
                  heartbeat_timeout_s: Optional[float] = None,
                  wall_timeout_s: float = 600.0,
                  device=None,
                  seed: int = 0,
                  executable_cache_dir: Optional[str] = None
                  ) -> Dict[str, Any]:
  """Config-engine entry point (`configs/loop_qtopt.gin`,
  `bin/run_graftloop.py`): builds a `GraftLoop` from configurable
  constructors — `model_ctor()` per consumer, `env_ctor()` per actor,
  `policy_ctor(predictor=fleet)` per actor — runs it to the training
  target on `device` (CUDA unless 'cpu'), and returns the loop
  summary. `executable_cache_dir` ("auto" or a path) compiles the
  replicas' rungs and the learner's step against one cache."""
  loop = GraftLoop(
      model_factory=lambda: model_ctor(),
      model_dir=model_dir,
      env_factory=lambda index: env_ctor(),
      policy_factory=lambda fleet: policy_ctor(predictor=fleet),
      episode_to_transitions_fn=episode_to_transitions_fn,
      num_actors=num_actors,
      num_replicas=num_replicas,
      max_batch_size=max_batch_size,
      train_batch_size=train_batch_size,
      steps_per_round=steps_per_round,
      num_rounds=num_rounds,
      max_staleness_versions=max_staleness_versions,
      replay_max_bytes=int(replay_max_mb * (1 << 20)),
      episodes_per_shard=episodes_per_shard,
      max_episode_steps=max_episode_steps,
      actor_pause_s=actor_pause_s,
      heartbeat_timeout_s=heartbeat_timeout_s,
      device=device,
      seed=seed,
      executable_cache_dir=executable_cache_dir)
  summary = loop.run(wall_timeout_s=wall_timeout_s)
  _log.info("graftloop summary: %s", summary)
  return summary
