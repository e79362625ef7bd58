"""The always-on actor/learner loop on the port, against the JAX package.

The port of `tests/test_loop.py` (all but its lint-rule cases, whose
rule is ROADMAP item 15.3's). Supervisor restarts, hangs and
escalation; the bounded replay sink; the fenced publisher (with the
publish-while-rollout race); and the actors' staleness bound run on
both packages (`pkg`). Port only:

* the supervised loop end to end on the pose toy task on the CPU
  (actors through a 2-replica fleet, learner rounds off the replay
  sink, verified publishes rolled into the fleet, the served-version
  audit);
* the same through `bin/run_graftloop.py` and the port's
  `configs/loop_qtopt.gin` in a fresh process, 1 round and 1 replica;
* the loop package imports and runs its supervisor, sink and publisher
  with torch blocked.
"""

import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from tensor2robot_tpu import checkpoints as jax_checkpoints
from tensor2robot_tpu.data import tfrecord as jax_tfrecord
from tensor2robot_tpu.loop import actor as jax_actor
from tensor2robot_tpu.loop import publish as jax_publish
from tensor2robot_tpu.loop import replay as jax_replay
from tensor2robot_tpu.loop import supervisor as jax_supervisor
from tensor2robot_tpu.obs import metrics as jax_metrics
from tensor2robot_tpu.serving import batcher as jax_batcher
from tensor2robot_tpu.utils import retry as jax_retry
from tensor2robot_tpu_torch import checkpoints as port_checkpoints
from tensor2robot_tpu_torch.data import tfrecord as port_tfrecord
from tensor2robot_tpu_torch.loop import actor as port_actor
from tensor2robot_tpu_torch.loop import publish as port_publish
from tensor2robot_tpu_torch.loop import replay as port_replay
from tensor2robot_tpu_torch.loop import supervisor as port_supervisor
from tensor2robot_tpu_torch.obs import metrics as port_metrics
from tensor2robot_tpu_torch.serving import batcher as port_batcher
from tensor2robot_tpu_torch.utils import config as port_config
from tensor2robot_tpu_torch.utils import retry as port_retry

torch.set_num_threads(1)

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _clean_config():
  """No binding another test left in the port's config reaches the
  configurables of the loop and its fleet."""
  port_config.clear_config()
  yield
  port_config.clear_config()


def _fast_policy(retry_lib):
  return retry_lib.RetryPolicy(
      name="test_loop", max_attempts=3, base_delay_s=0.01, multiplier=1.0,
      max_delay_s=0.01, jitter=0.0)


PACKAGES = {
    "port": dict(checkpoints_lib=port_checkpoints, tfrecord=port_tfrecord,
                 actor_lib=port_actor, publish_lib=port_publish,
                 replay_lib=port_replay, supervisor_lib=port_supervisor,
                 metrics_lib=port_metrics, batcher_lib=port_batcher,
                 retry_lib=port_retry, FAST_POLICY=_fast_policy(port_retry),
                 FRESH="fresh_warms"),
    "jax": dict(checkpoints_lib=jax_checkpoints, tfrecord=jax_tfrecord,
                actor_lib=jax_actor, publish_lib=jax_publish,
                replay_lib=jax_replay, supervisor_lib=jax_supervisor,
                metrics_lib=jax_metrics, batcher_lib=jax_batcher,
                retry_lib=jax_retry, FAST_POLICY=_fast_policy(jax_retry),
                FRESH="fresh_compiles"),
}

# The module's names are the port's, except inside a `pkg` test, which
# binds them to its package for the test's duration.
globals().update(PACKAGES["port"])


@pytest.fixture(params=sorted(PACKAGES))
def pkg(request):
  globals().update(PACKAGES[request.param])
  try:
    yield request.param
  finally:
    globals().update(PACKAGES["port"])


def _wait_for(predicate, timeout_s=5.0, msg="condition"):
  deadline = time.monotonic() + timeout_s
  while time.monotonic() < deadline:
    if predicate():
      return
    time.sleep(0.01)
  raise AssertionError(f"timed out waiting for {msg}")


# ---------------------------------------------------------------------------
# Supervisor
# ---------------------------------------------------------------------------


@pytest.mark.usefixtures("pkg")
class TestSupervisor:

  def test_crash_restarts_with_fresh_generation(self):
    runs = []

    def target(worker):
      runs.append(worker.generation)
      if worker.generation < 3:
        raise RuntimeError("boom")
      while not worker.should_stop.is_set():
        worker.beat()
        time.sleep(0.005)

    with metrics_lib.isolated() as registry:
      sup = supervisor_lib.Supervisor(restart_policy=FAST_POLICY)
      with sup:
        sup.spawn("w", target)
        _wait_for(lambda: len(runs) >= 3 and sup.states()["w"]
                  == supervisor_lib.RUNNING, msg="restart to gen 3")
      snap = registry.snapshot()
    assert runs[:3] == [1, 2, 3]
    assert snap["counter/loop/worker_restarts"] >= 2
    # Two crashes < max_attempts=3: never escalated.
    assert "counter/loop/worker_escalations" not in snap

  def test_clean_return_is_completion_not_crash(self):
    sup = supervisor_lib.Supervisor(restart_policy=FAST_POLICY)
    with sup:
      handle = sup.spawn("w", lambda worker: None)
      _wait_for(lambda: sup.states()["w"] == supervisor_lib.STOPPED,
                msg="clean stop")
      assert handle.completed
      assert handle.generation == 1  # never restarted

  def test_escalation_after_budget_exhausted(self):
    def always_crash(worker):
      raise RuntimeError("persistent")

    incidents = []
    with metrics_lib.isolated() as registry:
      sup = supervisor_lib.Supervisor(restart_policy=FAST_POLICY,
                                      sinks=[incidents.append])
      with sup:
        sup.spawn("w", always_crash)
        _wait_for(lambda: sup.states()["w"] == supervisor_lib.FAILED,
                  msg="escalation")
        # FAILED is terminal: no further restarts accrue.
        restarts = registry.snapshot()["counter/loop/worker_restarts"]
        time.sleep(0.1)
        assert registry.snapshot()[
            "counter/loop/worker_restarts"] == restarts
      snap = registry.snapshot()
    assert snap["counter/loop/worker_escalations"] == 1
    kinds = [r["kind"] for r in incidents]
    assert "loop_worker_restart" in kinds
    assert "loop_worker_lost" in kinds
    lost = [r for r in incidents if r["kind"] == "loop_worker_lost"]
    assert lost[0]["severity"] == "fatal"

  def test_hang_detection_abandons_and_replaces(self):
    release = threading.Event()
    generations = []

    def target(worker):
      generations.append(worker.generation)
      worker.beat()
      if worker.generation == 1:
        release.wait(timeout=10.0)  # stalls WITHOUT beating
        return
      while not worker.should_stop.is_set():
        worker.beat()
        time.sleep(0.005)

    with metrics_lib.isolated() as registry:
      sup = supervisor_lib.Supervisor(restart_policy=FAST_POLICY,
                                      heartbeat_timeout_s=0.1)
      try:
        sup.spawn("w", target)
        _wait_for(lambda: len(generations) >= 2, msg="replacement gen")
        snap = registry.snapshot()
        assert snap["counter/loop/worker_hangs"] == 1
      finally:
        release.set()  # let the abandoned gen-1 thread finish
        sup.close()

  def test_revive_failed_worker(self):
    crashes = []

    def target(worker):
      crashes.append(worker.generation)
      if len(crashes) <= FAST_POLICY.max_attempts:
        raise RuntimeError("boom")
      while not worker.should_stop.is_set():
        worker.beat()
        time.sleep(0.005)

    sup = supervisor_lib.Supervisor(restart_policy=FAST_POLICY)
    with sup:
      sup.spawn("w", target)
      _wait_for(lambda: sup.states()["w"] == supervisor_lib.FAILED,
                msg="failure")
      sup.revive_worker("w")
      _wait_for(lambda: sup.states()["w"] == supervisor_lib.RUNNING,
                msg="revival")

  def test_healthy_run_resets_restart_budget(self):
    sup = supervisor_lib.Supervisor(restart_policy=FAST_POLICY,
                                    healthy_reset_s=0.05)
    with sup:

      def target(worker):
        while not worker.should_stop.is_set():
          worker.beat()
          time.sleep(0.005)

      handle = sup.spawn("w", target)
      handle.attempts = FAST_POLICY.max_attempts - 1  # one from the edge
      _wait_for(lambda: handle.attempts == 0, msg="budget amnesty")

  def test_recovered_hung_worker_is_not_a_zombie(self):
    """A hung worker's thread cannot be killed — it is abandoned and
    replaced. When it eventually RECOVERS it must see its own
    generation's (set) stop event and exit, not the replacement's
    fresh event; and its beats must not mask a replacement hang."""
    wedge = threading.Event()
    loops = {1: 0, 2: 0}
    exited = threading.Event()

    def target(worker):
      worker.beat()
      if worker.generation == 1:
        wedge.wait(timeout=10.0)  # hang without beating
      while not worker.should_stop.is_set():
        loops[worker.generation] = loops.get(worker.generation, 0) + 1
        worker.beat()
        time.sleep(0.005)
      if worker.generation == 1:
        exited.set()

    sup = supervisor_lib.Supervisor(restart_policy=FAST_POLICY,
                                    heartbeat_timeout_s=0.1)
    try:
      sup.spawn("w", target)
      _wait_for(lambda: loops.get(2, 0) > 0, msg="replacement running")
      gen1_loops = loops[1]
      wedge.set()  # the abandoned gen-1 thread recovers NOW
      assert exited.wait(timeout=5.0), "recovered gen 1 never exited"
      # The recovered generation exited promptly via ITS OWN set stop
      # event instead of looping alongside gen 2.
      assert loops[1] <= gen1_loops + 1
    finally:
      sup.close()

  def test_spawn_duplicate_name_rejected(self):
    sup = supervisor_lib.Supervisor(restart_policy=FAST_POLICY)
    with sup:
      sup.spawn("w", lambda worker: None)
      with pytest.raises(ValueError):
        sup.spawn("w", lambda worker: None)


# ---------------------------------------------------------------------------
# Replay sink
# ---------------------------------------------------------------------------


def _episode(n_bytes=64, records=2):
  return [os.urandom(n_bytes) for _ in range(records)]


@pytest.mark.usefixtures("pkg")
class TestReplaySink:

  def test_rotation_and_glob_never_sees_tmp(self, tmp_path):
    sink = replay_lib.ReplayRecordSink(str(tmp_path / "r"),
                                       episodes_per_shard=2)
    with sink:
      assert sink.append_episode(_episode())
      # One episode in: the in-progress shard is a .tmp the learner's
      # glob must not match.
      import glob as glob_mod

      assert glob_mod.glob(sink.file_patterns) == []
      assert sink.append_episode(_episode())
      shards = sink.finished_shards()
      assert len(shards) == 1
      assert shards[0].endswith("shard-00000000.tfrecord")
      assert tfrecord.count_records(shards[0]) == 4
      assert sink.finished_records() == 4

  def test_shed_mode_refuses_over_cap(self, tmp_path):
    with metrics_lib.isolated() as registry:
      sink = replay_lib.ReplayRecordSink(
          str(tmp_path / "r"), max_bytes=500, episodes_per_shard=1,
          on_full="shed")
      with sink:
        # One episode = 2 records x (256 payload + 16 framing) = 544
        # bytes > the 500-byte cap once written.
        assert sink.append_episode(_episode(n_bytes=256))
        # Over the cap now: the next episode is SHED, visibly.
        assert not sink.append_episode(_episode(n_bytes=256))
      snap = registry.snapshot()
    assert snap["counter/loop/replay/shed_episodes"] == 1
    assert snap["counter/loop/replay/episodes"] == 1

  def test_drop_oldest_ages_out_and_keeps_accounting(self, tmp_path):
    with metrics_lib.isolated() as registry:
      sink = replay_lib.ReplayRecordSink(
          str(tmp_path / "r"), max_bytes=1200, episodes_per_shard=1,
          on_full="drop_oldest")
      with sink:
        for _ in range(4):
          assert sink.append_episode(_episode(n_bytes=256))
        shards = sink.finished_shards()
        # Oldest shards deleted; collection never stalled.
        assert shards and not any(
            s.endswith("shard-00000000.tfrecord") for s in shards)
        assert sink.total_bytes() <= 1200 + 600  # cap + ~one shard slack
        assert sink.finished_records() == 2 * len(shards)
      snap = registry.snapshot()
    assert snap["counter/loop/replay/dropped_shards"] >= 1

  def test_resume_inventories_and_clears_torn_tmp(self, tmp_path):
    root = str(tmp_path / "r")
    sink = replay_lib.ReplayRecordSink(root, episodes_per_shard=1)
    sink.append_episode(_episode())
    sink.close()
    # A torn in-progress shard from a crashed writer.
    torn = os.path.join(root, "shard-00000009.tfrecord.tmp")
    with open(torn, "wb") as f:
      f.write(b"torn")
    resumed = replay_lib.ReplayRecordSink(root, episodes_per_shard=1)
    with resumed:
      assert not os.path.exists(torn)
      assert len(resumed.finished_shards()) == 1
      assert resumed.finished_records() == 2  # counted from disk
      resumed.append_episode(_episode())
      # The new shard index continues past every existing one.
      assert any(s.endswith("shard-00000001.tfrecord")
                 for s in resumed.finished_shards())

  def test_flush_finalizes_partial_shard(self, tmp_path):
    sink = replay_lib.ReplayRecordSink(str(tmp_path / "r"),
                                       episodes_per_shard=100)
    with sink:
      sink.write(_episode())  # replay_writer duck-type
      assert sink.finished_shards() == []
      sink.flush()
      assert len(sink.finished_shards()) == 1

  def test_close_discards_empty_shard(self, tmp_path):
    sink = replay_lib.ReplayRecordSink(str(tmp_path / "r"),
                                       episodes_per_shard=2)
    sink.append_episode(_episode())
    sink.flush()
    sink.close()
    # Only COMPLETE learner-visible shards on disk — no .tmp, no
    # 0-record file.
    files = os.listdir(str(tmp_path / "r"))
    assert all(f.endswith(".tfrecord") for f in files)
    assert len(files) == 1


# ---------------------------------------------------------------------------
# Publisher: verification, coalescing, rewind, and THE fence
# ---------------------------------------------------------------------------


class _FakeFleet:
  """Serving-side double for the publisher: rollout() atomically moves
  every replica to `next_version` (set by the test), records overlap
  and per-replica version history, and FAILS the test's invariant if a
  second rollout ever enters while one is in flight."""

  def __init__(self, num_replicas=2, swap_sleep_s=0.0):
    self.versions = [0] * num_replicas
    self.next_version = 0
    self.swap_sleep_s = swap_sleep_s
    self.in_rollout = False
    self.overlap_detected = False
    self.observed = []  # version sets sampled mid-swap by the checker

  def rollout(self, probe_request=None, verify=None, drain_timeout_s=0.0):
    if self.in_rollout:
      self.overlap_detected = True
    self.in_rollout = True
    # Latched at ENTRY, like the real fleet: a rollout restores the
    # newest checkpoint as of its start; the fence is what keeps a
    # later publish from retargeting replicas mid-flight.
    target = self.next_version
    try:
      for index in range(len(self.versions)):
        self.versions[index] = target
        if self.swap_sleep_s:
          time.sleep(self.swap_sleep_s)
      return {"swapped": len(self.versions), "aborted": None,
              "parity_ok": True, FRESH: 0, "canary_index": 0}
    finally:
      self.in_rollout = False

  @property
  def global_step(self):
    return max(self.versions)


def _make_verified_step(ckpt_dir, step, payload=b"params"):
  step_dir = os.path.join(ckpt_dir, str(step))
  os.makedirs(step_dir, exist_ok=True)
  with open(os.path.join(step_dir, "state.bin"), "wb") as f:
    f.write(payload + str(step).encode())
  checkpoints_lib.write_manifest(ckpt_dir, step)


@pytest.mark.usefixtures("pkg")
class TestPublisher:

  def test_verified_publish_and_ordinals(self, tmp_path):
    ckpt = str(tmp_path / "ckpt")
    for step in (10, 20):
      _make_verified_step(ckpt, step)
    fleet = _FakeFleet()
    pub = publish_lib.CheckpointPublisher(fleet, ckpt)
    fleet.next_version = 10
    report = pub.publish(10)
    assert report["published"] and report["verified"] is True
    fleet.next_version = 20
    pub.publish(20)
    assert pub.published_version == 20
    assert pub.ordinal_of(10) == 1 and pub.ordinal_of(20) == 2
    assert pub.ordinal_of(0) == 0  # the initial random-init version
    assert pub.staleness_of(20) == 0
    assert pub.staleness_of(10) == 1
    assert pub.staleness_of(0) == 2
    assert pub.publish_time(20) is not None

  def test_torn_checkpoint_refused(self, tmp_path):
    ckpt = str(tmp_path / "ckpt")
    _make_verified_step(ckpt, 10)
    # Tear the step AFTER its manifest was written from the good bytes.
    with open(os.path.join(ckpt, "10", "state.bin"), "wb") as f:
      f.write(b"t")
    incidents = []
    with metrics_lib.isolated() as registry:
      fleet = _FakeFleet()
      fleet.next_version = 10
      pub = publish_lib.CheckpointPublisher(fleet, ckpt,
                                            sinks=[incidents.append])
      report = pub.publish(10)
      snap = registry.snapshot()
    assert not report["published"] and report["verified"] is False
    assert snap["counter/loop/publish_rejected"] == 1
    assert fleet.versions == [0, 0]  # the torn step never reached serving
    assert pub.published_version is None
    assert [r["kind"] for r in incidents] == ["loop_publish_rejected"]

  def test_missing_manifest_refused_after_timeout(self, tmp_path):
    ckpt = str(tmp_path / "ckpt")
    os.makedirs(os.path.join(ckpt, "10"), exist_ok=True)  # no manifest
    with metrics_lib.isolated() as registry:
      fleet = _FakeFleet()
      fleet.next_version = 10
      pub = publish_lib.CheckpointPublisher(fleet, ckpt,
                                            manifest_timeout_s=0.1)
      report = pub.publish(10)
      snap = registry.snapshot()
    assert not report["published"] and report["verified"] is None
    assert "no manifest" in report["reason"]
    assert snap["counter/loop/publish_rejected"] == 1
    assert fleet.versions == [0, 0]

  def test_request_coalescing_latest_wins(self, tmp_path):
    ckpt = str(tmp_path / "ckpt")
    for step in (10, 20, 30):
      _make_verified_step(ckpt, step)
    fleet = _FakeFleet()
    pub = publish_lib.CheckpointPublisher(fleet, ckpt)
    pub.request_publish(10)
    pub.request_publish(30)
    pub.request_publish(20)  # stale request arriving late: ignored
    fleet.next_version = 30
    report = pub.drain_pending(timeout_s=0.1)
    assert report["step"] == 30 and report["published"]
    # Queue drained: nothing pending.
    assert pub.drain_pending(timeout_s=0.01) is None
    assert pub.published_count == 1  # 10 and 20 never shipped

  def test_rewind_drops_pending_above_target(self, tmp_path):
    ckpt = str(tmp_path / "ckpt")
    _make_verified_step(ckpt, 10)
    fleet = _FakeFleet()
    pub = publish_lib.CheckpointPublisher(fleet, ckpt)
    pub.request_publish(20)  # about to be rewound away
    pub.note_rewind(10)
    assert pub.drain_pending(timeout_s=0.05) is None
    # A pending request AT/BELOW the target survives a rewind.
    pub.request_publish(10)
    pub.note_rewind(10)
    fleet.next_version = 10
    report = pub.drain_pending(timeout_s=0.1)
    assert report is not None and report["published"]

  def test_rotted_published_step_demoted_for_repair(self, tmp_path):
    """A published step whose bytes later fail verification is DEMOTED:
    `published_version` (what the staleness repair re-rolls) falls back
    to the newest still-verified published step instead of
    re-requesting the dead one forever — while the served-version
    audit (`was_published`) keeps crediting actions taken while the
    step WAS verified."""
    ckpt = str(tmp_path / "ckpt")
    for step in (10, 20):
      _make_verified_step(ckpt, step)
    fleet = _FakeFleet()
    pub = publish_lib.CheckpointPublisher(fleet, ckpt,
                                          manifest_timeout_s=0.1)
    fleet.next_version = 10
    pub.publish(10)
    fleet.next_version = 20
    pub.publish(20)
    assert pub.published_version == 20
    # Step 20's bytes rot on disk AFTER its verified publish.
    with open(os.path.join(ckpt, "20", "state.bin"), "wb") as f:
      f.write(b"rot")
    report = pub.publish(20)  # the repair's re-roll attempt
    assert not report["published"]
    # Fallback: the repair now targets the newest SERVABLE publish.
    assert pub.published_version == 10
    assert pub.staleness_of(10) == 0  # ...which reads as current again
    # The audit still credits actions taken while 20 was verified.
    assert pub.was_published(20) and pub.was_published(10)
    assert pub.published_count == 2

  def test_publish_while_rollout_in_flight_never_mixes(self, tmp_path):
    """THE fence: a checkpoint published during an
    in-flight rollout must wait — interleaved rollouts would leave the
    fleet serving MIXED params with both reporting success. The fake
    fleet trips `overlap_detected` on any concurrent rollout entry; the
    sampler asserts every mid-flight version set is uniform-or-
    monotonic, never a blend that includes a version no rollout has
    finished shipping."""
    ckpt = str(tmp_path / "ckpt")
    for step in (10, 20):
      _make_verified_step(ckpt, step)
    fleet = _FakeFleet(num_replicas=4, swap_sleep_s=0.02)
    pub = publish_lib.CheckpointPublisher(fleet, ckpt)

    stop = threading.Event()
    samples = []

    def sampler():
      while not stop.is_set():
        samples.append(tuple(fleet.versions))
        time.sleep(0.002)

    def publish(step):
      fleet.next_version = step  # latest intent wins inside the fence
      pub.publish(step)

    checker = threading.Thread(target=sampler)
    checker.start()
    first = threading.Thread(target=publish, args=(10,))
    second = threading.Thread(target=publish, args=(20,))
    first.start()
    time.sleep(0.03)  # land mid-rollout of step 10
    second.start()
    first.join()
    second.join()
    stop.set()
    checker.join()

    assert not fleet.overlap_detected, "rollouts overlapped"
    assert fleet.versions == [20, 20, 20, 20]
    # No sampled state ever mixes 20 into a fleet still rolling 10:
    # version sets seen are subsets of {0, 10} (first rollout) or
    # {10, 20} (second) — never {0, 20} or {0, 10, 20}.
    for sample in samples:
      distinct = set(sample)
      assert distinct <= {0, 10} or distinct <= {10, 20}, samples


# ---------------------------------------------------------------------------
# Actor staleness bound
# ---------------------------------------------------------------------------


class _FakeWorker:
  def __init__(self):
    self.should_stop = threading.Event()
    self.generation = 1
    self.beats = 0

  def beat(self):
    self.beats += 1


class _AbortSpyPolicy:
  def __init__(self):
    self.aborts = 0

  def abort_episode(self):
    self.aborts += 1


@pytest.mark.usefixtures("pkg")
class TestActorStaleness:

  def test_stale_actor_drains_repins_and_never_acts(self):
    policy = _AbortSpyPolicy()
    repairs = []
    noted = []

    actor = actor_lib.EpisodeActor(
        index=0,
        env_factory=lambda i: None,
        policy_factory=lambda i: policy,
        sink=None,
        serving_version_fn=lambda: 10,
        staleness_fn=lambda step: 3,  # > bound
        note_version=lambda step, staleness: noted.append(step),
        request_repair=lambda: repairs.append(True),
        max_staleness_versions=1,
        stale_backoff_s=0.005)
    worker = _FakeWorker()
    with metrics_lib.isolated() as registry:
      thread = threading.Thread(target=actor.run, args=(worker,))
      thread.start()
      _wait_for(lambda: registry.snapshot().get(
          "counter/loop/stale_skips", 0) >= 3, msg="stale skips")
      worker.should_stop.set()
      thread.join(timeout=5.0)
      snap = registry.snapshot()
    assert actor.episodes == 0  # the bound: no action while stale
    assert noted == []  # never recorded as a served version
    # Drain/repair fire ONCE per fresh->stale transition (not per wait
    # iteration); the final teardown abort adds the second abort call.
    assert repairs == [True]
    assert snap["counter/loop/stale_repins"] == 1
    assert policy.aborts == 2
    assert snap["counter/loop/stale_skips"] >= 3

  def test_serving_refusal_is_backpressure_not_a_crash(self):
    class _SheddingEnv:
      def reset(self, seed=None):
        return {"x": np.zeros(2, np.float32)}, {}

      def step(self, action):
        raise batcher_lib.ShedError("queue full")

    class _Policy(_AbortSpyPolicy):
      def reset(self):
        pass

      def sample_action(self, obs, explore_prob=0.0):
        return np.zeros(2, np.float32)

    policy = _Policy()
    actor = actor_lib.EpisodeActor(
        index=0,
        env_factory=lambda i: _SheddingEnv(),
        policy_factory=lambda i: policy,
        sink=None,
        serving_version_fn=lambda: 0,
        staleness_fn=lambda step: 0,
        max_staleness_versions=1,
        stale_backoff_s=0.005)
    worker = _FakeWorker()
    with metrics_lib.isolated() as registry:
      thread = threading.Thread(target=actor.run, args=(worker,))
      thread.start()
      _wait_for(lambda: registry.snapshot().get(
          "counter/loop/actor_backoffs", 0) >= 2, msg="backoffs")
      worker.should_stop.set()
      thread.join(timeout=5.0)
      snap = registry.snapshot()
    assert thread is not None and not thread.is_alive()
    assert snap["counter/loop/actor_backoffs"] >= 2
    assert snap["counter/env/aborted_episodes"] >= 2  # run_env teardown




# ---------------------------------------------------------------------------
# Port only: the loop end to end, the CLI, the import surface.
# ---------------------------------------------------------------------------


def test_graftloop_end_to_end_collect_train_publish(tmp_path):
  """In one process: an actor pool collects through a 2-replica fleet,
  the learner trains rounds off the replay sink, every published
  checkpoint is manifest-verified and rolled out, and the summary's
  audit shows no unverified version was acted on and the staleness
  bound held."""
  from tensor2robot_tpu_torch.envs import pose_env
  from tensor2robot_tpu_torch.loop import loop as loop_lib
  from tensor2robot_tpu_torch.policies import policies as policies_lib
  from tensor2robot_tpu_torch.research.pose_env import models as pose_models

  with port_metrics.isolated():
    graft_loop = loop_lib.GraftLoop(
        model_factory=pose_models.PoseEnvContinuousMCModel,
        model_dir=str(tmp_path / "loop"),
        env_factory=lambda i: pose_env.PoseToyEnv(seed=i),
        policy_factory=lambda fleet: policies_lib.CEMPolicy(
            predictor=fleet, action_size=2, cem_samples=8,
            cem_iterations=2, cem_elites=3, seed=0),
        episode_to_transitions_fn=pose_env.episode_to_transitions,
        num_actors=2, num_replicas=2, max_batch_size=8,
        train_batch_size=16, steps_per_round=5, num_rounds=2,
        max_staleness_versions=1, replay_max_bytes=32 << 20,
        episodes_per_shard=8, max_episode_steps=2, actor_pause_s=0.05,
        device="cpu", seed=0)
    summary = graft_loop.run(wall_timeout_s=240.0)

  assert summary["episodes"] > 0
  assert summary["publishes"] >= 1
  published = [h for h in summary["publish_history"] if h["published"]]
  assert published and all(h["verified"] is True for h in published)
  assert all(h["rollout"]["fresh_warms"] == 0 for h in published)
  assert summary["unverified_served"] == []
  assert summary["staleness_bound_held"]
  assert summary["worker_escalations"] == 0
  assert summary["replay"]["finished_records"] >= 16
  assert port_checkpoints.latest_step(
      str(tmp_path / "loop" / "checkpoints")) == 10
  assert "failed" not in summary["worker_states"].values()
  assert set(summary["utilization"]["groups"]) == {"replica0", "replica1"}


def test_loop_config_runs_in_fresh_process(tmp_path):
  """`configs/loop_qtopt.gin` drives the supervised loop through the
  `run_graftloop` CLI in a fresh process (every configurable it names
  resolves from the config's own imports), and the loop's audit holds
  on that path."""
  model_dir = str(tmp_path / "loop")
  config_path = os.path.join(REPO_ROOT, "tensor2robot_tpu_torch", "configs",
                             "loop_qtopt.gin")
  result = subprocess.run(
      [sys.executable, "-m", "tensor2robot_tpu_torch.bin.run_graftloop",
       "--config_files", config_path,
       "--config", f"run_graftloop.model_dir = {model_dir!r}",
       "--config", "run_graftloop.device = 'cpu'",
       "--config", "run_graftloop.steps_per_round = 4",
       "--config", "run_graftloop.num_rounds = 1",
       "--config", "run_graftloop.num_replicas = 1",
       "--config", "run_graftloop.wall_timeout_s = 200.0"],
      capture_output=True, text=True, timeout=240, cwd=REPO_ROOT,
      env={**os.environ, "PYTHONPATH": REPO_ROOT})
  assert result.returncode == 0, result.stderr[-3000:]
  summary = json.loads(result.stdout.strip().splitlines()[-1])
  assert summary["episodes"] > 0
  assert summary["unverified_served"] == []
  assert summary["staleness_bound_held"]
  assert summary["worker_escalations"] == 0
  assert os.path.isdir(os.path.join(model_dir, "checkpoints"))


def test_loop_layer_imports_no_torch():
  """The loop package imports, and the supervisor's restart machinery
  and the replay sink run, with torch blocked: torch comes in only
  through the factories that run the model. The publisher's manifest
  check (through `checkpoints`) then runs without initialising CUDA."""
  code = """
import os, sys, tempfile, time
sys.modules["torch"] = None
from tensor2robot_tpu_torch.loop import (CheckpointPublisher, EpisodeActor,
                                         ReplayRecordSink, Supervisor)
from tensor2robot_tpu_torch.loop import loop as loop_lib
from tensor2robot_tpu_torch.utils import retry

root = tempfile.mkdtemp()
sink = ReplayRecordSink(os.path.join(root, "r"), episodes_per_shard=1)
sink.append_episode([b"rec1", b"rec2"])
assert sink.finished_records() == 2
sink.close()

policy = retry.RetryPolicy(name="t", max_attempts=2, base_delay_s=0.01,
                           multiplier=1.0, max_delay_s=0.01, jitter=0.0)
crashes = []
def target(worker):
  crashes.append(worker.generation)
  if worker.generation == 1:
    raise RuntimeError("boom")
  while not worker.should_stop.is_set():
    worker.beat(); time.sleep(0.005)
with Supervisor(restart_policy=policy) as sup:
  sup.spawn("w", target)
  deadline = time.monotonic() + 5.0
  while len(crashes) < 2 and time.monotonic() < deadline:
    time.sleep(0.01)
  assert len(crashes) >= 2, crashes

del sys.modules["torch"]
class Fleet:
  def rollout(self, **kw):
    return {"swapped": 1, "aborted": None}
  @property
  def global_step(self): return 0
pub = CheckpointPublisher(Fleet(), os.path.join(root, "ckpt"),
                          manifest_timeout_s=0.05)
report = pub.publish(5)
assert not report["published"], report  # no manifest -> refused
import torch
assert not torch.cuda.is_initialized()
print("LOOP_NO_TORCH_OK")
"""
  result = subprocess.run(
      [sys.executable, "-c", code], capture_output=True, text=True,
      timeout=120, cwd=REPO_ROOT, env={**os.environ, "PYTHONPATH": REPO_ROOT})
  assert result.returncode == 0, (result.stdout[-2000:],
                                  result.stderr[-2000:])
  assert "LOOP_NO_TORCH_OK" in result.stdout
