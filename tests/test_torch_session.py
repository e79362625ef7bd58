"""The port's session serving, on the CPU.

Mirrors tests/test_session.py: tick-by-tick parity of a `SessionEngine`
with the port's own stateless predict and with the JAX `SessionEngine` on
the same bridged weights; continuous batching with mixed progress and
padded partial buckets; LRU eviction and `shed` admission; the horizon
error; in-flight rejection and close; a `restore()` hot-swap mid-episode;
`SessionBatcher` coalescing and affinity; and `SessionRegressionPolicy`
reset / select / close.

Tolerance: f32 1e-4 (a two-block model, f32 throughout).
"""

import threading

import numpy as np
import pytest
import torch

from tensor2robot_tpu import serving as jax_serving
from tensor2robot_tpu.models import sequence_model as jax_sequence_model
from tensor2robot_tpu.obs import metrics as jax_metrics
from tensor2robot_tpu.predictors import predictors as jax_predictors
from tensor2robot_tpu_torch import bridge
from tensor2robot_tpu_torch.models import sequence_model
from tensor2robot_tpu_torch.obs import metrics as metrics_lib
from tensor2robot_tpu_torch.policies import policies
from tensor2robot_tpu_torch.predictors import predictors
from tensor2robot_tpu_torch.serving import batcher as batcher_lib
from tensor2robot_tpu_torch.serving import session

# The port's tests run in the same worker processes as the JAX suite;
# one torch thread keeps torch from starting its OpenMP and MKL thread
# pools beside XLA's CPU threads.
torch.set_num_threads(1)

TOL = 1e-4
SEQ_KW = dict(obs_size=4, action_size=2, sequence_length=8, hidden_size=32,
              num_blocks=2, num_heads=4)
T = SEQ_KW["sequence_length"]
OBS = SEQ_KW["obs_size"]


def _port_predictor(seed=0, **overrides):
  kw = dict(SEQ_KW, attention_backend="flash", **overrides)
  predictor = predictors.CheckpointPredictor(
      model=sequence_model.SequenceRegressionModel(**kw), device="cpu")
  predictor.init_randomly(seed=seed)
  return predictor


def _engine(predictor, **kw):
  kw.setdefault("max_sessions", 6)
  kw.setdefault("max_tick_batch", 4)
  return session.SessionEngine(predictor=predictor, device="cpu", **kw)


@pytest.fixture(scope="module")
def seq_predictor():
  return _port_predictor()


@pytest.fixture(scope="module")
def warmed_engine(seq_predictor):
  with metrics_lib.isolated():
    return _engine(seq_predictor).warmup()


def _obs_seq(batch, seq_len=T, seed=0):
  return np.random.RandomState(seed).randn(batch, seq_len, OBS).astype(
      np.float32)


def _numpy_tree(tree):
  if hasattr(tree, "items"):
    return {k: _numpy_tree(v) for k, v in tree.items()}
  return np.asarray(tree)


# ---------------------------------------------------------------------------
# Parity.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("t", [8, 32])
def test_engine_matches_jax_engine_and_stateless_predict(t):
  """Every tick of two staggered sessions through the port's engine
  equals the JAX engine's tick and both stateless predicts, on bridged
  weights."""
  kw = dict(SEQ_KW, sequence_length=t)
  jax_pred = jax_predictors.CheckpointPredictor(
      model=jax_sequence_model.SequenceRegressionModel(device_type="cpu",
                                                       **kw),
      model_dir="/nonexistent")
  jax_pred.init_randomly()
  port = predictors.CheckpointPredictor(
      model=sequence_model.SequenceRegressionModel(attention_backend="flash",
                                                   **kw),
      device="cpu")
  port.load_params(bridge.state_dict_from_flax(
      _numpy_tree(jax_pred._state.params)))
  assert port.restore()
  obs = _obs_seq(2, t, seed=t)
  full = port.predict({"observation": obs})["action"]
  np.testing.assert_allclose(
      full, jax_pred.predict({"observation": obs})["action"], atol=TOL,
      rtol=TOL)
  with jax_metrics.isolated(), metrics_lib.isolated():
    jax_engine = jax_serving.SessionEngine(predictor=jax_pred, max_sessions=4,
                                           buckets=[1, 2, 4])
    engine = _engine(port, max_sessions=4, buckets=[1, 2, 4])
    jax_a, jax_b = jax_engine.open(), jax_engine.open()
    a, b = engine.open(), engine.open()
    engine.step(a, {"observation": obs[0, 0]})
    jax_engine.step(jax_a, {"observation": obs[0, 0]})
    for i in range(t - 1):
      items = [(a, {"observation": obs[0, i + 1]}),
               (b, {"observation": obs[1, i]})]
      got = engine.step_many(items)
      want = jax_engine.step_many(
          [(jax_a, items[0][1]), (jax_b, items[1][1])])
      for lane, (row, col) in enumerate([(0, i + 1), (1, i)]):
        np.testing.assert_allclose(got[lane]["action"], full[row, col],
                                   atol=TOL, rtol=TOL)
        np.testing.assert_allclose(got[lane]["action"], want[lane]["action"],
                                   atol=TOL, rtol=TOL)
    assert engine.session_ticks(a) == t and engine.session_ticks(b) == t - 1


def test_mixed_progress_continuous_batching(seq_predictor, warmed_engine):
  """Sessions at different ticks share one padded bucket (3 live lanes
  in the 4-bucket) and each matches its own stateless forward."""
  obs = {name: _obs_seq(1, seed=s) for name, s in (("a", 21), ("b", 22),
                                                  ("c", 23))}
  full = {name: seq_predictor.predict({"observation": o})["action"]
          for name, o in obs.items()}
  engine = warmed_engine
  with metrics_lib.isolated() as registry:
    sid = {name: engine.open() for name in ("a", "b")}
    for i in range(2):
      engine.step(sid["a"], {"observation": obs["a"][0, i]})
    for i in range(2):
      outs = engine.step_many([(sid["a"], {"observation": obs["a"][0, 2 + i]}),
                               (sid["b"], {"observation": obs["b"][0, i]})])
      np.testing.assert_allclose(outs[0]["action"], full["a"][0, 2 + i],
                                 atol=TOL, rtol=TOL)
      np.testing.assert_allclose(outs[1]["action"], full["b"][0, i],
                                 atol=TOL, rtol=TOL)
    sid["c"] = engine.open()
    outs = engine.step_many([(sid["a"], {"observation": obs["a"][0, 4]}),
                             (sid["b"], {"observation": obs["b"][0, 2]}),
                             (sid["c"], {"observation": obs["c"][0, 0]})])
    for out, (name, i) in zip(outs, [("a", 4), ("b", 2), ("c", 0)]):
      np.testing.assert_allclose(out["action"], full[name][0, i], atol=TOL,
                                 rtol=TOL)
    for s in sid.values():
      engine.close_session(s)
    snap = registry.snapshot()
  assert snap["counter/serve/session/padded_lanes"] == 1.0
  assert snap["counter/serve/session/ticks"] == 9.0


def test_arena_is_updated_in_place_and_null_slot_untouched(seq_predictor):
  engine = _engine(seq_predictor, max_sessions=4, buckets=[1, 2, 4])
  engine.warmup()
  ptrs = {k: v.data_ptr() for k, v in engine.arena.items()}
  sids = [engine.open() for _ in range(3)]
  obs = _obs_seq(3, seed=4)
  for i in range(3):
    engine.step_many([(s, {"observation": obs[j, i]})
                      for j, s in enumerate(sids)])
  assert {k: v.data_ptr() for k, v in engine.arena.items()} == ptrs
  for leaf in engine.arena.values():
    assert not leaf[0].any()  # the null slot stays zero
  assert sorted(engine.arena["index"][1:].tolist()) == [0, 3, 3, 3]
  assert engine.cache_bytes == sum(v.numel() * v.element_size()
                                   for v in engine.arena.values())


# ---------------------------------------------------------------------------
# SessionEngine bookkeeping.
# ---------------------------------------------------------------------------


def test_step_validates_batch_shape(warmed_engine):
  sid = warmed_engine.open()
  with pytest.raises(ValueError, match="distinct"):
    warmed_engine.step_many([(sid, {"observation": np.zeros(OBS)})] * 2)
  with pytest.raises(ValueError, match="max_tick_batch"):
    warmed_engine.step_many([(sid, {"observation": np.zeros(OBS)})] * 5)
  warmed_engine.close_session(sid)


def test_horizon_guard_raises(warmed_engine):
  obs = np.zeros(OBS, np.float32)
  sid = warmed_engine.open()
  for _ in range(T):
    warmed_engine.step(sid, {"observation": obs})
  with pytest.raises(session.SessionHorizonError, match="horizon"):
    warmed_engine.step(sid, {"observation": obs})
  assert warmed_engine.session_ticks(sid) == T
  warmed_engine.close_session(sid)


def test_unknown_and_closed_session_errors(warmed_engine):
  with pytest.raises(session.UnknownSessionError):
    warmed_engine.step(987654, {"observation": np.zeros(OBS, np.float32)})
  sid = warmed_engine.open()
  warmed_engine.close_session(sid)
  with pytest.raises(session.SessionClosedError):
    warmed_engine.step(sid, {"observation": np.zeros(OBS, np.float32)})
  warmed_engine.close_session(sid)  # idempotent


def _slow_bundle(engine):
  """Makes the engine's next dispatch block in get_state until released."""
  release, in_dispatch = threading.Event(), threading.Event()
  real_get_state = engine._bundle.get_state

  def slow_get_state():
    in_dispatch.set()
    release.wait(timeout=10.0)
    return real_get_state()

  engine._bundle = engine._bundle._replace(get_state=slow_get_state)
  return release, in_dispatch


def test_concurrent_steps_of_one_session_rejected(seq_predictor):
  engine = _engine(seq_predictor, max_sessions=2, buckets=[1]).warmup()
  sid = engine.open()
  obs = np.zeros(OBS, np.float32)
  release, in_dispatch = _slow_bundle(engine)
  thread = threading.Thread(target=lambda: engine.step(sid, {"observation":
                                                              obs}))
  thread.start()
  assert in_dispatch.wait(timeout=10.0)
  with pytest.raises(session.SessionError, match="in flight"):
    engine.step(sid, {"observation": obs})
  release.set()
  thread.join(timeout=30.0)
  assert not thread.is_alive()
  engine.step(sid, {"observation": obs})
  assert engine.session_ticks(sid) == 2


def test_close_session_waits_out_in_flight_dispatch(seq_predictor):
  engine = _engine(seq_predictor, max_sessions=2, buckets=[1]).warmup()
  sid = engine.open()
  release, in_dispatch = _slow_bundle(engine)
  done = {}
  thread = threading.Thread(target=lambda: done.setdefault(
      "out", engine.step(sid, {"observation": np.zeros(OBS, np.float32)})))
  thread.start()
  assert in_dispatch.wait(timeout=10.0)
  closer = threading.Thread(target=engine.close_session, args=(sid,))
  closer.start()
  closer.join(timeout=0.3)
  assert closer.is_alive(), "close_session returned mid-dispatch"
  release.set()
  thread.join(timeout=30.0)
  closer.join(timeout=30.0)
  assert not closer.is_alive() and "out" in done
  assert engine.active_sessions == 0


def test_failed_open_reset_leaves_no_ghost_session(seq_predictor,
                                                    monkeypatch):
  engine = _engine(seq_predictor, max_sessions=1, buckets=[1],
                   admission="shed").warmup()

  def broken_reset(slot):
    raise RuntimeError("reset failed")

  monkeypatch.setattr(engine, "_reset_slot", broken_reset)
  with pytest.raises(RuntimeError, match="reset failed"):
    engine.open()
  assert engine.active_sessions == 0
  monkeypatch.undo()
  sid = engine.open()  # the slot is free again
  engine.step(sid, {"observation": np.zeros(OBS, np.float32)})


def test_reopened_slot_starts_from_a_clean_cache(seq_predictor):
  """A slot freed by close and reused by open is reset: the new episode
  matches its own stateless forward, not the old episode's cache."""
  engine = _engine(seq_predictor, max_sessions=1, buckets=[1]).warmup()
  first = engine.open()
  for i in range(3):
    engine.step(first, {"observation": _obs_seq(1, seed=1)[0, i]})
  engine.close_session(first)
  obs = _obs_seq(1, seed=2)
  full = seq_predictor.predict({"observation": obs})["action"]
  second = engine.open()
  for i in range(T):
    out = engine.step(second, {"observation": obs[0, i]})
    np.testing.assert_allclose(out["action"], full[0, i], atol=TOL, rtol=TOL)


def test_engine_and_predictor_devices_must_agree(seq_predictor):
  with pytest.raises(ValueError, match="predictor holds its state"):
    session.SessionEngine(predictor=seq_predictor, device="meta")


# ---------------------------------------------------------------------------
# Admission under slot pressure.
# ---------------------------------------------------------------------------


def test_lru_eviction_under_slot_pressure(seq_predictor):
  with metrics_lib.isolated() as registry:
    engine = _engine(seq_predictor, max_sessions=3, max_tick_batch=2)
    obs = np.zeros(OBS, np.float32)
    sids = [engine.open() for _ in range(3)]
    engine.step(sids[1], {"observation": obs})
    engine.step(sids[2], {"observation": obs})
    extra = engine.open()  # full table: evicts sids[0]
    with pytest.raises(session.SessionEvictedError):
      engine.step(sids[0], {"observation": obs})
    engine.step(sids[1], {"observation": obs})
    engine.step(extra, {"observation": obs})
    engine.close_session(sids[0])  # closing an evicted session is a no-op
    snap = registry.snapshot()
  assert snap["counter/serve/session/evictions"] == 1.0
  assert engine.active_sessions == 3


def test_shed_admission_refuses_instead(seq_predictor):
  with metrics_lib.isolated() as registry:
    engine = _engine(seq_predictor, max_sessions=2, max_tick_batch=1,
                     admission="shed")
    engine.open(), engine.open()
    with pytest.raises(session.SessionShedError):
      engine.open()
    snap = registry.snapshot()
  assert snap["counter/serve/session/shed"] == 1.0


def test_in_flight_session_never_evicted(seq_predictor):
  engine = _engine(seq_predictor, max_sessions=2, buckets=[1]).warmup()
  busy, idle = engine.open(), engine.open()
  obs = np.zeros(OBS, np.float32)
  release, in_dispatch = _slow_bundle(engine)
  result = {}
  thread = threading.Thread(
      target=lambda: result.setdefault("out", engine.step(
          busy, {"observation": obs})))
  thread.start()
  assert in_dispatch.wait(timeout=10.0)
  opened = engine.open()  # must evict `idle`, not the in-flight `busy`
  release.set()
  thread.join(timeout=30.0)
  assert "out" in result
  with pytest.raises(session.SessionEvictedError):
    engine.step(idle, {"observation": obs})
  engine.step(busy, {"observation": obs})
  engine.step(opened, {"observation": obs})


# ---------------------------------------------------------------------------
# restore() hot-swap mid-episode.
# ---------------------------------------------------------------------------


def test_restore_mid_episode_keeps_state_coherent():
  predictor = _port_predictor()
  engine = _engine(predictor, max_sessions=3, buckets=[1]).warmup()
  obs = _obs_seq(1, seed=31)
  sid = engine.open()
  for i in range(3):
    engine.step(sid, {"observation": obs[0, i]})
  new_params = {k: v * 1.5 for k, v in predictor.state.params.items()}
  predictor.load_params(new_params, global_step=7)
  assert engine.restore()
  assert engine.global_step == 7
  out_after = engine.step(sid, {"observation": obs[0, 3]})
  assert np.isfinite(out_after["action"]).all()
  assert engine.session_ticks(sid) == 4
  # The open session continues on its old cache under the new params: it
  # equals neither prefix forward.
  full_new = predictor.predict({"observation": obs})["action"]
  assert not np.allclose(out_after["action"], full_new[0, 3], atol=TOL)
  sid2 = engine.open()
  for i in range(4):
    out = engine.step(sid2, {"observation": obs[0, i]})
    np.testing.assert_allclose(out["action"], full_new[0, i], atol=TOL,
                               rtol=TOL)
  assert not engine.restore()  # nothing staged


# ---------------------------------------------------------------------------
# SessionBatcher.
# ---------------------------------------------------------------------------


def test_batcher_coalesces_concurrent_episodes_with_parity(seq_predictor,
                                                           warmed_engine):
  episodes = {i: _obs_seq(1, seed=50 + i) for i in range(3)}
  full = {i: seq_predictor.predict({"observation": o})["action"]
          for i, o in episodes.items()}
  errors = []
  with metrics_lib.isolated() as registry:
    with session.SessionBatcher(engine=warmed_engine,
                                max_delay_ms=5.0) as batcher:
      def robot(i):
        try:
          sid = batcher.open()
          for t in range(T):
            out = batcher.step(sid, {"observation": episodes[i][0, t]})
            np.testing.assert_allclose(out["action"], full[i][0, t],
                                       atol=TOL, rtol=TOL)
          batcher.close_session(sid)
        except Exception as e:  # noqa: BLE001 - surfaced below
          errors.append(e)

      threads = [threading.Thread(target=robot, args=(i,)) for i in episodes]
      for thread in threads:
        thread.start()
      for thread in threads:
        thread.join(timeout=120.0)
      assert not any(thread.is_alive() for thread in threads)
    snap = registry.snapshot()
  assert not errors, errors
  assert snap["counter/serve/session/ticks"] == 3 * T
  assert snap["counter/serve/session/dispatches"] < 3 * T


def test_batcher_affinity_same_session_ticks_serialize(warmed_engine):
  obs = np.zeros(OBS, np.float32)
  with metrics_lib.isolated() as registry:
    with session.SessionBatcher(engine=warmed_engine,
                                max_delay_ms=20.0) as batcher:
      sid = batcher.open()
      results = []
      threads = [threading.Thread(
          target=lambda: results.append(batcher.step(
              sid, {"observation": obs}))) for _ in range(3)]
      for thread in threads:
        thread.start()
      for thread in threads:
        thread.join(timeout=60.0)
      batcher.close_session(sid)
    snap = registry.snapshot()
  assert len(results) == 3
  assert snap["counter/serve/session/dispatches"] == 3.0


def test_batcher_close_joins_worker_and_refuses(warmed_engine):
  batcher = session.SessionBatcher(engine=warmed_engine)
  batcher.close()
  assert not batcher._worker.is_alive()
  with pytest.raises(batcher_lib.ShutdownError):
    batcher.step(1, {"observation": np.zeros(OBS, np.float32)})


def test_batcher_fails_only_the_bad_session(warmed_engine):
  with session.SessionBatcher(engine=warmed_engine) as batcher:
    good = batcher.open()
    with pytest.raises(session.UnknownSessionError):
      batcher.step(424242, {"observation": np.zeros(OBS, np.float32)})
    out = batcher.step(good, {"observation": np.zeros(OBS, np.float32)})
    assert out["action"].shape == (SEQ_KW["action_size"],)
    batcher.close_session(good)


# ---------------------------------------------------------------------------
# SessionRegressionPolicy.
# ---------------------------------------------------------------------------


def test_policy_episodes_ride_sessions(seq_predictor, warmed_engine):
  policy = policies.SessionRegressionPolicy(predictor=warmed_engine,
                                            action_key="inference_output")
  obs = _obs_seq(2, seed=61)
  with metrics_lib.isolated() as registry:
    for episode in range(2):
      policy.reset()
      full = seq_predictor.predict({"observation": obs[episode:episode + 1]})
      for t in range(4):
        action = policy.sample_action({"observation": obs[episode, t]})
        np.testing.assert_allclose(action, full["inference_output"][0, t],
                                   atol=TOL, rtol=TOL)
    policy.close()
    snap = registry.snapshot()
  assert policy.session_id is None
  assert snap["counter/serve/session/opens"] == 2.0
  assert snap["counter/serve/session/closes"] == 2.0
  assert snap["hist/policy/select_action_ms/count"] == 8.0


def test_policy_horizon_error_frees_the_slot(seq_predictor):
  engine = _engine(seq_predictor, max_sessions=1, buckets=[1],
                   admission="shed")
  policy = policies.SessionRegressionPolicy(predictor=engine)
  obs = {"observation": np.zeros(OBS, np.float32)}
  policy.reset()
  for _ in range(T):
    policy.select_action(obs)
  with pytest.raises(session.SessionHorizonError):
    policy.select_action(obs)
  assert policy.session_id is None and engine.active_sessions == 0
  policy.select_action(obs)  # opens a fresh session; the slot was freed
  assert engine.active_sessions == 1


def test_policy_eviction_surfaces_and_recovers(seq_predictor):
  engine = _engine(seq_predictor, max_sessions=1, buckets=[1])
  policy = policies.SessionRegressionPolicy(predictor=engine)
  obs = {"observation": np.zeros(OBS, np.float32)}
  policy.select_action(obs)
  engine.open()  # evicts the policy's session
  with pytest.raises(session.SessionEvictedError):
    policy.select_action(obs)
  assert policy.session_id is None
  policy.abort_episode()
  assert policy.select_action(obs).shape == (SEQ_KW["action_size"],)


def test_policy_transient_error_keeps_session_id(warmed_engine, monkeypatch):
  policy = policies.SessionRegressionPolicy(predictor=warmed_engine)
  obs = {"observation": np.zeros(OBS, np.float32)}
  policy.reset()
  sid = policy.session_id

  def flaky_step(session_id, features):
    raise batcher_lib.ShedError("queue full")

  monkeypatch.setattr(warmed_engine, "step", flaky_step)
  with pytest.raises(batcher_lib.ShedError):
    policy.select_action(obs)
  assert policy.session_id == sid
  monkeypatch.undo()
  policy.select_action(obs)
  assert warmed_engine.session_ticks(sid) == 1
  policy.abort_episode()
