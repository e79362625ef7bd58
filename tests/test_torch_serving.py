"""The port's stateless serving stack, on the CPU: bucket ladders,
`BucketedEngine`, `MicroBatcher`, the load generator and a policy in
front of them.

Mirrors `tests/test_graftserve.py` on the port: the engine over a port
`CheckpointPredictor` (the small critic, GraspingCNN at 32x32, f32, on
the CPU), the batcher over a numpy backend.

* The ladder functions equal the JAX package's over seeded size lists.
* The engine runs every rung once at warmup (`warm_count`), never again
  across a randomized request-size sweep (padding and oversize chunking
  included), and every output matches the unbatched predict row for row
  (1e-5 relative: the CPU's convolutions sum in another order at
  another batch size). A `restore()` hot swap is served without
  re-warming; non-batched outputs pass through intact; a rung that fails
  raises (there is no fallback).
* The batcher coalesces and splits exactly, flushes partial batches at
  `max_delay_ms`, sheds on deadline and on a full queue, bypasses
  oversize requests, fans a backend error out to every caller, and on
  close finishes the in-flight batch and fails the queued ones.

Every thread join and event wait has a timeout.
"""

import threading
import time

import numpy as np
import pytest
import torch

from tensor2robot_tpu.serving import engine as jax_engine
from tensor2robot_tpu.serving import loadgen as jax_loadgen
from tensor2robot_tpu_torch import serving
from tensor2robot_tpu_torch import specs
from tensor2robot_tpu_torch.obs import metrics as metrics_lib
from tensor2robot_tpu_torch.policies import policies
from tensor2robot_tpu_torch.predictors import predictors
from tensor2robot_tpu_torch.research.qtopt import flagship
from tensor2robot_tpu_torch.serving import engine as engine_lib
from tensor2robot_tpu_torch.serving import loadgen
from tensor2robot_tpu_torch.utils import config

# The port's tests run in the same worker processes as the JAX suite;
# one torch thread keeps torch from starting its OpenMP and MKL thread
# pools beside XLA's CPU threads.
torch.set_num_threads(1)

JOIN_S = 30.0
RTOL = 1e-5


def _join(threads):
  for t in threads:
    t.join(timeout=JOIN_S)
  assert not any(t.is_alive() for t in threads), "a client thread hung"


# ---------------------------------------------------------------------------
# Bucket ladders.
# ---------------------------------------------------------------------------


class TestBucketLadder:

  def test_doubling_ladder(self):
    assert engine_lib.bucket_ladder(8) == [1, 2, 4, 8]
    assert engine_lib.bucket_ladder(1) == [1]

  def test_non_power_of_two_max_is_top_rung(self):
    assert engine_lib.bucket_ladder(12) == [1, 2, 4, 8, 12]

  def test_invalid_max_raises(self):
    with pytest.raises(ValueError):
      engine_lib.bucket_ladder(0)
    with pytest.raises(ValueError):
      engine_lib.traffic_bucket_ladder([1, 2], 0)
    with pytest.raises(ValueError):
      engine_lib.ladder_padding_stats([1, 2], [])

  @pytest.mark.parametrize("seed", range(6))
  def test_traffic_ladder_and_padding_stats_equal_jax(self, seed):
    rng = np.random.RandomState(seed)
    max_batch = int(rng.choice([4, 8, 12, 16, 32]))
    # Skewed mixes: a robot fleet at 1 row, CEM sweeps, uniform noise.
    sizes = (list(rng.randint(1, 3, size=rng.randint(0, 60)))
             + list(rng.randint(1, 3 * max_batch, size=rng.randint(0, 40)))
             + [int(rng.randint(1, max_batch + 1))] * int(rng.randint(0, 30)))
    for kwargs in ({}, {"min_share": 0.1, "split_waste": 0.1,
                        "max_buckets": 5}):
      want = jax_engine.traffic_bucket_ladder(sizes, max_batch, **kwargs)
      got = engine_lib.traffic_bucket_ladder(sizes, max_batch, **kwargs)
      assert got == want
      for ladder in (got, engine_lib.bucket_ladder(max_batch)):
        assert engine_lib.ladder_padding_stats(sizes, ladder) == \
            jax_engine.ladder_padding_stats(sizes, ladder)

  def test_uniform_traffic_keeps_the_fixed_ladder(self):
    sizes = list(range(1, 9)) * 50
    assert engine_lib.traffic_bucket_ladder(sizes, 8) == [1, 2, 4, 8]
    assert engine_lib.traffic_bucket_ladder([], 8) == [1, 2, 4, 8]

  def test_observed_request_rows_reads_the_batcher_stream(self):
    with metrics_lib.isolated(), \
        serving.MicroBatcher(backend=_NumpyBackend(), max_batch_size=4,
                             max_delay_ms=1.0) as batcher:
      for rows in (1, 3, 6):
        batcher.predict({"x": np.zeros((rows, 2), np.float32)})
      assert sorted(engine_lib.observed_request_rows()) == [1, 3, 6]


# ---------------------------------------------------------------------------
# BucketedEngine over a port predictor (the small critic, CPU).
# ---------------------------------------------------------------------------


def _predictor(seed=0):
  predictor = predictors.CheckpointPredictor(
      model=flagship.make_flagship_model("cpu"), device="cpu")
  predictor.init_randomly(seed)
  return predictor


def _request(predictor, rows, seed):
  return dict(specs.make_random_numpy(predictor.get_feature_specification(),
                                      batch_size=rows, seed=seed))


@pytest.fixture(scope="module")
def warmed_engine():
  predictor = _predictor()
  with metrics_lib.isolated():
    engine = serving.BucketedEngine(predictor=predictor, max_batch_size=8)
    engine.warmup()
  return predictor, engine


class TestBucketedEngine:

  def test_warmup_runs_each_rung_once(self):
    predictor = _predictor()
    with metrics_lib.isolated() as registry:
      engine = serving.BucketedEngine(predictor=predictor, max_batch_size=8)
      assert engine.warm_count == 0
      engine.warmup()
      snap = registry.snapshot()
    assert engine.buckets == [1, 2, 4, 8]
    assert engine.warm_count == 4
    assert snap["counter/serve/engine/warmups"] == 4.0
    assert sorted(engine.warmup_ms) == [1, 2, 4, 8]
    assert all(ms >= 0.0 for ms in engine.warmup_ms.values())
    assert snap["gauge/serve/engine/warmup_ms"] == pytest.approx(
        sum(engine.warmup_ms.values()))

  def test_warmup_is_idempotent(self, warmed_engine):
    _, engine = warmed_engine
    count, ms = engine.warm_count, engine.warmup_ms
    engine.warmup()
    assert engine.warm_count == count and engine.warmup_ms == ms

  def test_zero_rewarms_across_randomized_size_sweep(self, warmed_engine):
    """After warmup, a randomized request-size sweep (padding and
    oversize chunking included) never warms a rung again, and every
    output matches the unbatched predict row for row."""
    predictor, engine = warmed_engine
    rng = np.random.RandomState(0)
    with metrics_lib.isolated() as registry:
      for i in range(40):
        rows = int(rng.randint(1, 20))  # crosses the top bucket too
        request = _request(predictor, rows, seed=i)
        direct = predictor.predict(request)
        bucketed = engine.predict(request)
        assert set(bucketed) == set(direct)
        for key in direct:
          assert bucketed[key].shape == direct[key].shape == (rows, 1)
          np.testing.assert_allclose(bucketed[key], direct[key], rtol=RTOL)
      snap = registry.snapshot()
    assert engine.warm_count == len(engine.buckets)
    assert snap.get("counter/serve/engine/warmups", 0.0) == 0.0
    assert snap["counter/serve/engine/padded_rows"] > 0.0

  def test_the_same_padded_batch_twice_is_bit_identical(self, warmed_engine):
    predictor, engine = warmed_engine
    request = _request(predictor, 5, seed=3)
    first, second = engine.predict(request), engine.predict(request)
    np.testing.assert_array_equal(first["q_predicted"],
                                  second["q_predicted"])

  def test_restore_hot_swap_serves_new_params_without_rewarming(
      self, warmed_engine):
    predictor, engine = warmed_engine
    request = _request(predictor, 3, seed=11)
    before = engine.predict(request)["q_predicted"]
    old = predictor.state
    bump = lambda tree: {k: v + 0.25 for k, v in tree.items()}  # noqa: E731
    try:
      predictor.load_params(bump(old.params), bump(old.ema_params),
                            global_step=7, mutable_state=old.mutable_state)
      assert engine.restore() and engine.global_step == 7
      after = engine.predict(request)["q_predicted"]
      assert engine.warm_count == len(engine.buckets)
      assert not np.allclose(before, after), "state swap not picked up"
      np.testing.assert_allclose(
          after, predictor.predict(request)["q_predicted"], rtol=RTOL)
    finally:
      predictor.load_params(old.params, old.ema_params, global_step=0,
                            mutable_state=old.mutable_state)
      assert predictor.restore()
    np.testing.assert_array_equal(engine.predict(request)["q_predicted"],
                                  before)

  def test_non_batched_outputs_pass_through_unsliced(self):
    """An output whose leading dim is NOT the batch axis passes through
    padding and oversize chunking intact; only outputs shaped like the
    padded batch get sliced. Features are padded on the device by
    repeating row 0."""
    seen = []

    def predict_fn(state, features):
      x = features["x"]
      seen.append(x.clone())
      return {"pred": x * 2.0, "diag": torch.arange(7.0),
              "scalar": torch.tensor(3.0)}

    class _BundlePredictor:
      def serving_bundle(self):
        return predictors.ServingBundle(
            predict_fn=predict_fn, get_state=lambda: None,
            preprocess=lambda f: specs.SpecStruct(
                {k: torch.as_tensor(v) for k, v in f.items()}),
            feature_spec=specs.SpecStruct(
                {"x": specs.TensorSpec(shape=(2,), dtype=np.float32)}))

    engine = serving.BucketedEngine(predictor=_BundlePredictor(),
                                    max_batch_size=4)
    engine.warmup()
    assert engine.warm_count == 3
    for rows in (3, 11):  # padded bucket + oversize chunked
      x = np.arange(rows * 2, dtype=np.float32).reshape(rows, 2)
      seen.clear()
      out = engine.predict({"x": x})
      np.testing.assert_array_equal(out["pred"], x * 2.0)
      np.testing.assert_array_equal(out["diag"], np.arange(7.0))
      assert out["scalar"] == np.float32(3.0)
      # 3 rows -> rung 4; 11 rows -> chunks of 4, 4 and 3 -> rung 4.
      assert [tuple(s.shape) for s in seen] == [(4, 2)] * (1 if rows == 3
                                                            else 3)
    # The last chunk's pad row repeats its row 0 (row 8 of the request).
    np.testing.assert_array_equal(seen[-1].numpy()[3], x[8])

  def test_explicit_buckets(self):
    predictor = _predictor()
    engine = serving.BucketedEngine(predictor=predictor, buckets=[6, 2, 2])
    engine.warmup()
    assert engine.buckets == [2, 6]
    assert engine.warm_count == 2
    request = _request(predictor, 5, seed=1)
    np.testing.assert_allclose(engine.predict(request)["q_predicted"],
                               predictor.predict(request)["q_predicted"],
                               rtol=RTOL)
    with pytest.raises(ValueError):
      serving.BucketedEngine(predictor=predictor, buckets=[0, 2])

  def test_reladder_warms_new_rungs_before_the_swap(self):
    predictor = _predictor()
    with metrics_lib.isolated() as registry:
      engine = serving.BucketedEngine(predictor=predictor, max_batch_size=4)
      engine.warmup()
      engine.reladder([1, 3, 6])
      snap = registry.snapshot()
    assert engine.buckets == [1, 3, 6]
    assert engine.warm_count == 5  # 1, 2, 4 and the new 3, 6
    assert snap["counter/serve/engine/warmups"] == 5.0
    assert snap["counter/serve/engine/reladders"] == 1.0
    request = _request(predictor, 5, seed=2)
    np.testing.assert_allclose(engine.predict(request)["q_predicted"],
                               predictor.predict(request)["q_predicted"],
                               rtol=RTOL)
    assert engine.warm_count == 5

  def test_a_failing_rung_raises(self):
    """No fallback: a rung whose predict raises fails its warmup and
    every later dispatch, and is never counted warm."""

    class _Broken:
      def serving_bundle(self):
        def predict_fn(state, features):
          raise RuntimeError("rung exploded")

        return predictors.ServingBundle(
            predict_fn=predict_fn, get_state=lambda: None,
            preprocess=lambda f: specs.SpecStruct(
                {k: torch.as_tensor(v) for k, v in f.items()}),
            feature_spec=specs.SpecStruct(
                {"x": specs.TensorSpec(shape=(2,), dtype=np.float32)}))

    engine = serving.BucketedEngine(predictor=_Broken(), max_batch_size=2)
    with pytest.raises(RuntimeError, match="rung exploded"):
      engine.warmup()
    assert engine.warm_count == 0
    with pytest.raises(RuntimeError, match="rung exploded"):
      engine.predict({"x": np.zeros((1, 2), np.float32)})

  def test_zero_row_request_raises(self, warmed_engine):
    predictor, engine = warmed_engine
    with pytest.raises(ValueError, match="at least one row"):
      engine.predict(_request(predictor, 0, seed=0))


# ---------------------------------------------------------------------------
# Concurrent forwards: the batcher's worker and bypassing sweeps run the
# same model from two threads at once.
# ---------------------------------------------------------------------------


def _racing(fn, threads: int = 4):
  """Runs fn(i) on `threads` threads at once with a short switch
  interval (more thread switches inside each forward)."""
  import sys

  old = sys.getswitchinterval()
  sys.setswitchinterval(1e-6)
  try:
    workers = [threading.Thread(target=fn, args=(i,))
               for i in range(threads)]
    for t in workers:
      t.start()
    _join(workers)
  finally:
    sys.setswitchinterval(old)


class TestConcurrency:

  def test_concurrent_forwards_of_one_model_match_serial(self):
    """`inference_network_fn` swaps the given parameters into the shared
    module for the call: two threads must never run on each other's (or
    the module's own) parameters."""
    from tensor2robot_tpu_torch.parallel import train_step

    model = flagship.make_flagship_model("cpu")
    states = [train_step.create_train_state(
        model, torch.Generator().manual_seed(s), torch.device("cpu"))
              for s in range(4)]
    features = {k: torch.from_numpy(v) for k, v in specs.make_random_numpy(
        model.get_feature_specification("predict"), batch_size=2,
        seed=0).items()}
    predict = train_step.make_predict_fn(model)
    want = [predict(s, features)["q_predicted"] for s in states]
    assert not torch.equal(want[0], want[1])
    wrong = []

    def run(i):
      for _ in range(50):
        if not torch.equal(predict(states[i], features)["q_predicted"],
                           want[i]):
          wrong.append(i)

    _racing(run)
    assert not wrong, f"{len(wrong)} of 200 forwards ran on other params"

  def test_mixed_probes_and_sweeps_match_eager(self):
    """1-row probes coalesce through the batcher's worker while 24-row
    sweeps bypass it from client threads; every result is the eager
    predict of its own rows."""
    predictor = _predictor()
    engine = serving.BucketedEngine(predictor=predictor, max_batch_size=8)
    engine.warmup()
    results = []
    lock = threading.Lock()
    with serving.MicroBatcher(backend=engine, max_batch_size=8,
                              max_delay_ms=2.0) as batcher:

      def run(i):
        for j in range(6):
          request = _request(predictor, 24 if i == 0 else 1,
                             seed=100 * i + j)
          out = batcher.predict(request)
          with lock:
            results.append((request, out))

      _racing(run)
    assert len(results) == 24
    for request, out in results:
      np.testing.assert_allclose(out["q_predicted"],
                                 predictor.predict(request)["q_predicted"],
                                 rtol=RTOL)
    assert engine.warm_count == len(engine.buckets)


# ---------------------------------------------------------------------------
# MicroBatcher semantics over a numpy backend.
# ---------------------------------------------------------------------------


class _NumpyBackend:
  """Row-wise deterministic function with dispatch accounting."""

  def __init__(self, delay_s: float = 0.0):
    self.delay_s = delay_s
    self.batches = []  # row count per dispatch
    self.seen_rows = []  # first column of every served row

  def __call__(self, features):
    x = np.asarray(features["x"])
    self.batches.append(x.shape[0])
    self.seen_rows.extend(x[:, 0].tolist())
    if self.delay_s:
      time.sleep(self.delay_s)
    return {"out": x * 2.0, "scalar": np.float32(7.0)}


class TestMicroBatcherSemantics:

  def test_concurrent_requests_coalesce_and_split_exactly(self):
    backend = _NumpyBackend()
    with metrics_lib.isolated() as registry, \
        serving.MicroBatcher(backend=backend, max_batch_size=8,
                             max_delay_ms=20.0) as batcher:
      results = {}

      def client(i):
        x = np.array([[float(i), -float(i)]], np.float32)
        results[i] = batcher.predict({"x": x})

      threads = [threading.Thread(target=client, args=(i,))
                 for i in range(16)]
      for t in threads:
        t.start()
      _join(threads)
      snap = registry.snapshot()
    assert sorted(results) == list(range(16))
    for i, out in results.items():
      np.testing.assert_array_equal(
          out["out"], np.array([[2.0 * i, -2.0 * i]], np.float32))
      assert out["scalar"] == np.float32(7.0)
    assert len(backend.batches) < 16
    assert max(backend.batches) > 1
    assert sum(backend.batches) == 16
    assert snap["counter/serve/batcher/requests"] == 16.0
    assert snap["counter/serve/batcher/batches"] == len(backend.batches)
    assert snap["hist/serve/batch_rows/max"] == max(backend.batches)
    assert snap["hist/serve/request_ms/count"] == 16.0

  def test_partial_batch_flushes_at_max_delay(self):
    backend = _NumpyBackend()
    with serving.MicroBatcher(backend=backend, max_batch_size=8,
                              max_delay_ms=30.0) as batcher:
      start = time.monotonic()
      out = batcher.predict({"x": np.ones((1, 2), np.float32)})
      elapsed = time.monotonic() - start
    np.testing.assert_array_equal(out["out"],
                                  np.full((1, 2), 2.0, np.float32))
    assert backend.batches == [1]  # served alone, not starved forever
    assert elapsed < 5.0

  def test_deadline_expiry_sheds_unserved(self):
    backend = _NumpyBackend(delay_s=0.25)
    with metrics_lib.isolated() as registry, \
        serving.MicroBatcher(backend=backend, max_batch_size=2,
                             max_delay_ms=1.0) as batcher:
      # Occupy the worker with a slow dispatch...
      blocker = threading.Thread(
          target=lambda: batcher.predict(
              {"x": np.zeros((2, 2), np.float32)}))
      blocker.start()
      time.sleep(0.05)  # worker is now inside the 250 ms dispatch
      # ...then enqueue a request whose deadline expires meanwhile.
      with pytest.raises(serving.DeadlineError):
        batcher.predict({"x": np.full((1, 2), 5.0, np.float32)},
                        deadline_ms=10.0)
      _join([blocker])
      snap = registry.snapshot()
    assert 5.0 not in backend.seen_rows
    assert snap["counter/serve/batcher/shed_deadline"] == 1.0

  def test_default_deadline_applies(self):
    backend = _NumpyBackend(delay_s=0.25)
    with serving.MicroBatcher(backend=backend, max_batch_size=1,
                              max_delay_ms=1.0,
                              default_deadline_ms=10.0) as batcher:
      blocker = threading.Thread(
          target=lambda: batcher.predict(
              {"x": np.zeros((1, 2), np.float32)}))
      blocker.start()
      time.sleep(0.05)
      with pytest.raises(serving.DeadlineError):
        batcher.predict({"x": np.full((1, 2), 5.0, np.float32)})
      _join([blocker])
    assert 5.0 not in backend.seen_rows

  def test_queue_full_sheds_immediately(self):
    backend = _NumpyBackend(delay_s=0.3)
    with metrics_lib.isolated() as registry, \
        serving.MicroBatcher(backend=backend, max_batch_size=1,
                             max_delay_ms=1.0, max_queue=2) as batcher:
      threads = []
      errors = []

      def client(i):
        try:
          batcher.predict({"x": np.full((1, 2), float(i), np.float32)})
        except serving.ShedError as e:
          errors.append(e)

      for i in range(8):
        threads.append(threading.Thread(target=client, args=(i,)))
        threads[-1].start()
      _join(threads)
      snap = registry.snapshot()
    assert errors, "a bounded queue under overload must shed"
    assert snap["counter/serve/batcher/shed_queue_full"] == len(errors)

  def test_oversize_request_bypasses_coalescing_and_deadlines(self):
    backend = _NumpyBackend()
    with metrics_lib.isolated() as registry, \
        serving.MicroBatcher(backend=backend, max_batch_size=4) as batcher:
      x = np.arange(24, dtype=np.float32).reshape(12, 2)
      # The bypass never checks a deadline, even an already-expired one.
      out = batcher.predict({"x": x}, deadline_ms=1e-9)
      snap = registry.snapshot()
    np.testing.assert_array_equal(out["out"], x * 2.0)
    assert backend.batches == [12]
    assert snap["counter/serve/batcher/bypass"] == 1.0

  def test_inconsistent_leading_dims_rejected(self):
    with serving.MicroBatcher(backend=_NumpyBackend()) as batcher:
      with pytest.raises(ValueError, match="inconsistent leading dims"):
        batcher.predict({"x": np.zeros((2, 2), np.float32),
                         "y": np.zeros((3, 2), np.float32)})
      with pytest.raises(ValueError, match="no leading batch dim"):
        batcher.predict({"x": np.float32(1.0)})

  def test_backend_error_propagates_to_every_caller(self):
    def broken(features):
      raise RuntimeError("backend exploded")

    with serving.MicroBatcher(backend=broken, max_delay_ms=20.0) as batcher:
      errors = []

      def client():
        try:
          batcher.predict({"x": np.zeros((1, 2), np.float32)})
        except RuntimeError as e:
          errors.append(str(e))

      threads = [threading.Thread(target=client) for _ in range(4)]
      for t in threads:
        t.start()
      _join(threads)
      assert errors == ["backend exploded"] * 4
      # The worker survives a backend error and serves the next request.
      with pytest.raises(RuntimeError, match="backend exploded"):
        batcher.predict({"x": np.zeros((1, 2), np.float32)})


class TestMicroBatcherShutdown:
  """The worker is JOINED, never abandoned."""

  def test_close_joins_worker_and_rejects_new_requests(self):
    batcher = serving.MicroBatcher(backend=_NumpyBackend())
    batcher.predict({"x": np.zeros((1, 2), np.float32)})
    batcher.close()
    assert not batcher._worker.is_alive(), "worker must be joined"
    with pytest.raises(serving.ShutdownError):
      batcher.predict({"x": np.zeros((1, 2), np.float32)})
    with pytest.raises(serving.ShutdownError):  # the bypass too
      batcher.predict({"x": np.zeros((20, 2), np.float32)})
    batcher.close()  # idempotent

  def test_close_waits_out_inflight_dispatch(self):
    """A close() racing a dispatch waits for the backend call to finish;
    the in-flight request still completes successfully."""
    backend = _NumpyBackend(delay_s=0.4)
    batcher = serving.MicroBatcher(backend=backend, max_delay_ms=1.0)
    result = {}

    def client():
      result["out"] = batcher.predict(
          {"x": np.ones((1, 2), np.float32)})

    thread = threading.Thread(target=client)
    thread.start()
    time.sleep(0.1)  # worker is mid-dispatch now
    assert batcher._phase[0] == "dispatch"
    batcher.close()
    assert not batcher._worker.is_alive()
    _join([thread])
    np.testing.assert_array_equal(result["out"]["out"],
                                  np.full((1, 2), 2.0, np.float32))

  def test_close_fails_queued_requests_with_shutdown_error(self):
    backend = _NumpyBackend(delay_s=0.3)
    batcher = serving.MicroBatcher(backend=backend, max_batch_size=1,
                                   max_delay_ms=1.0, max_queue=16)
    outcomes = []

    def client(i):
      try:
        batcher.predict({"x": np.full((1, 2), float(i), np.float32)})
        outcomes.append("served")
      except serving.ShutdownError:
        outcomes.append("shutdown")

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(6)]
    for t in threads:
      t.start()
    time.sleep(0.1)  # first dispatch in flight, the rest queued
    batcher.close()
    _join(threads)
    assert not batcher._worker.is_alive()
    assert len(outcomes) == 6
    assert "shutdown" in outcomes, "queued requests must fail, not hang"
    assert "served" in outcomes, "the in-flight request must complete"


# ---------------------------------------------------------------------------
# Load generator.
# ---------------------------------------------------------------------------


class TestLoadgen:

  def test_run_load_counts_and_errors(self):
    calls = []
    lock = threading.Lock()

    def predict(features):
      with lock:
        calls.append(1)
        n = len(calls)
      if n == 3:
        raise RuntimeError("transient")
      return {"out": features["x"]}

    result = loadgen.run_load(predict,
                              lambda i: {"x": np.zeros((1, 1))},
                              concurrency=2, requests_per_thread=5)
    assert result["requests"] == 10
    assert result["ok"] == 9
    assert result["errors"] == {"RuntimeError": 1}
    assert result["qps"] > 0

  def test_run_load_passes_deadlines_and_counts_sheds(self):
    backend = _NumpyBackend(delay_s=0.05)
    with serving.MicroBatcher(backend=backend, max_batch_size=1,
                              max_delay_ms=1.0, max_queue=1) as batcher:
      result = loadgen.run_load(
          batcher.predict, lambda i: {"x": np.full((1, 2), float(i))},
          concurrency=6, requests_per_thread=3, deadline_ms=1000.0)
    assert result["ok"] + sum(result["errors"].values()) == 18
    assert set(result["errors"]) <= {"ShedError", "DeadlineError"}

  def test_latency_percentiles_from_registry(self):
    with metrics_lib.isolated():
      hist = metrics_lib.histogram("serve/request_ms")
      for v in [1.0, 2.0, 3.0, 100.0]:
        hist.record(v)
      stats = loadgen.latency_percentiles()
      assert stats["count"] == 4.0
      assert stats["p50"] == pytest.approx(2.5)
      assert stats["p99"] <= 100.0
    assert loadgen.latency_percentiles("serve/empty") == {}

  @pytest.mark.parametrize("profile", loadgen.ARRIVAL_PROFILES)
  def test_arrival_gaps_equal_jax(self, profile):
    for seed in (0, 3):
      np.testing.assert_array_equal(
          loadgen.arrival_gaps(200, 50.0, profile=profile, seed=seed),
          jax_loadgen.arrival_gaps(200, 50.0, profile=profile, seed=seed))
    with pytest.raises(ValueError):
      loadgen.arrival_gaps(0, 50.0, profile=profile)


# ---------------------------------------------------------------------------
# The serving stack in front of a policy, and its config.
# ---------------------------------------------------------------------------


class TestPolicyIntegration:

  def test_policy_restore_warms_serving_stack_and_serves(self):
    source = _predictor(seed=3)
    predictor = predictors.CheckpointPredictor(
        model=flagship.make_flagship_model("cpu"), device="cpu")
    state = source.state
    predictor.load_params(state.params, state.ema_params, global_step=5,
                          mutable_state=state.mutable_state)
    engine = serving.BucketedEngine(predictor=predictor, max_batch_size=4)
    with serving.MicroBatcher(backend=engine, max_delay_ms=2.0) as batcher:
      policy = policies.CEMPolicy(predictor=batcher, action_size=4,
                                  cem_samples=8, cem_iterations=2,
                                  cem_elites=3, seed=0)
      assert policy.restore()
      # restore() warmed every rung BEFORE the first action.
      assert engine.warm_count == len(engine.buckets) == 3
      assert policy.global_step == 5
      image = _request(predictor, 1, seed=4)["state/image"][0]
      action = policy.select_action({"image": image})
      assert action.shape == (4,) and np.all(np.abs(action) <= 1.0)
      assert engine.warm_count == 3
      rescored = predictor.predict({"state/image": image[None],
                                    "action/action": action[None]})
      assert policy.last_q_value == pytest.approx(
          float(rescored["q_predicted"][0, 0]), rel=RTOL)
      np.random.seed(0)
      explored = policy.select_action({"image": image}, explore_prob=1.0)
      assert policy.last_q_value is None
      assert np.all(np.abs(explored) <= 1.0)


def test_serve_config_binds_the_batching_policy():
  import pathlib

  path = (pathlib.Path(__file__).resolve().parent.parent
          / "tensor2robot_tpu_torch" / "configs" / "serve_qtopt.gin")
  try:
    config.parse_config_file(str(path))
    engine = serving.BucketedEngine(predictor=_predictor())
    assert engine.buckets == [1, 2, 4, 8, 16]
    batcher = serving.MicroBatcher(backend=_NumpyBackend())
    try:
      assert (batcher._max_batch_size, batcher._max_delay_s,
              batcher._max_queue, batcher._default_deadline_ms) == (
                  16, 0.002, 128, 33.0)
    finally:
      batcher.close()
  finally:
    config.clear_config()
