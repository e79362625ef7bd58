"""The data plane under injected faults: the port against the JAX package.

The JAX package's `TestDataDegradation` cases (the corrupt-record quota
of `RecordBatchPipeline`), each run on both packages' pipelines over the
same record files under the same `FaultPlan`: strict mode raises on a
corrupt record; under a quota, corrupt batches are skipped on the serial
and the overlapped chains with the same `data/*_skipped` counters; a
quota of one batch raises at the second corrupt batch; a source I/O
error ends the epoch, is counted in `data/source_io_errors` and charges
no corruption counter; and with no plan the quota changes no batch. The
batches both packages yield are equal.
"""

from __future__ import annotations

import itertools
import os

import numpy as np
import pytest

from tensor2robot_tpu.data import parsing as jax_parsing
from tensor2robot_tpu.data import pipeline as jax_pipeline
from tensor2robot_tpu import specs as jax_specs
from tensor2robot_tpu.obs import faultlab as jax_faultlab
from tensor2robot_tpu.obs import metrics as jax_metrics
from tensor2robot_tpu_torch import specs
from tensor2robot_tpu_torch.data import codec
from tensor2robot_tpu_torch.data import parsing
from tensor2robot_tpu_torch.data import pipeline
from tensor2robot_tpu_torch.data import tfrecord
from tensor2robot_tpu_torch.obs import faultlab
from tensor2robot_tpu_torch.obs import metrics

# {which: (specs, parsing, pipeline, faultlab, metrics)}
PACKAGES = {
    "port": (specs, parsing, pipeline, faultlab, metrics),
    "jax": (jax_specs, jax_parsing, jax_pipeline, jax_faultlab,
            jax_metrics),
}


FAULT_COUNTERS = ("counter/data/corrupt_batches_skipped",
                  "counter/data/corrupt_records_skipped",
                  "counter/data/source_io_errors")


def _spec(specs_lib):
  return specs_lib.SpecStruct({
      "pose": specs_lib.TensorSpec(shape=(4,), dtype=np.float32,
                                   name="pose"),
      "label": specs_lib.TensorSpec(shape=(1,), dtype=np.int64,
                                    name="label"),
  })


@pytest.fixture
def patterns(tmp_path):
  """3 files of 40 records (the JAX test's), written once for both."""
  spec = _spec(specs)
  rng = np.random.RandomState(0)
  for shard in range(3):
    path = os.path.join(str(tmp_path), f"rec-{shard:03d}.tfr")
    with tfrecord.RecordWriter(path) as writer:
      for _ in range(40):
        writer.write(codec.encode_example(
            {"pose": rng.randn(4).astype(np.float32),
             "label": rng.randint(0, 2, (1,), np.int64)}, spec))
  return os.path.join(str(tmp_path), "rec-*.tfr")


def _pipe(which, patterns, **kwargs):
  specs_lib, parsing_lib, pipeline_lib = PACKAGES[which][:3]
  kwargs.setdefault("batch_size", 8)
  kwargs.setdefault("mode", "train")
  kwargs.setdefault("shuffle_buffer_size", 16)
  kwargs.setdefault("seed", 3)
  return pipeline_lib.RecordBatchPipeline(
      patterns, parsing_lib.create_parse_fn(_spec(specs_lib)), **kwargs)


def _plan(which, specs_kwargs, seed=0):
  lib = PACKAGES[which][3]
  return lib.FaultPlan([lib.FaultSpec(**kw) for kw in specs_kwargs],
                       seed=seed)


def _take(which, patterns, plan_specs, n, seed=0, **kwargs):
  """n batches under the plan: (poses, the fault counters) or the
  error's type name. Staging counters (how far ahead an overlapped chain
  ran) depend on thread timing and are left out."""
  metrics_lib = PACKAGES[which][4]
  pipe = _pipe(which, patterns, **kwargs)
  with _plan(which, plan_specs, seed).activated(), \
      metrics_lib.isolated() as registry:
    stream = iter(pipe)
    try:
      batches = [next(stream) for _ in range(n)]
    except Exception as e:  # noqa: BLE001 - the outcome under test
      return type(e).__name__
    finally:
      if hasattr(stream, "close"):
        stream.close()
    snap = registry.snapshot(prefix="data/")
  return ([np.asarray(b["features/pose"]) for b in batches],
          {k: v for k, v in snap.items() if k in FAULT_COUNTERS})


def _assert_same(port, jax):
  assert isinstance(port, tuple) and isinstance(jax, tuple), (port, jax)
  assert len(port[0]) == len(jax[0])
  for a, b in zip(port[0], jax[0]):
    np.testing.assert_array_equal(a, b)
  assert port[1] == jax[1]


def test_strict_mode_raises_on_corrupt_record(patterns):
  for which in PACKAGES:
    out = _take(which, patterns,
                [dict(point="data.corrupt_record", at=(1,))], 5,
                prefetch_size=0, overlap=False, num_parallel_parses=1)
    assert isinstance(out, str), (which, out)


@pytest.mark.parametrize("overlap", [False, True])
def test_corrupt_batches_skipped_under_quota(patterns, overlap):
  plan = [dict(point="data.corrupt_record", every=4, count=2),
          dict(point="data.preprocess", at=(9,), count=1)]
  out = {which: _take(which, patterns, plan, 12, seed=1, overlap=overlap,
                      prefetch_size=2 if overlap else 0,
                      num_parallel_parses=2, max_corrupt_records=64)
         for which in PACKAGES}
  _assert_same(out["port"], out["jax"])
  poses, counters = out["port"]
  assert len(poses) == 12 and all(p.shape == (8, 4) for p in poses)
  assert counters["counter/data/corrupt_batches_skipped"] == 3.0
  assert counters["counter/data/corrupt_records_skipped"] == 24.0


def test_quota_exceeded_raises(patterns):
  # A quota of one batch's worth: the second corrupt batch must raise.
  out = {which: _take(which, patterns,
                      [dict(point="data.corrupt_record", every=2)], 12,
                      overlap=False, prefetch_size=0,
                      num_parallel_parses=1, max_corrupt_records=8)
         for which in PACKAGES}
  assert isinstance(out["port"], str) and isinstance(out["jax"], str), out


def test_source_io_error_ends_epoch_and_continues(patterns):
  out = {which: _take(which, patterns,
                      [dict(point="data.record_io", at=(20,), count=1)],
                      20, overlap=False, prefetch_size=0,
                      num_parallel_parses=1, use_native_stager=False,
                      max_corrupt_records=64)
         for which in PACKAGES}
  _assert_same(out["port"], out["jax"])
  poses, counters = out["port"]
  assert len(poses) == 20  # crosses the epoch cut
  # An I/O flake is charged against the quota but is NOT corruption.
  assert counters == {"counter/data/source_io_errors": 1.0}


def test_no_quota_no_behavior_change(patterns):
  """With the quota off and no plan active, the chain is untouched."""
  for which in PACKAGES:
    a, b = (list(itertools.islice(iter(_pipe(
        which, patterns, overlap=False, prefetch_size=0,
        num_parallel_parses=1, repeat=False, **quota)), 5))
            for quota in ({}, {"max_corrupt_records": 64}))
    for batch_a, batch_b in zip(a, b):
      np.testing.assert_array_equal(batch_a["features/pose"],
                                    batch_b["features/pose"])
  port, jax = (list(itertools.islice(iter(_pipe(
      which, patterns, overlap=False, prefetch_size=0,
      num_parallel_parses=1, repeat=False)), 5)) for which in PACKAGES)
  assert len(port) == len(jax) == 5
  for batch_a, batch_b in zip(port, jax):
    np.testing.assert_array_equal(np.asarray(batch_a["features/pose"]),
                                  np.asarray(batch_b["features/pose"]))
