"""The port's `OverlappedLoader` and `DevicePrefetcher` on the CPU.

* `OverlappedLoader`: batches come out in source order whatever the
  parse threads' timing, fused or not; a stage's error is raised again
  in the consumer; `close()` joins every stage thread; an abandoned
  loader's threads stop; the output queue admits one over-cap batch.
* `DevicePrefetcher` on device 'cpu' (threads and queues, no page-locked
  buffers): order kept, `max_batches` taken and no more, errors raised
  again, `close()` joins its threads and closes its source, an abandoned
  prefetcher's threads stop; without a card it raises unless asked for
  the CPU.
* The native call counters under many threads (no lost update), and the
  retry ladder a stalled source's close waits on.
"""

import gc
import itertools
import random
import sys
import threading
import time

import numpy as np
import pytest
import torch

from tensor2robot_tpu_torch import native, specs
from tensor2robot_tpu_torch.data import overlap
from tensor2robot_tpu_torch.parallel import mesh
from tensor2robot_tpu_torch.utils import retry

torch.set_num_threads(1)

STAGE_THREADS = ("overlap-", "device-prefetch")


def _stage_threads():
  return [t for t in threading.enumerate() if t.name.startswith(STAGE_THREADS)]


def _wait_no_stage_threads(timeout=5.0):
  deadline = time.monotonic() + timeout
  while _stage_threads() and time.monotonic() < deadline:
    time.sleep(0.02)
  return _stage_threads()


def _jittered_parse(i):
  time.sleep(random.Random(i).uniform(0, 0.004))
  return {"x": np.full((2,), i, np.int64)}


def _batch(i):
  return specs.SpecStruct({
      "features/x": torch.full((3,), float(i)),
      "labels/y": torch.tensor([i])})


@pytest.mark.parametrize("fused", [True, False])
def test_loader_keeps_source_order(fused):
  with overlap.OverlappedLoader(iter(range(40)), _jittered_parse,
                                lambda b: {"x": b["x"] * 2}, parse_workers=4,
                                fuse_preprocess=fused) as loader:
    got = [int(b["x"][0]) for b in loader]
  assert got == [2 * i for i in range(40)]
  assert not _wait_no_stage_threads(0.0)


@pytest.mark.parametrize("stage", ["parse", "preprocess", "source"])
def test_loader_raises_a_stage_error_in_the_consumer(stage):
  def source():
    for i in range(10):
      if stage == "source" and i == 3:
        raise IOError("bad source")
      yield i

  def fail_at_3(name):
    def fn(item):
      value = item if name == "parse" else int(item["x"][0])
      if stage == name and value == 3:
        raise ValueError(f"bad {name}")
      return {"x": np.array([value])} if name == "parse" else item
    return fn

  loader = overlap.OverlappedLoader(source(), fail_at_3("parse"),
                                    fail_at_3("preprocess"))
  got = []
  with pytest.raises((ValueError, IOError), match="bad"):
    for batch in loader:
      got.append(int(batch["x"][0]))
  assert got == [0, 1, 2]
  assert not _wait_no_stage_threads(0.0)


def test_loader_close_joins_and_abandoned_loader_stops():
  loader = overlap.OverlappedLoader(itertools.count(), _jittered_parse,
                                    lambda b: b, parse_workers=3)
  assert next(loader)["x"][0] == 0
  assert _stage_threads()
  loader.close()
  assert not _stage_threads()  # close() joined every stage
  loader = overlap.OverlappedLoader(itertools.count(), _jittered_parse,
                                    lambda b: b, parse_workers=3)
  next(loader)
  del loader
  gc.collect()
  assert not _wait_no_stage_threads()


def test_loader_queue_admits_one_over_cap_batch():
  big = lambda i: {"x": np.zeros((1 << 20,), np.uint8) + i}  # noqa: E731
  with overlap.OverlappedLoader(iter(range(4)), big, lambda b: b,
                                max_bytes=1000) as loader:
    assert [int(b["x"][0]) for b in loader] == [0, 1, 2, 3]
  assert overlap.batch_nbytes({"a": np.zeros(5, np.float32),
                               "b": {"c": torch.zeros(2, 3)}}) == 20 + 24


def test_prefetcher_keeps_order_and_max_batches():
  taken = []

  def source():
    for i in itertools.count():
      taken.append(i)
      yield _batch(i)

  prefetcher = mesh.DevicePrefetcher(source(), "cpu", depth=2, max_batches=7)
  got = [(int(f["x"][0]), int(l["y"][0])) for f, l in prefetcher]
  assert got == [(i, i) for i in range(7)]
  assert taken == list(range(7))
  assert prefetcher.stream is None and prefetcher.copy_ms() == []
  assert not _wait_no_stage_threads(0.0)


def test_prefetcher_places_like_place_batch_and_empty_labels():
  features, labels = mesh.place_batch("cpu", {"features": {"x": torch.ones(2)}})
  assert torch.equal(features["x"], torch.ones(2)) and len(labels) == 0
  with mesh.DevicePrefetcher(iter([{"features": {"x": torch.ones(2)}}]),
                             "cpu") as prefetcher:
    (f, l), = list(prefetcher)
  assert torch.equal(f["x"], torch.ones(2)) and len(l) == 0


def test_prefetcher_raises_a_source_error_in_the_consumer():
  def source():
    yield _batch(0)
    raise IOError("source broke")

  prefetcher = mesh.DevicePrefetcher(source(), "cpu")
  assert int(next(prefetcher)[0]["x"][0]) == 0
  with pytest.raises(IOError, match="source broke"):
    next(prefetcher)
  assert not _wait_no_stage_threads(0.0)


def test_prefetcher_close_closes_its_loader_and_abandoned_one_stops():
  loader = overlap.OverlappedLoader(itertools.count(), _batch, lambda b: b)
  prefetcher = mesh.DevicePrefetcher(loader, "cpu", close_source=True)
  next(prefetcher)
  prefetcher.close()
  assert not _stage_threads()  # the loader's stages joined too
  prefetcher = mesh.DevicePrefetcher((_batch(i) for i in itertools.count()),
                                     "cpu")
  next(prefetcher)
  del prefetcher
  gc.collect()
  assert not _wait_no_stage_threads()


def test_prefetcher_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
  monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
  with pytest.raises(RuntimeError, match="no CUDA device"):
    mesh.DevicePrefetcher(iter([]))
  with pytest.raises(ValueError, match="depth"):
    mesh.DevicePrefetcher(iter([]), "cpu", depth=0)


def test_native_counters_lose_no_update_under_many_threads():
  counters = native.Counters()
  interval = sys.getswitchinterval()
  sys.setswitchinterval(1e-6)
  try:
    threads = [threading.Thread(target=lambda: [
        counters.add("jpeg_images", 3) for _ in range(2000)])
               for _ in range(16)]
    for t in threads:
      t.start()
    for t in threads:
      t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
  finally:
    sys.setswitchinterval(interval)
  assert counters.as_dict() == {"stager_batches": 0, "parser_batches": 0,
                                "jpeg_images": 16 * 2000 * 3}


def test_retry_ladder_sums_to_the_close_timeout():
  policy = retry.RetryPolicy(name="t", max_attempts=8, base_delay_s=1 / 64,
                             multiplier=2.0, max_delay_s=1 / 4, jitter=0.0,
                             deadline_s=1.0, clock=lambda: 0.0)
  assert policy.backoff_s(0) + sum(policy.delays()) == pytest.approx(1.0)
  calls = []

  def flaky():
    calls.append(1)
    if len(calls) < 3:
      raise IOError("again")
    return "ok"

  sleeps = []
  assert retry.RetryPolicy(max_attempts=5, sleep=sleeps.append,
                           rng=random.Random(0)).call(flaky) == "ok"
  assert len(calls) == 3 and len(sleeps) == 2
  with pytest.raises(retry.RetryBudgetExhausted):
    retry.RetryPolicy(max_attempts=2, sleep=lambda s: None).call(
        lambda: (_ for _ in ()).throw(IOError("never")))
