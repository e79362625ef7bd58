"""Pipelined host loader: parse -> preprocess as overlapped stages.

The port's copy of `tensor2robot_tpu.data.overlap`. The record chain's
per-batch Python work (arena parsing, image decode, preprocessing) runs
as explicit overlapped stages with bounded, stop-aware hand-off queues
instead of on the thread that iterates the pipeline:

  raw source (stager arena / record-tuple batches)   [feeder thread]
    -> parse pool (ordered, `parse_workers` threads) [bounded futures]
    -> preprocess (one worker: stateful or seeded preprocessors keep
       their consumption order)                      [assembler thread]
    -> byte-capped output queue                      [consumer]

With `fuse_preprocess=True` preprocess moves into the parse pool: each
pooled task runs parse and preprocess back to back, and the assembler
only unwraps futures in submission order. For a pure per-batch
preprocess fn (the `AbstractPreprocessor` contract) the output is
byte-identical to the serial-worker chain; a preprocess fn with
cross-batch state keeps the serial worker (`RecordBatchPipeline` gates
on the declared purity).

Output order is the raw-batch order (futures are queued in submission
order and consumed FIFO), so the loader is byte-identical to the serial
chain over the same record stream. The device-side consumer is
`parallel.mesh.DevicePrefetcher`.

Thread discipline: `close()` joins every stage thread (feeder, pool,
assembler), the loader is a context manager, and a `weakref.finalize`
backstop stops the stages of a collected-but-unclosed instance (the
workers close over locals, never `self`, so an abandoned loader is
collectable).

Telemetry (pipeline batches, in the port's metrics registry):
  data/overlap_source_ms      feeder wait on the raw source per batch
  data/overlap_parse_ms       parse time per batch inside the pool
  data/overlap_preprocess_ms  preprocess time per batch
  data/overlap_wait_ms        consumer dequeue wait (0 in steady state =
                              the loader outruns the consumer)
  data/overlap_parse_queue_depth   in-flight parse futures
  data/overlap_out_queue_depth     preprocessed batches ready
  data/overlap_out_bytes           bytes held in the output queue
  data/overlap_batches             batches handed to the consumer
"""

from __future__ import annotations

import logging
import threading
import time
import weakref
from typing import Any, Callable, Iterator, List, Optional

from tensor2robot_tpu_torch.obs import metrics as obs_metrics

__all__ = ["OverlappedLoader", "batch_nbytes", "DEFAULT_QUEUE_BYTES"]

_log = logging.getLogger(__name__)

# Default byte cap for the preprocessed-batch output queue. Generous for
# smoke batches (a 64x472x472x3 f32 image batch is ~170 MB — ONE such
# batch still flows: a byte-capped queue always admits an item when
# empty) while bounding host RSS to O(depth) typical batches.
DEFAULT_QUEUE_BYTES = 256 << 20  # 256 MiB

# Consumer-side wait observations buffered per `record_many` flush.
_FLUSH_EVERY = 64


def batch_nbytes(batch: Any) -> int:
  """Payload bytes of one host batch (numpy or tensor leaves; 0 for
  unknowns)."""
  total = 0
  items = batch.items() if hasattr(batch, "items") else ()
  for _, value in items:
    if hasattr(value, "items"):
      total += batch_nbytes(value)
    else:
      total += int(getattr(value, "nbytes", 0) or 0)
  return total


class _ByteBoundedQueue:
  """Bounded FIFO hand-off queue: item count AND payload bytes.

  `put` blocks while the queue is at its item cap or would exceed the
  byte cap — but ALWAYS admits an item into an empty queue, so one
  over-cap batch flows alone instead of deadlocking (the same rule as
  the native stager's reader queues). Both `put` and `get` watch a stop
  event at 0.1 s granularity so an abandoned producer/consumer never
  blocks forever.
  """

  def __init__(self, max_items: int, max_bytes: int = 0):
    self._max_items = max(int(max_items), 1)
    self._max_bytes = max(int(max_bytes), 0)
    self._items: List[Any] = []
    self._sizes: List[int] = []
    self._bytes = 0
    self._cond = threading.Condition()

  def _full_for(self, nbytes: int) -> bool:
    if not self._items:
      return False  # empty queue always admits (over-cap items flow)
    if len(self._items) >= self._max_items:
      return True
    return bool(self._max_bytes) and self._bytes + nbytes > self._max_bytes

  def put(self, item: Any, nbytes: int, stop: threading.Event) -> bool:
    """Enqueues `item`; returns False if `stop` was set while waiting."""
    with self._cond:
      while self._full_for(nbytes):
        if stop.is_set():
          return False
        self._cond.wait(timeout=0.1)
      if stop.is_set():
        return False
      self._items.append(item)
      self._sizes.append(int(nbytes))
      self._bytes += int(nbytes)
      self._cond.notify_all()
      return True

  def get(self, stop: Optional[threading.Event] = None) -> Any:
    """Dequeues the oldest item; with `stop`, returns None once set and
    the queue is empty (producer died without a sentinel)."""
    with self._cond:
      while not self._items:
        if stop is not None and stop.is_set():
          return None
        self._cond.wait(timeout=0.1)
      item = self._items.pop(0)
      self._bytes -= self._sizes.pop(0)
      self._cond.notify_all()
      return item

  def depth(self) -> int:
    with self._cond:
      return len(self._items)

  def nbytes(self) -> int:
    with self._cond:
      return self._bytes


class OverlappedLoader:
  """Iterator of preprocessed host batches, produced by pipelined
  stages (see module docstring for the stage graph and telemetry).

  `raw` is any iterator of raw batches (stager arenas or record-tuple
  lists); `parse_fn(raw_batch)` and `preprocess_fn(parsed)` are the
  pipeline's own per-batch callables. Exceptions in any stage re-raise
  in the consumer with the stages stopped. Exhaustion closes the loader
  (all threads joined); `close()` is idempotent and MANDATORY for
  abandoning consumers — the context-manager protocol closes on exit,
  and a `weakref.finalize` backstop stops (but cannot join, illegal
  from GC) the stages of a collected instance.
  """

  _END = object()
  # A batch dropped by `skip_batch_on_error` (the pipeline's corrupt-
  # record quota): flows through the futures queue so ordering is
  # untouched, filtered before the output queue.
  _SKIPPED = object()

  def __init__(self,
               raw: Iterator[Any],
               parse_fn: Callable[[Any], Any],
               preprocess_fn: Callable[[Any], Any],
               parse_workers: int = 2,
               depth: int = 2,
               max_bytes: int = DEFAULT_QUEUE_BYTES,
               telemetry: bool = True,
               fuse_preprocess: bool = False,
               skip_batch_on_error: Optional[
                   Callable[[BaseException], bool]] = None):
    from concurrent.futures import ThreadPoolExecutor

    parse_workers = max(int(parse_workers), 1)
    depth = max(int(depth), 1)
    stop = threading.Event()
    # Futures hand-off: bounded at 2x the pool so the feeder stays at
    # most one pool's worth of batches ahead of the assembler (in-flight
    # raw arenas are byte-bounded upstream by the stager's own caps).
    parse_q = _ByteBoundedQueue(max_items=max(2 * parse_workers, depth))
    out_q = _ByteBoundedQueue(max_items=depth, max_bytes=max_bytes)
    pool = ThreadPoolExecutor(parse_workers,
                              thread_name_prefix="overlap-parse")
    end = self._END

    if telemetry:
      source_hist = obs_metrics.histogram("data/overlap_source_ms")
      parse_hist = obs_metrics.histogram("data/overlap_parse_ms")
      preprocess_hist = obs_metrics.histogram("data/overlap_preprocess_ms")
      parse_depth_gauge = obs_metrics.gauge("data/overlap_parse_queue_depth")
      out_depth_gauge = obs_metrics.gauge("data/overlap_out_queue_depth")
      out_bytes_gauge = obs_metrics.gauge("data/overlap_out_bytes")
    perf_counter_ns = time.perf_counter_ns

    skipped = self._SKIPPED

    def _absorb(e: BaseException) -> bool:
      """Corrupt-record quota hook: True = drop this batch and continue."""
      if skip_batch_on_error is None or isinstance(
          e, (KeyboardInterrupt, SystemExit)):
        return False
      try:
        return bool(skip_batch_on_error(e))
      except Exception:  # noqa: BLE001 - a broken hook must not mask `e`
        return False

    def _timed_parse(item):
      t0 = perf_counter_ns()
      try:
        out = parse_fn(item)
        if telemetry:
          parse_hist.record((perf_counter_ns() - t0) * 1e-6)
        if fuse_preprocess:
          # Fused mode (module docstring): preprocess runs HERE, on the
          # pool thread, immediately after its own batch's parse — the
          # per-stage telemetry split is preserved so attribution in
          # runs.jsonl reads the same either way.
          t0 = perf_counter_ns()
          out = preprocess_fn(out)
          if telemetry:
            preprocess_hist.record((perf_counter_ns() - t0) * 1e-6)
      except BaseException as e:  # noqa: BLE001 - quota decides
        if _absorb(e):
          return skipped
        raise
      return out

    # Stage threads close over locals ONLY — never `self` — so an
    # abandoned-without-close() loader is collectable and the finalizer
    # below can actually fire (the DevicePrefetcher discipline).
    def _feeder():
      try:
        while not stop.is_set():
          t0 = perf_counter_ns()
          try:
            item = next(raw)
          except StopIteration:
            break
          if telemetry:
            source_hist.record((perf_counter_ns() - t0) * 1e-6)
          future = pool.submit(_timed_parse, item)
          if not parse_q.put(future, 0, stop):
            future.cancel()
            return
          if telemetry:
            parse_depth_gauge.set(float(parse_q.depth()))
        if not stop.is_set():
          parse_q.put(end, 0, stop)
      except BaseException as e:  # noqa: BLE001 - surfaced to consumer
        parse_q.put(e, 0, stop)

    def _assembler():
      try:
        while not stop.is_set():
          got = parse_q.get(stop)
          if got is None or got is end:
            break
          if isinstance(got, BaseException):
            out_q.put(got, 0, stop)
            return
          batch = got.result()
          if batch is skipped:
            continue  # dropped under the corrupt-record quota
          if not fuse_preprocess:
            t0 = perf_counter_ns()
            try:
              batch = preprocess_fn(batch)
            except BaseException as e:  # noqa: BLE001 - quota decides
              if _absorb(e):
                continue
              raise
            if telemetry:
              preprocess_hist.record((perf_counter_ns() - t0) * 1e-6)
          if not out_q.put(batch, batch_nbytes(batch), stop):
            return
          if telemetry:
            out_depth_gauge.set(float(out_q.depth()))
            out_bytes_gauge.set(float(out_q.nbytes()))
        if not stop.is_set():
          out_q.put(end, 0, stop)
      except BaseException as e:  # noqa: BLE001 - surfaced to consumer
        out_q.put(e, 0, stop)

    self._stop = stop
    self._parse_q = parse_q
    self._out_q = out_q
    self._pool = pool
    self._raw = raw
    self._done = False
    self._telemetry = telemetry
    self._pending_ms: List[float] = []
    if telemetry:
      self._wait_hist = obs_metrics.histogram("data/overlap_wait_ms")
      self._batch_counter = obs_metrics.counter("data/overlap_batches")
    self._feeder = threading.Thread(target=_feeder, daemon=True,
                                    name="overlap-feeder")
    self._assembler = threading.Thread(target=_assembler, daemon=True,
                                       name="overlap-preprocess")
    self._feeder.start()
    self._assembler.start()
    # Backstop for abandoned instances: stop the stages (never join —
    # illegal from a GC callback) so they cannot spin holding batches
    # forever; the idle pool threads are released without waiting.
    self._finalizer = weakref.finalize(
        self, OverlappedLoader._finalize, stop, pool)

  @staticmethod
  def _finalize(stop: threading.Event,
                pool) -> None:
    stop.set()
    pool.shutdown(wait=False, cancel_futures=True)

  def __iter__(self) -> "OverlappedLoader":
    return self

  def __next__(self):
    if self._done:
      raise StopIteration
    t0 = time.perf_counter_ns()
    item = self._out_q.get(self._stop)
    if self._telemetry:
      self._pending_ms.append((time.perf_counter_ns() - t0) * 1e-6)
      if len(self._pending_ms) >= _FLUSH_EVERY:
        self._flush_waits()
    if item is self._END or item is None:
      self.close()
      raise StopIteration
    if isinstance(item, BaseException):
      self.close()
      raise item
    return item

  def _flush_waits(self) -> None:
    if self._pending_ms:
      self._wait_hist.record_many(self._pending_ms)
      self._batch_counter.inc(len(self._pending_ms))
      self._pending_ms.clear()

  def __enter__(self) -> "OverlappedLoader":
    return self

  def __exit__(self, exc_type, exc_value, traceback):
    self.close()
    return False

  def close(self, timeout: float = 60.0) -> None:
    """Stops and JOINS every stage thread (idempotent).

    All stages are host-only (parse/preprocess numpy work — device
    placement lives in the downstream DevicePrefetcher, which owns the
    transfer-phase discipline), so stopping mid-batch is always safe
    and the joins are normally bounded by one in-flight batch per
    stage. `timeout` applies ONLY to a feeder blocked inside
    `next(raw)` on a stalled source (which never sees the stop event):
    close() then logs loudly and abandons that one daemon thread
    instead of hanging — the DevicePrefetcher rule for the same case.
    """
    if self._done and not (self._feeder.is_alive()
                           or self._assembler.is_alive()):
      return
    self._done = True
    self._stop.set()
    # Stalled-source handling under the shared RetryPolicy: the join is
    # paced in jittered growing slices (instead of one opaque blocking
    # join), so a source that stays stalled shows up as
    # `retry/overlap_source_stall/*` pressure in telemetry while the
    # total wait stays bounded by `timeout`.
    from tensor2robot_tpu_torch.utils import retry as retry_lib

    # jitter=0: this paces joins on our OWN thread (nothing to
    # de-synchronize), and a jittered draw could shrink the summed
    # ladder to ~0.75*timeout — abandoning a feeder that would have
    # unstalled within the documented budget. The zero-jitter ladder
    # sums to exactly `timeout` (t/64 * (1+1+2+4+8+16+16+16)).
    policy = retry_lib.RetryPolicy(
        name="overlap_source_stall", max_attempts=8,
        base_delay_s=timeout / 64.0, multiplier=2.0,
        max_delay_s=timeout / 4.0, jitter=0.0, deadline_s=timeout)
    self._feeder.join(timeout=policy.backoff_s(0))
    if self._feeder.is_alive():
      retries = obs_metrics.counter("retry/overlap_source_stall/retries")
      for delay in policy.delays():
        retries.inc()
        self._feeder.join(timeout=delay)
        if not self._feeder.is_alive():
          break
    feeder_stalled = self._feeder.is_alive()
    if feeder_stalled:
      obs_metrics.counter("retry/overlap_source_stall/giveups").inc()
      _log.error(
          "OverlappedLoader.close(): feeder still alive after %.0fs — "
          "blocked in next(raw) on a stalled data source; abandoning "
          "the daemon thread.", timeout)
    # Unblock + retire the pool: cancel queued parses, wait out the
    # in-flight ones (host numpy — bounded), then join the assembler,
    # which observes the stop event within 0.1 s.
    self._pool.shutdown(wait=True, cancel_futures=True)
    self._assembler.join()
    self._finalizer.detach()
    if not feeder_stalled and hasattr(self._raw, "close"):
      # Release the raw source promptly (the native stager's context
      # sits inside the `_raw_batches` generator frame); only safe once
      # the feeder has actually stopped executing the generator.
      try:
        self._raw.close()
      except Exception:  # noqa: BLE001 - teardown must not mask errors
        pass
    if self._telemetry:
      self._flush_waits()
