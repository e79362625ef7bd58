"""Host -> device batch placement (`place_batch`, `DevicePrefetcher`) and
the serving fleet's device carve-out (`replica_device_groups`).

The part of `tensor2robot_tpu.parallel.mesh` the port's single-device
trainer and the serving fleet need. `place_batch` moves one host batch to the device inline;
`DevicePrefetcher` keeps `depth` batches already on the device, placed
by background threads while the device runs the step.

On a CUDA device the prefetcher copies the way the card copies fastest
and overlaps: each host batch is first copied (a host memcpy, off the
consumer's thread) into a ring of `depth + 1` page-locked buffers per
leaf, then to the device with `non_blocking=True` on a side
`torch.cuda.Stream`, which runs beside the step's kernels. An event
recorded after each batch's copies is waited on by the consumer's
stream before the step reads the batch; the device tensors are
`record_stream`ed on the consumer's stream, so the allocator does not
hand their memory to the next copy while the step still reads it; and a
page-locked buffer is reused only after its last copy's event has
fired. From pageable memory the same copy would be staged by the driver
and run synchronously with the host.

On a CPU device the same threads and queue run with no page-locked
buffers and no copy: a choice by device, not a fallback.
"""

from __future__ import annotations

import collections
import itertools
import logging
import queue
import threading
import time
import weakref
from typing import Deque, Dict, List, Optional, Tuple

import torch

from tensor2robot_tpu_torch import specs as specs_lib
from tensor2robot_tpu_torch.obs import metrics as obs_metrics
from tensor2robot_tpu_torch.utils import device as device_lib

__all__ = ["place_batch", "DevicePrefetcher", "replica_device_groups"]

_log = logging.getLogger(__name__)

# Copy timings kept for `copy_ms()` (the newest ones).
_TIMED_COPIES = 64


def replica_device_groups(num_replicas: int, devices=None) -> list:
  """Carves `devices` into `num_replicas` disjoint groups of contiguous
  runs of the list (the serving fleet's per-replica device groups).

  `devices` defaults to `torch.device('cuda', i)` for every visible
  card. A remainder (len(devices) % num_replicas) is spread one extra
  device over the FIRST groups rather than left idle; the fleet's
  least-outstanding-work router absorbs the uneven capacity. The list is
  carved as given: a caller that puts one card in it twice gets two
  replicas on that card, each with its own state."""
  if devices is None:
    devices = [torch.device("cuda", i)
               for i in range(torch.cuda.device_count())]
  devices = list(devices)
  if num_replicas < 1:
    raise ValueError(f"num_replicas must be >= 1, got {num_replicas}")
  if num_replicas > len(devices):
    raise ValueError(
        f"cannot carve {num_replicas} replica device groups out of "
        f"{len(devices)} devices (>= 1 device per replica required)")
  base, remainder = divmod(len(devices), num_replicas)
  groups = []
  offset = 0
  for index in range(num_replicas):
    size = base + (1 if index < remainder else 0)
    groups.append(devices[offset:offset + size])
    offset += size
  return groups


def _placed(values, device: torch.device) -> specs_lib.SpecStruct:
  out = specs_lib.SpecStruct()
  for key, value in specs_lib.flatten_spec_structure(values).items():
    out[key] = (value.to(device, non_blocking=True)
                if isinstance(value, torch.Tensor) else value)
  return out


def place_batch(device, batch) -> Tuple[specs_lib.SpecStruct,
                                        specs_lib.SpecStruct]:
  """One host batch `{features, labels}` -> (features, labels) on
  `device`, inline. Missing labels become an empty SpecStruct."""
  device = torch.device(device)
  features = _placed(batch["features"], device)
  labels = (_placed(batch["labels"], device) if "labels" in batch
            else specs_lib.SpecStruct())
  return features, labels


class _PinnedCopier:
  """The CUDA placement of `DevicePrefetcher`: page-locked ring, side
  stream, one event per batch. Used by the placer thread only."""

  def __init__(self, device: torch.device, slots: int):
    self.device = device
    self.stream = torch.cuda.Stream(device)
    self._slots: List[Dict[str, torch.Tensor]] = [{} for _ in range(slots)]
    self._events: List[Optional[torch.cuda.Event]] = [None] * slots
    self._next = 0
    self.timings: Deque[Tuple[torch.cuda.Event, torch.cuda.Event]] = (
        collections.deque(maxlen=_TIMED_COPIES))

  def _pinned(self, slot: Dict[str, torch.Tensor], key: str,
              value: torch.Tensor) -> torch.Tensor:
    buf = slot.get(key)
    if buf is None or buf.shape != value.shape or buf.dtype != value.dtype:
      buf = torch.empty(value.shape, dtype=value.dtype, pin_memory=True)
      slot[key] = buf
    buf.copy_(value)
    return buf

  def __call__(self, batch):
    i = self._next
    self._next = (i + 1) % len(self._slots)
    if self._events[i] is not None:
      # The copy that last read this slot's buffers must be done before
      # they are overwritten.
      self._events[i].synchronize()
    slot = self._slots[i]
    hosts = {}
    for part in ("features", "labels"):
      if part in batch:
        for key, value in specs_lib.flatten_spec_structure(
            batch[part]).items():
          hosts[f"{part}/{key}"] = (
              self._pinned(slot, f"{part}/{key}", value)
              if isinstance(value, torch.Tensor) else value)
    start = torch.cuda.Event(enable_timing=True)
    done = torch.cuda.Event(enable_timing=True)
    with torch.cuda.device(self.device), torch.cuda.stream(self.stream):
      start.record(self.stream)
      placed = {k: (v.to(self.device, non_blocking=True)
                    if isinstance(v, torch.Tensor) else v)
                for k, v in hosts.items()}
      done.record(self.stream)
    self._events[i] = done
    self.timings.append((start, done))
    obs_metrics.counter("data/prefetch_pinned_batches").inc()
    features = specs_lib.SpecStruct()
    labels = specs_lib.SpecStruct()
    for key, value in placed.items():
      part, leaf = key.split("/", 1)
      (features if part == "features" else labels)[leaf] = value
    return features, labels, done


class DevicePrefetcher:
  """Background device infeed: keeps up to `depth` batches placed ahead.

  Iterating yields (features, labels) already on `device` (CUDA unless
  the caller names another; raises without a card). Two daemon threads
  do the work: a feeder takes host batches from `dataset` into a bounded
  host queue, and a placer copies them to the device (module docstring)
  into a queue of `depth` placed batches, so batch N+1's source wait
  overlaps batch N's copy and both overlap the step. `max_batches`
  bounds how many batches it takes from `dataset`. Exceptions in either
  thread are raised again in the consumer. `close()` (also called at
  the end of the stream) stops the threads promptly and, with
  `close_source`, closes `source` (default: `dataset`), e.g. the
  `OverlappedLoader` behind a derived generator, joining its stage
  threads. The context-manager protocol closes on exit, and a
  `weakref.finalize` backstop stops the threads of a collected but
  unclosed prefetcher.

  Telemetry: `data/overlap_place_ms` (host time to place a batch),
  `data/overlap_device_queue_depth`, `data/overlap_host_queue_depth`,
  `data/prefetch_pinned_batches` (batches copied from page-locked
  buffers on the side stream). `copy_ms()` gives the newest copies'
  device times, from CUDA events on the side stream.
  """

  _STOP = object()

  def __init__(self, dataset, device=None, depth: int = 2,
               max_batches: Optional[int] = None,
               close_source: bool = False, source=None):
    if depth < 1:
      raise ValueError(f"depth must be >= 1, got {depth}")
    self.device = device_lib.resolve_device(device)
    self._copier = (_PinnedCopier(self.device, depth + 1)
                    if self.device.type == "cuda" else None)
    self._source = (source if source is not None else dataset) \
        if close_source else None
    if max_batches is not None:
      # Take from the source only what the consumer will take.
      dataset = itertools.islice(dataset, max_batches)
    out_queue: "queue.Queue" = queue.Queue(maxsize=depth)
    host_queue: "queue.Queue" = queue.Queue(maxsize=depth)
    stop = threading.Event()
    self._queue = out_queue
    self._stop = stop
    self._done = False
    sentinel = self._STOP
    copier, target = self._copier, self.device
    place_hist = obs_metrics.histogram("data/overlap_place_ms")
    depth_gauge = obs_metrics.gauge("data/overlap_device_queue_depth")
    host_depth_gauge = obs_metrics.gauge("data/overlap_host_queue_depth")
    perf_counter_ns = time.perf_counter_ns

    # The threads close over locals only, never `self`, so an abandoned
    # prefetcher is collectable and its finalizer can fire.
    def _put(q, item) -> bool:
      while not stop.is_set():
        try:
          q.put(item, timeout=0.1)
          return True
        except queue.Full:
          continue
      return False

    def _feeder():
      try:
        for batch in dataset:
          if stop.is_set() or not _put(host_queue, batch):
            return
          host_depth_gauge.set(float(host_queue.qsize()))
        _put(host_queue, sentinel)
      except BaseException as e:  # noqa: BLE001 - raised in the consumer
        _put(host_queue, e)

    def _placer():
      try:
        while not stop.is_set():
          try:
            item = host_queue.get(timeout=0.1)
          except queue.Empty:
            continue
          if item is sentinel or isinstance(item, BaseException):
            _put(out_queue, item)
            return
          t0 = perf_counter_ns()
          if copier is not None:
            placed = copier(item)
          else:
            placed = (*place_batch(target, item), None)
          place_hist.record((perf_counter_ns() - t0) * 1e-6)
          if not _put(out_queue, placed):
            return
          depth_gauge.set(float(out_queue.qsize()))
      except BaseException as e:  # noqa: BLE001 - raised in the consumer
        _put(out_queue, e)

    self._feeder = threading.Thread(target=_feeder, daemon=True,
                                    name="device-prefetch-feed")
    self._thread = threading.Thread(target=_placer, daemon=True,
                                    name="device-prefetch")
    self._feeder.start()
    self._thread.start()
    self._finalizer = weakref.finalize(self, stop.set)

  @property
  def stream(self) -> Optional["torch.cuda.Stream"]:
    """The side stream the copies run on (None on the CPU)."""
    return self._copier.stream if self._copier is not None else None

  def copy_ms(self) -> List[float]:
    """Device time of each of the newest batches' copies (CUDA events on
    the side stream; waits for them). Empty on the CPU."""
    if self._copier is None:
      return []
    timings = list(self._copier.timings)
    for _, done in timings:
      done.synchronize()
    return [start.elapsed_time(done) for start, done in timings]

  def __iter__(self):
    return self

  def __next__(self):
    if self._done:
      raise StopIteration
    item = self._queue.get()
    if item is self._STOP:
      self.close()
      raise StopIteration
    if isinstance(item, BaseException):
      self.close()
      raise item
    features, labels, done = item
    if done is not None:
      consumer = torch.cuda.current_stream(self.device)
      consumer.wait_event(done)
      for value in itertools.chain(features.values(), labels.values()):
        if isinstance(value, torch.Tensor):
          value.record_stream(consumer)
    return features, labels

  def __enter__(self):
    return self

  def __exit__(self, exc_type, exc_value, traceback):
    self.close()
    return False

  def close(self, timeout: float = 60.0) -> None:
    """Stops the threads and waits for the placer's batch in flight.

    The threads check the stop event at least every 0.1 s, so the joins
    are normally bounded by one batch. A feeder blocked inside
    next(dataset) is unstuck by closing a closable source (an
    `OverlappedLoader`); one that stays blocked for `timeout` on a
    stalled source is abandoned, with an error logged.
    """
    self._done = True
    self._stop.set()
    self._thread.join()
    self._feeder.join(timeout=1.0)
    self._close_source()
    self._feeder.join(timeout=timeout)
    if self._feeder.is_alive():
      _log.error("DevicePrefetcher.close(): the feeder is still blocked in "
                 "next(dataset) on a stalled data source; abandoning its "
                 "daemon thread.")
    self._finalizer.detach()

  def _close_source(self) -> None:
    """Closes a `close_source=True` source once."""
    source, self._source = self._source, None
    if source is None or not hasattr(source, "close"):
      return
    try:
      source.close()
    except ValueError:
      # A plain generator executing in the feeder thread cannot be
      # closed from here; the feeder ends it at its next batch.
      pass
