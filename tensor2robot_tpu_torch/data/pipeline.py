"""Host-side streaming input pipeline.

The port's copy of `tensor2robot_tpu.data.pipeline`: file glob -> shuffle
files -> interleave -> record shuffle -> repeat -> batch -> batched
parse -> preprocess -> prefetch, on host threads, handing finished
batches to the device layer (`parallel.mesh.DevicePrefetcher`).

* No tf.data runtime: a small thread-pool pipeline with explicit stages.
* Per-host file sharding for multi-process training.
* Deterministic, single-pass order in eval; shuffled and repeating in
  train.
* The native stager (`data/stager.py`) stages single-dataset batches on
  C++ threads where the library is built; the pure-Python generator
  chain stays as the fallback (`use_native_stager` forces either).
* The overlap plane (`data/overlap.py`) runs parse and preprocess on
  their own threads (`overlap`, on by default when `prefetch_size` > 0).

Corrupt-record quota: with `max_corrupt_records` > 0 a batch that fails
to parse or preprocess is skipped and its records counted
(`data/corrupt_records_skipped`, `data/corrupt_batches_skipped`), and a
record-source I/O error ends the current epoch early (counted as
`data/source_io_errors`); past the quota the error is raised. The quota
is 0 by default: eval and parity paths raise at once. The
`obs.faultlab` points `data.record_io` (the record stream raises an
`IOError` mid-epoch), `data.corrupt_record` (a batch's first record is
overwritten with 0xFF bytes before parse) and `data.preprocess` (the
preprocess stage raises) inject exactly these failures; the record-IO
seam is wrapped in only while a plan is active, so a run without one
changes no batch. While the tracer is on (a run with step telemetry),
each consumer wait on the prefetch queue is a `data/prefetch_wait` span.
"""

from __future__ import annotations

import glob as glob_lib
import logging
import queue
import random
import threading
import time
from typing import Any, Callable, Dict, Iterator, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from tensor2robot_tpu_torch import specs as specs_lib
from tensor2robot_tpu_torch.data import overlap as overlap_lib
from tensor2robot_tpu_torch.data import parsing, tfrecord
from tensor2robot_tpu_torch.data import stager as stager_lib
from tensor2robot_tpu_torch.obs import faultlab as faultlab_lib
from tensor2robot_tpu_torch.obs import metrics as obs_metrics
from tensor2robot_tpu_torch.obs import trace as obs_trace
from tensor2robot_tpu_torch.utils import config

__all__ = ["resolve_file_patterns", "RecordBatchPipeline",
           "WeightedRecordPipeline", "prefetch", "interleave_records",
           "shuffled", "as_tensors"]

PreprocessFn = Callable[[specs_lib.SpecStruct, specs_lib.SpecStruct, str],
                        Tuple[specs_lib.SpecStruct, specs_lib.SpecStruct]]

# How many per-batch wait observations the prefetch consumer buffers
# locally before one `record_many` flush into the metrics registry.
_FLUSH_EVERY = 64

# Sentinel for a batch dropped under the corrupt-record quota (filtered
# out of the serial chain before the consumer).
_SKIP = object()


def _corrupted_copy(batch):
  """faultlab `data.corrupt_record` payload: `batch` with the FIRST
  record's bytes overwritten with 0xFF (an invalid proto wire tag), so
  the parser fails exactly the way real corruption fails. Copies — the
  raw batch may be shared with telemetry or retries."""
  if isinstance(batch, stager_lib.StagedBatch):
    arena = batch.arena.copy()
    offset = int(batch.offsets[0])
    length = int(batch.lengths[0])
    arena[offset:offset + length] = 0xFF
    return stager_lib.StagedBatch(arena, batch.offsets, batch.lengths)
  batch = list(batch)
  first = {key: b"\xff" * max(len(value), 4)
           for key, value in batch[0].items()}
  batch[0] = first
  return batch


def as_tensors(values: specs_lib.SpecStruct) -> specs_lib.SpecStruct:
  """numpy leaves -> CPU tensors sharing their memory (`torch.from_numpy`,
  no copy; a read-only array is copied first). Tensors and string
  arrays stay as they are."""
  out = specs_lib.SpecStruct()
  for key, value in values.items():
    if isinstance(value, np.ndarray) and value.dtype.kind not in "SUO":
      if not value.flags.writeable:
        value = value.copy()
      value = torch.from_numpy(value)
    out[key] = value
  return out


def resolve_file_patterns(
    file_patterns: Union[str, Sequence[str]],
    process_index: int = 0,
    process_count: int = 1) -> List[str]:
  """Expands comma-separated glob patterns; shards files across hosts
  (every `process_count`-th file from `process_index`)."""
  files, _ = _resolve_file_patterns_sharded(file_patterns, process_index,
                                            process_count)
  return files


def _resolve_file_patterns_sharded(
    file_patterns: Union[str, Sequence[str]],
    process_index: int = 0,
    process_count: int = 1) -> Tuple[List[str], bool]:
  """`resolve_file_patterns` plus a shared-files flag.

  Returns (files, shared): `shared` is True on the fewer-files-than-
  hosts path, where every host reads the same full file list:
  `RecordBatchPipeline` then offsets its epoch shuffle seed by
  `process_index` so co-hosted processes do not train on identical
  record orders."""
  if isinstance(file_patterns, str):
    file_patterns = file_patterns.split(",")
  files: List[str] = []
  for pattern in file_patterns:
    pattern = pattern.strip()
    if not pattern:
      continue
    matched = sorted(glob_lib.glob(pattern))
    if not matched:
      raise ValueError(f"File pattern {pattern!r} matched no files.")
    files.extend(matched)
  shared = False
  if process_count > 1:
    if len(files) >= process_count:
      files = files[process_index::process_count]
    else:
      shared = True
  return files, shared


def interleave_records(files: Sequence[str],
                       cycle_length: int = 4,
                       shuffle_files: bool = False,
                       seed: Optional[int] = None) -> Iterator[bytes]:
  """Round-robin interleave of records from several files."""
  files = list(files)
  if shuffle_files:
    random.Random(seed).shuffle(files)
  pending = list(files)
  active: List[Iterator[bytes]] = []
  while pending or active:
    while pending and len(active) < cycle_length:
      active.append(tfrecord.iter_records(pending.pop(0)))
    next_active = []
    for it in active:
      try:
        yield next(it)
        next_active.append(it)
      except StopIteration:
        pass
    active = next_active


def shuffled(stream: Iterator[Any], buffer_size: int,
             seed: Optional[int] = None) -> Iterator[Any]:
  """Reservoir-style shuffle buffer (tf.data.Dataset.shuffle semantics).

  `buffer_size` <= 0 is a pass-through (tf.data treats shuffle(0)/(1) as
  no-ops) — without the guard the first post-fill item would hit
  `rng.randrange(0)` and raise ValueError."""
  if buffer_size <= 0:
    yield from stream
    return
  rng = random.Random(seed)
  buffer: List[Any] = []
  for item in stream:
    if len(buffer) < buffer_size:
      buffer.append(item)
      continue
    idx = rng.randrange(buffer_size)
    yield buffer[idx]
    buffer[idx] = item
  rng.shuffle(buffer)
  yield from buffer


def parallel_map_ordered(fn: Callable[[Any], Any],
                         stream: Iterator[Any],
                         num_workers: int = 2,
                         max_inflight: Optional[int] = None
                         ) -> Iterator[Any]:
  """Order-preserving parallel map with bounded in-flight work.

  The parse stage scales across threads because the native parser and
  image decode release the GIL (tf.data's parallel map equivalent for
  this pipeline)."""
  import collections
  from concurrent.futures import ThreadPoolExecutor

  max_inflight = max_inflight or 2 * num_workers
  with ThreadPoolExecutor(num_workers) as pool:
    futures: "collections.deque" = collections.deque()
    for item in stream:
      futures.append(pool.submit(fn, item))
      while len(futures) >= max_inflight:
        yield futures.popleft().result()
    while futures:
      yield futures.popleft().result()


def _batched(stream: Iterator[Any], batch_size: int,
             drop_remainder: bool) -> Iterator[List[Any]]:
  """Groups a stream into lists of batch_size (tf.data batch semantics)."""
  batch: List[Any] = []
  for item in stream:
    batch.append(item)
    if len(batch) == batch_size:
      yield batch
      batch = []
  if batch and not drop_remainder:
    yield batch


def prefetch(stream: Iterator[Any], size: int = 2) -> Iterator[Any]:
  """Background-thread prefetch (tf.data prefetch(AUTOTUNE) equivalent).

  The worker watches a stop event so an abandoned consumer (finished
  eval round, dropped iterator) releases the thread and its upstream
  file handles instead of blocking on a full queue forever."""
  q: "queue.Queue" = queue.Queue(maxsize=size)
  _END = object()
  stop = threading.Event()
  error: List[BaseException] = []

  def _put(item) -> bool:
    while not stop.is_set():
      try:
        q.put(item, timeout=0.1)
        return True
      except queue.Full:
        continue
    return False

  def _worker():
    try:
      for item in stream:
        if not _put(item):
          return
    except BaseException as e:  # propagate into consumer
      error.append(e)
    finally:
      _put(_END)

  thread = threading.Thread(target=_worker, daemon=True)
  thread.start()
  # How long the consumer stalls on the queue is the input pipeline's
  # health number (an empty queue = host parse cannot keep up). Waits
  # are flushed to the registry in blocks of `_FLUSH_EVERY`; the
  # `finally` flush keeps totals exact at stream end.
  wait_hist = obs_metrics.histogram("data/prefetch_wait_ms")
  batch_counter = obs_metrics.counter("data/batches")
  tracer = obs_trace.get_tracer()
  pending_ms: List[float] = []
  perf_counter_ns = time.perf_counter_ns
  try:
    while True:
      t0 = perf_counter_ns()
      item = q.get()
      dur_ns = perf_counter_ns() - t0
      if tracer.enabled:
        tracer.add_complete("data/prefetch_wait", t0, dur_ns, cat="data")
      if item is _END:
        if error:
          raise error[0]
        return
      pending_ms.append(dur_ns * 1e-6)
      if len(pending_ms) >= _FLUSH_EVERY:
        wait_hist.record_many(pending_ms)
        batch_counter.inc(len(pending_ms))
        pending_ms.clear()
      yield item
  finally:
    stop.set()
    if pending_ms:
      wait_hist.record_many(pending_ms)
      batch_counter.inc(len(pending_ms))


@config.configurable
class RecordBatchPipeline:
  """records -> shuffled -> batched -> parsed -> preprocessed batches.

  Supports multi-dataset zip (aligned files per `dataset_key`); weighted
  mixtures across dataset groups are `WeightedRecordPipeline`'s.

  Staging plane: with the native toolchain present, the single-dataset
  records->batch path runs on the C++ `BatchStager` (`data/stager.py`:
  GIL-free interleave + shuffle + batch assembly, whole batches handed
  over as one arena) and the pure-Python generator chain stays as the
  no-toolchain fallback — `use_native_stager` (None = auto) forces
  either side, which the parity tests use. Multi-dataset zip keeps the
  per-record Python zip but streams each dataset's records through the
  native plane in record mode.

  Overlap plane (`data/overlap.py`): with `overlap` on (None = auto:
  whenever `prefetch_size` > 0), iteration returns an
  `OverlappedLoader` — arena/record parsing runs on an ordered
  `num_parallel_parses`-thread pool and preprocessing on its own worker
  downstream of the staging plane, with bounded stop-aware hand-off
  queues (`overlap_queue_mb` byte-caps the preprocessed-batch queue),
  so the consumer only ever dequeues finished batches. Output is
  byte-identical to the serial chain over the same record stream (same
  seeds, same order). The returned
  iterator has `close()` joining every stage thread — callers that
  abandon iteration early (finished eval rounds) should close it; the
  train loop's DevicePrefetcher does so on its own close.
  `overlap=False` restores the serial generator chain, which the
  parity tests use.
  """

  def __init__(self,
               file_patterns: Union[str, Sequence[str], Mapping[str, Any]],
               parse_fn: parsing.ParseFn,
               batch_size: int,
               mode: str = "train",
               shuffle_buffer_size: int = 512,
               cycle_length: int = 4,
               drop_remainder: bool = True,
               repeat: bool = True,
               seed: Optional[int] = None,
               preprocess_fn: Optional[PreprocessFn] = None,
               mixture_weights: Optional[Sequence[float]] = None,
               prefetch_size: int = 2,
               num_parallel_parses: int = 2,
               process_index: int = 0,
               process_count: int = 1,
               use_native_stager: Optional[bool] = None,
               overlap: Optional[bool] = None,
               overlap_queue_mb: Optional[float] = None,
               fused_preprocess: Optional[bool] = None,
               max_corrupt_records: int = 0):
    self._parse_fn = parse_fn
    self._batch_size = batch_size
    self._mode = mode
    self._train = mode == "train"
    self._shuffle_buffer_size = shuffle_buffer_size if self._train else 0
    self._cycle_length = cycle_length
    self._drop_remainder = drop_remainder
    self._repeat = repeat and self._train
    self._seed = seed
    self._preprocess_fn = preprocess_fn
    self._mixture_weights = mixture_weights
    self._prefetch_size = prefetch_size
    self._num_parallel_parses = num_parallel_parses
    self._use_native_stager = use_native_stager
    self._overlap = overlap
    self._overlap_queue_bytes = (
        overlap_lib.DEFAULT_QUEUE_BYTES if overlap_queue_mb is None
        else max(int(overlap_queue_mb * (1 << 20)), 1))
    self._fused_preprocess = fused_preprocess
    # Corrupt-record quota (module docstring): total RECORDS
    # allowed to be dropped over this pipeline's lifetime before a
    # parse/preprocess/source failure raises. 0 = strict.
    self._max_corrupt_records = max(int(max_corrupt_records), 0)
    self._corrupt_records_seen = 0
    self._corrupt_lock = threading.Lock()
    self._warned_stager_unavailable = False
    dataset_keys = parse_fn.dataset_keys
    if isinstance(file_patterns, Mapping):
      resolved = {
          k: _resolve_file_patterns_sharded(v, process_index, process_count)
          for k, v in file_patterns.items()}
    else:
      if len(dataset_keys) > 1:
        raise ValueError(
            f"Specs use dataset keys {dataset_keys}; pass a mapping of "
            "dataset_key -> file patterns.")
      resolved = {
          dataset_keys[0]: _resolve_file_patterns_sharded(
              file_patterns, process_index, process_count)}
    self._files = {k: files for k, (files, _) in resolved.items()}
    # Fewer files than hosts: every co-hosted process reads the SAME
    # file list, so each offsets its epoch shuffle seed by its
    # process_index (one offset pipeline-wide — multi-dataset zip
    # streams must keep using one common seed or their file orders
    # de-align). Sharded hosts keep offset 0: their record orders
    # already differ by construction.
    self._host_seed_offset = (
        process_index * 1_000_003
        if any(shared for _, shared in resolved.values()) else 0)
    unknown = set(self._files) - set(dataset_keys)
    if unknown:
      raise ValueError(
          f"File patterns given for unknown dataset keys {sorted(unknown)}; "
          f"specs define {dataset_keys}.")

  @property
  def batch_size(self) -> int:
    return self._batch_size

  def _stager_enabled(self) -> bool:
    if self._use_native_stager is not None:
      if self._use_native_stager and not stager_lib.stager_available():
        # Loud once per pipeline: an explicit force of the native plane
        # that cannot be honored is a misconfiguration (no toolchain or
        # a broken build). Auto mode (None) falls back silently.
        if not self._warned_stager_unavailable:
          self._warned_stager_unavailable = True
          logging.warning(
              "use_native_stager=True but the native toolchain is "
              "unavailable; falling back to the pure-Python record "
              "chain (expect ~2x lower host staging throughput).")
        return False
      return self._use_native_stager
    return stager_lib.stager_available()

  def _epoch_seed(self, epoch: int) -> Optional[int]:
    return (None if self._seed is None
            else self._seed + epoch + self._host_seed_offset)

  # -- corrupt-record quota (module docstring) ------------------------------

  def _charge_quota(self, exc: BaseException, what: str) -> bool:
    """Charges one batch's worth of records against the corruption
    quota; False when the quota is off or exceeded (the caller must
    raise). Thread-safe — the overlap plane calls this from pool
    threads. The accounting unit is the batch's records (`batch_size`;
    a corrupt record costs its batch — the parse unit)."""
    if self._max_corrupt_records <= 0:
      return False
    with self._corrupt_lock:
      self._corrupt_records_seen += self._batch_size
      over = self._corrupt_records_seen > self._max_corrupt_records
    if over:
      logging.error(
          "data: corrupt-record quota exceeded (%d records skipped > "
          "max_corrupt_records=%d); surfacing %s", self._corrupt_records_seen,
          self._max_corrupt_records, type(exc).__name__)
      return False
    logging.warning("data: skipped %s under quota (%s: %s)", what,
                    type(exc).__name__, exc)
    return True

  def _absorb_batch_error(self, exc: BaseException) -> bool:
    """Decides whether a failed parse/preprocess batch is SKIPPED
    (True: counted against the record quota as corrupt records) or
    must raise (False: quota disabled or exceeded)."""
    if not self._charge_quota(exc, "a corrupt batch"):
      return False
    obs_metrics.counter("data/corrupt_records_skipped").inc(self._batch_size)
    obs_metrics.counter("data/corrupt_batches_skipped").inc()
    return True

  def _absorb_source_error(self, exc: BaseException) -> bool:
    """A record-source I/O error ends the CURRENT epoch early instead
    of killing the run (the remaining epoch records are charged as one
    batch against the same quota); False past the quota or when the
    quota is off. Counted ONLY as `data/source_io_errors` — an I/O
    flake is not data corruption, and conflating the counters would
    point a dashboard at the wrong failure."""
    if not self._charge_quota(exc, "the rest of the epoch (source I/O)"):
      return False
    obs_metrics.counter("data/source_io_errors").inc()
    return True

  def _inject_record_faults(self, stream: Iterator[Any]) -> Iterator[Any]:
    """`data.record_io` faultlab seam: the stream raises a (real-
    IOError-subclass) injected error mid-epoch."""
    for item in stream:
      if faultlab_lib.maybe_fire(faultlab_lib.DATA_RECORD_IO) is not None:
        raise faultlab_lib.InjectedIOError(
            "faultlab: injected record-source I/O error")
      yield item

  def _guarded(self, fn):
    """Quota-absorbing wrapper for the serial parse/preprocess chain:
    a failed batch becomes the `_SKIP` sentinel (filtered before the
    consumer) while the quota holds."""
    def inner(batch):
      if batch is _SKIP:
        return _SKIP
      try:
        return fn(batch)
      except (KeyboardInterrupt, SystemExit):
        raise
      except BaseException as e:  # noqa: BLE001 - quota decides
        if self._absorb_batch_error(e):
          return _SKIP
        raise
    return inner

  def _epoch_files(self, files: Sequence[str],
                   epoch_seed: Optional[int]) -> List[str]:
    """Final per-epoch file order: train mode shuffles in Python with
    the epoch seed on BOTH staging planes, so native/Python file order
    is identical (`interleave_records` shuffle_files parity)."""
    files = list(files)
    if self._train:
      random.Random(epoch_seed).shuffle(files)
    return files

  def _interleave(self, files: Sequence[str],
                  epoch_seed: Optional[int]) -> Iterator[bytes]:
    """Per-dataset record stream: native record-mode staging when the
    toolchain is present, the Python generator chain otherwise."""
    files = self._epoch_files(files, epoch_seed)
    if self._stager_enabled() and files:
      stream: Iterator[bytes] = stager_lib.iter_staged_records(
          files, self._cycle_length)
    else:
      stream = interleave_records(files, self._cycle_length)
    if faultlab_lib.active() is not None:
      stream = self._inject_record_faults(stream)
    return stream

  def _record_tuples(self, epoch_seed: Optional[int]
                     ) -> Iterator[Dict[str, bytes]]:
    """Yields aligned {dataset_key: record} tuples for one pass."""
    if self._mixture_weights is not None:
      # Weighted sampling across dataset groups: each group is a separate
      # mixture source; all specs must share one dataset_key in this mode.
      raise NotImplementedError(
          "mixture_weights are handled by WeightedRecordPipeline.")
    streams = {k: self._interleave(files, epoch_seed)
               for k, files in self._files.items()}
    keys = list(streams)
    while True:
      item = {}
      try:
        for k in keys:
          item[k] = next(streams[k])
      except StopIteration:
        return
      yield item

  def _raw_batches(self) -> Iterator[Any]:
    """Raw record batches: `List[{dataset_key: record}]` on the Python
    chain, `stager.StagedBatch` arenas on the native plane (single
    dataset only — the zip path must align records across keys one at a
    time). `_parse_only` consumes either shape."""
    single_key = (len(self._files) == 1 and self._mixture_weights is None)
    epoch = 0
    while True:
      epoch_seed = self._epoch_seed(epoch)
      files = next(iter(self._files.values())) if single_key else None
      try:
        if files and self._stager_enabled():
          epoch_batches: Iterator[Any] = stager_lib.stage_batches(
              self._epoch_files(files, epoch_seed),
              batch_size=self._batch_size,
              cycle_length=self._cycle_length,
              shuffle_buffer=self._shuffle_buffer_size,
              seed=epoch_seed,
              drop_remainder=self._drop_remainder)
          if faultlab_lib.active() is not None:
            epoch_batches = self._inject_record_faults(epoch_batches)
          yield from epoch_batches
        else:
          stream: Iterator[Dict[str, bytes]] = self._record_tuples(epoch_seed)
          if self._shuffle_buffer_size:
            stream = shuffled(stream, self._shuffle_buffer_size, epoch_seed)
          yield from _batched(stream, self._batch_size, self._drop_remainder)
      except (IOError, OSError) as e:
        # A mid-epoch source I/O error (a rotten shard, a network file
        # system hiccup) ends THIS epoch early under the counted quota;
        # strict mode re-raises.
        if not self._absorb_source_error(e):
          raise
      if not self._repeat:
        return
      epoch += 1

  def _overlap_enabled(self, prefetch_size: int) -> bool:
    """The overlap-plane decision: explicit `overlap` wins; auto (None)
    pipelines whenever the caller wants background behavior at all
    (`prefetch_size` > 0). `overlap=False` keeps the serial generator
    chain, which the parity tests force."""
    if self._overlap is not None:
      return self._overlap
    return prefetch_size > 0

  def _fuse_preprocess_enabled(self) -> bool:
    """The fused-preprocess decision: explicit `fused_preprocess` wins; auto (None) fuses preprocess into
    the parse pool ONLY when purity is declared — the preprocess fn is
    a bound method of an `AbstractPreprocessor` (whose `_preprocess_fn`
    contract is "a pure function over SpecStructs", preprocessors/
    base.py) or the fn carries a truthy `stateless` attribute; a bare
    callable may close over cross-batch state, so it keeps the serial
    preprocess worker and its deterministic consumption order."""
    if self._fused_preprocess is not None:
      return self._fused_preprocess
    fn = self._preprocess_fn
    if fn is None:
      return True  # identity preprocess: trivially pure
    if getattr(fn, "stateless", False):
      return True
    from tensor2robot_tpu_torch.preprocessors import base as preprocessors_base

    return isinstance(getattr(fn, "__self__", None),
                      preprocessors_base.AbstractPreprocessor)

  def _assemble(self, raw: Iterator[Any],
                prefetch_size: Optional[int] = None,
                num_parallel_parses: Optional[int] = None
                ) -> Iterator[specs_lib.SpecStruct]:
    """raw record-tuple batches -> parsed+preprocessed (+prefetched)
    batches. Parsing runs in parallel; preprocessing stays serial in
    consumption order so stateful/seeded preprocessors keep
    deterministic behavior. Shared with WeightedRecordPipeline, which
    passes its own `num_parallel_parses` as a parameter, so the
    template source's configuration is never mutated.

    With the overlap plane on this returns an `OverlappedLoader`
    (parse pool + preprocess worker + byte-capped hand-off queues,
    `data/overlap.py`) whose output is byte-identical to the serial
    chain below; otherwise the legacy chain: ordered parallel parse map
    + serial preprocess + `prefetch` thread."""
    workers = (self._num_parallel_parses if num_parallel_parses is None
               else num_parallel_parses)
    size = self._prefetch_size if prefetch_size is None else prefetch_size
    degrade = self._max_corrupt_records > 0
    if self._overlap_enabled(size):
      return overlap_lib.OverlappedLoader(
          iter(raw), self._parse_only, self._apply_preprocess,
          parse_workers=max(workers, 1), depth=max(size, 1),
          max_bytes=self._overlap_queue_bytes,
          fuse_preprocess=self._fuse_preprocess_enabled(),
          skip_batch_on_error=(self._absorb_batch_error if degrade
                               else None))
    if workers > 1:
      parse = self._guarded(self._parse_only) if degrade else self._parse_only
      parsed = parallel_map_ordered(parse, raw, num_workers=workers)
      preprocess = (self._guarded(self._apply_preprocess) if degrade
                    else self._apply_preprocess)
      stream: Iterator[specs_lib.SpecStruct] = map(preprocess, parsed)
    else:
      finalize = self._guarded(self._finalize) if degrade else self._finalize
      stream = map(finalize, raw)
    if degrade:
      stream = (batch for batch in stream if batch is not _SKIP)
    if size:
      stream = prefetch(stream, size)
    return stream

  def _parse_only(self, batch: Any) -> specs_lib.SpecStruct:
    if faultlab_lib.maybe_fire(faultlab_lib.DATA_CORRUPT_RECORD) is not None:
      batch = _corrupted_copy(batch)
    if isinstance(batch, stager_lib.StagedBatch):
      # Arena batch from the native staging plane: hand it through
      # whole — the native parser reads records in place (parse_arena),
      # fallback paths materialize bytes themselves. Keyed by the
      # pipeline's OWN single files key, not dataset_keys[0]: specs may
      # declare several keys while this pipeline feeds just one of
      # them, and the Python chain parses under that same key.
      return self._parse_fn.parse_batch(
          {next(iter(self._files)): batch})
    records = {k: [item[k] for item in batch] for k in batch[0]}
    return self._parse_fn.parse_batch(records)

  def _apply_preprocess(self, parsed: specs_lib.SpecStruct
                        ) -> specs_lib.SpecStruct:
    if faultlab_lib.maybe_fire(faultlab_lib.DATA_PREPROCESS) is not None:
      raise faultlab_lib.InjectedPreprocessError(
          "faultlab: injected preprocess failure")
    features = parsed["features"] if "features" in parsed \
        else specs_lib.SpecStruct()
    labels = parsed["labels"] if "labels" in parsed else specs_lib.SpecStruct()
    features = as_tensors(specs_lib.flatten_spec_structure(features))
    labels = as_tensors(specs_lib.flatten_spec_structure(labels))
    if self._preprocess_fn is not None:
      features, labels = self._preprocess_fn(features, labels, self._mode)
    out = specs_lib.SpecStruct()
    out["features"] = features
    if len(labels):
      out["labels"] = labels
    return out

  def _finalize(self, batch: List[Dict[str, bytes]]) -> specs_lib.SpecStruct:
    return self._apply_preprocess(self._parse_only(batch))

  def __iter__(self) -> Iterator[specs_lib.SpecStruct]:
    return self._assemble(self._raw_batches())


class WeightedRecordPipeline:
  """Samples each record from one of several pipelines by weight.

  Training mode shuffles each source through its own buffer and refills
  exhausted sources forever. Non-train modes are deterministic and
  terminating: no shuffling, a seeded sampling sequence, and each source
  contributes exactly one pass — when a source exhausts, sampling
  renormalizes over the remainder, and iteration ends once every source
  has been consumed. Batches flow through the same parallel-parse and
  prefetch stages as RecordBatchPipeline.
  """

  def __init__(self,
               file_pattern_groups: Sequence[Union[str, Sequence[str]]],
               weights: Sequence[float],
               parse_fn: parsing.ParseFn,
               batch_size: int,
               mode: str = "train",
               shuffle_buffer_size: int = 512,
               drop_remainder: bool = True,
               repeat: bool = True,
               seed: Optional[int] = None,
               prefetch_size: int = 2,
               num_parallel_parses: int = 2,
               **kwargs):
    if len(file_pattern_groups) != len(weights):
      raise ValueError("One weight per file-pattern group required.")
    if any(w < 0 for w in weights) or sum(weights) <= 0:
      raise ValueError(f"Weights must be non-negative with a positive "
                       f"sum, got {list(weights)}.")
    total = float(sum(weights))
    self._weights = np.asarray([w / total for w in weights], np.float64)
    self._batch_size = batch_size
    self._mode = mode
    self._train = mode == "train"
    self._shuffle_buffer_size = shuffle_buffer_size if self._train else 0
    self._drop_remainder = drop_remainder
    self._repeat = repeat and self._train
    self._seed = seed
    self._prefetch_size = prefetch_size
    self._num_parallel_parses = num_parallel_parses
    self._sources = [
        RecordBatchPipeline(patterns, parse_fn, batch_size=1,
                            mode=mode, drop_remainder=False, seed=seed,
                            **kwargs)
        for patterns in file_pattern_groups]
    self._parse_fn = parse_fn

  def _source_iter(self, idx: int, epoch: int) -> Iterator[Dict[str, bytes]]:
    # The source's _host_seed_offset rides along, mirroring
    # RecordBatchPipeline._epoch_seed: on the shared-files path (fewer
    # files than hosts) co-hosted processes must not read identical
    # record orders, and this path drives the source's _record_tuples
    # directly, bypassing its own _epoch_seed.
    source = self._sources[idx]
    seed = (None if self._seed is None
            else self._seed + 7919 * idx + 104_729 * epoch
            + source._host_seed_offset)
    stream = source._record_tuples(seed)
    if self._shuffle_buffer_size:
      stream = shuffled(stream, self._shuffle_buffer_size, seed)
    return iter(stream)

  def _record_stream(self) -> Iterator[Dict[str, bytes]]:
    rng = np.random.RandomState(self._seed)
    n = len(self._sources)
    iterators = [self._source_iter(i, 0) for i in range(n)]
    epochs = [0] * n
    # Zero-weight sources are never sampled, so
    # they start dead — otherwise non-train termination would divide by
    # a zero probability mass once the weighted sources exhaust.
    alive = self._weights > 0
    while alive.any():
      p = self._weights * alive
      idx = int(rng.choice(n, p=p / p.sum()))
      refilled = False
      while True:
        try:
          yield next(iterators[idx])
          break
        except StopIteration:
          if not self._repeat or refilled:  # one pass, or empty source
            alive[idx] = False
            break
          epochs[idx] += 1
          iterators[idx] = self._source_iter(idx, epochs[idx])
          refilled = True

  def _raw_batches(self) -> Iterator[List[Dict[str, bytes]]]:
    return _batched(self._record_stream(), self._batch_size,
                    self._drop_remainder)

  def __iter__(self) -> Iterator[specs_lib.SpecStruct]:
    # The first source is used as the parse/preprocess TEMPLATE only;
    # this pipeline's parallelism rides along as a parameter so the
    # template's own configuration is never mutated (a second iteration
    # or a caller sharing the source used to see the overwritten value).
    return self._sources[0]._assemble(
        self._raw_batches(), prefetch_size=self._prefetch_size,
        num_parallel_parses=self._num_parallel_parses)
