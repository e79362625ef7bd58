"""Native batched record staging: the host data plane's fast path.

The port's copy of `tensor2robot_tpu.data.stager`, over the port's
`native.RecordStager` (`native/batch_stager.cc`): file interleave,
reservoir shuffle and batch assembly run on GIL-free C++ threads, and
Python receives one contiguous arena (+ offsets/lengths) per batch. The
arena feeds `BatchExampleParser.parse_arena` directly, so the whole
records -> parsed-batch path costs a handful of ctypes calls per batch.

Semantics, held against the pure-Python chain of `data/pipeline.py` by
the port's data tests: the same interleave order (eval mode is
byte-identical end to end), the same shuffle algorithm with a
std::mt19937_64 in place of Python's generator in train mode (same
distribution and deterministic per seed, not the same permutation),
`_batched` drop_remainder behaviour, and IOError on corruption.

Telemetry (pipeline batches, in the port's metrics registry):
  data/stage_ms            consumer wait per staged batch
  data/arena_bytes         payload bytes per staged batch
  data/stager_queue_depth  staged batches waiting in the C++ queue
  data/staged_batches      batches handed to Python
"""

from __future__ import annotations

import time
from typing import Iterator, List, Optional, Sequence

import numpy as np

from tensor2robot_tpu_torch import native
from tensor2robot_tpu_torch.obs import metrics as obs_metrics

__all__ = ["StagedBatch", "stager_available", "stage_batches",
           "iter_staged_records"]

# Record-mode streaming (`iter_staged_records`) chunking: up to
# _RECORD_CHUNK records per staged chunk (amortizes the per-chunk Python
# cost on small records) but never much past _RECORD_CHUNK_BYTES of
# payload — the byte cap also bounds the C++ reader queues, so host RSS
# stays ~O(cycle_length + queue_depth) chunks even on multi-MB episode
# records (a count-only bound buffered GiBs there; the Python chain it
# replaces buffered ~one record per active file).
_RECORD_CHUNK = 256
_RECORD_CHUNK_BYTES = 8 << 20  # 8 MiB


class StagedBatch:
  """One staged batch: contiguous payload arena + per-record offsets.

  `arena` is a uint8 numpy array owned by Python (one memcpy out of the
  native buffer); `offsets`/`lengths` are int64 arrays indexing into
  it. `records()` materializes per-record bytes for consumers that need
  them (the Python parse fallback); the fast path hands the arrays to
  `BatchExampleParser.parse_arena` untouched.
  """

  __slots__ = ("arena", "offsets", "lengths")

  def __init__(self, arena: np.ndarray, offsets: np.ndarray,
               lengths: np.ndarray):
    self.arena = arena
    self.offsets = offsets
    self.lengths = lengths

  def __len__(self) -> int:
    return len(self.offsets)

  def records(self) -> List[bytes]:
    view = memoryview(self.arena)
    return [bytes(view[o:o + n]) for o, n in
            zip(self.offsets.tolist(), self.lengths.tolist())]


def stager_available() -> bool:
  """True when the native staging plane can be used (toolchain built)."""
  return native.available()


def stage_batches(files: Sequence[str],
                  batch_size: int,
                  cycle_length: int = 4,
                  shuffle_buffer: int = 0,
                  seed: Optional[int] = None,
                  drop_remainder: bool = True,
                  verify_crc: bool = False,
                  queue_depth: int = 2,
                  max_chunk_bytes: int = 0,
                  telemetry: bool = True) -> Iterator[StagedBatch]:
  """Streams `StagedBatch`es for ONE pass over `files` (final order:
  per-epoch file shuffling stays in the caller, keeping train-mode file
  order identical to the Python chain's). Raises IOError on corruption.

  `seed` drives the C++ reservoir shuffle (std::mt19937_64): same
  distribution as `pipeline.shuffled` and deterministic per seed, not
  the identical permutation. None seeds from the clock (train-mode
  parity with `shuffled(seed=None)`); shuffle_buffer 0 bypasses the
  shuffle entirely, so eval mode is byte-identical to the Python chain.

  `telemetry=False` skips the `data/*` metrics: their unit is pipeline
  batches, so internal consumers staging chunks (`iter_staged_records`)
  must not feed them.

  `max_chunk_bytes` > 0 byte-bounds staging (reader queues + EARLY batch
  flush at that arena size). Record-mode only: an early flush would
  break exact `batch_size` semantics, so pipeline batch staging must
  leave it 0.
  """
  if seed is None:
    seed = time.time_ns() & (2**63 - 1)
  if telemetry:
    stage_hist = obs_metrics.histogram("data/stage_ms")
    arena_hist = obs_metrics.histogram("data/arena_bytes")
    depth_gauge = obs_metrics.gauge("data/stager_queue_depth")
    batch_counter = obs_metrics.counter("data/staged_batches")
  perf_counter_ns = time.perf_counter_ns
  with native.RecordStager(list(files), batch_size=batch_size,
                           cycle_length=cycle_length,
                           shuffle_buffer=shuffle_buffer, seed=seed,
                           drop_remainder=drop_remainder,
                           verify_crc=verify_crc,
                           queue_depth=queue_depth,
                           max_chunk_bytes=max_chunk_bytes) as stager:
    while True:
      t0 = perf_counter_ns()
      out = stager.next_batch()
      if telemetry:
        stage_hist.record((perf_counter_ns() - t0) * 1e-6)
      if out is None:
        return
      arena, offsets, lengths = out
      if telemetry:
        arena_hist.record(float(arena.nbytes))
        depth_gauge.set(float(stager.queue_depth()))
        batch_counter.inc()
      yield StagedBatch(arena, offsets, lengths)


def iter_staged_records(files: Sequence[str],
                        cycle_length: int = 4,
                        verify_crc: bool = False,
                        chunk_records: int = _RECORD_CHUNK,
                        chunk_bytes: int = _RECORD_CHUNK_BYTES
                        ) -> Iterator[bytes]:
  """Record-mode streaming through the native plane (no shuffle/batch):
  byte-identical to `pipeline.interleave_records` over the same file
  order, but with the file IO, CRC and interleave running GIL-free.
  Used by consumers that must stay per-record (the weighted-mixture
  sampler, multi-dataset zip). Chunk boundaries are an implementation
  detail (`chunk_bytes` caps buffered payload regardless of record
  size); the flattened record stream is invariant to them."""
  for batch in stage_batches(files, batch_size=chunk_records,
                             cycle_length=cycle_length, shuffle_buffer=0,
                             seed=0, drop_remainder=False,
                             verify_crc=verify_crc,
                             max_chunk_bytes=chunk_bytes,
                             telemetry=False):
    yield from batch.records()
