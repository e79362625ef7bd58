"""graftloop replay sink: a bounded, byte-capped TFRecord episode store.

Counterpart of `tensor2robot_tpu.loop.replay`: the hand-off between the
actor pool and the learner. Every shard is a plain TFRecord file that a
`DefaultRecordInputGenerator` reads, but the store is BOUNDED:

* episodes append to the CURRENT shard, written under a `.tmp` name so
  the learner's glob never sees a file in progress; a shard ROTATES to
  its final `shard-%08d.tfrecord` name after `episodes_per_shard`
  episodes (flushed and closed before the rename);
* total bytes (finished shards + current) are capped at `max_bytes`.
  Over the cap, `on_full` decides:
    - `'drop_oldest'` (default, replay-buffer semantics): the oldest
      FINISHED shard is deleted, counted `loop/replay/dropped_shards`;
    - `'shed'` (strict backpressure): `append_episode` returns False,
      counted `loop/replay/shed_episodes`.
  A stalled learner costs dropped or shed episodes, counted, not host
  memory or disk.

Each shard's rotation is a graftrace instant (`loop/replay/shard`)
linked to the episode spans that fed it.

Telemetry: `loop/replay/bytes` + `loop/replay/shards` gauges;
`loop/replay/episodes`, `loop/replay/records`,
`loop/replay/shed_episodes`, `loop/replay/dropped_shards` counters.

Thread-safe (the actor pool appends concurrently); imports no torch.
"""

from __future__ import annotations

import glob as glob_lib
import os
import threading
from typing import Any, Dict, List, Optional, Sequence

from tensor2robot_tpu_torch.obs import graftrace
from tensor2robot_tpu_torch.obs import metrics as obs_metrics
from tensor2robot_tpu_torch.obs import trace as obs_trace

__all__ = ["ReplayRecordSink"]


class ReplayRecordSink:
  """Bounded byte-capped TFRecord episode sink (module docstring).

  Duck-types the `replay_writer.TFRecordReplayWriter` surface
  (`write(transitions)` / `flush()` / `close()`) so `envs.run_env`
  streams episodes into it unchanged; `append_episode` is the
  loop-native entry that also reports shed."""

  def __init__(self,
               directory: str,
               max_bytes: int = 256 << 20,
               episodes_per_shard: int = 16,
               on_full: str = "drop_oldest",
               spec_structure=None,
               name: str = "loop/replay"):
    if on_full not in ("drop_oldest", "shed"):
      raise ValueError(
          f"on_full must be 'drop_oldest' or 'shed', got {on_full!r}")
    if max_bytes < 1 or episodes_per_shard < 1:
      raise ValueError("max_bytes and episodes_per_shard must be >= 1")
    self._directory = os.path.abspath(directory)
    os.makedirs(self._directory, exist_ok=True)
    self._max_bytes = int(max_bytes)
    self._episodes_per_shard = int(episodes_per_shard)
    self._on_full = on_full
    self._spec_structure = spec_structure
    self._name = name
    self._lock = threading.Lock()
    self._closed = False
    self._writer = None  # lazy: the first episode opens shard 0
    self._shard_index = 0
    self._shard_episodes = 0
    self._shard_path: Optional[str] = None
    # Byte accounting is INCREMENTAL: per-shard sizes are stat-ed once
    # (at rotate / resume), the in-progress shard is counted from the
    # TFRecord framing (16 bytes/record + payload). The actor pool
    # appends at episode rate — an O(finished-shards) getsize sweep per
    # append monopolizes the 1-core host's syscall budget inside this
    # lock and starves the learner (observed: the whole loop wedged
    # once the store passed ~2k shards).
    self._current_bytes = 0
    self._finished_bytes = 0
    self._sizes: Dict[str, int] = {}
    self._shard_records = 0
    self._finished_records = 0
    self._record_counts: Dict[str, int] = {}
    # Causality bookkeeping (graftrace): the episode spans written into
    # the CURRENT shard, and per finished shard the span_id of its
    # `loop/replay/shard` rotation event — the edge the learner's round
    # links to (episode -> shard -> round is walkable in the timeline).
    self._episode_spans: List[str] = []
    self._shard_span_ids: Dict[str, str] = {}
    # Resume an existing directory (a restarted loop keeps its replay):
    # finished shards are inventoried; a torn `.tmp` from a crashed
    # writer is removed — it was never visible to the learner.
    self._finished: List[str] = sorted(
        glob_lib.glob(os.path.join(self._directory, "shard-*.tfrecord")))
    for path in self._finished:
      try:
        self._sizes[path] = os.path.getsize(path)
      except OSError:
        self._sizes[path] = 0
      self._finished_bytes += self._sizes[path]
    if self._finished:
      from tensor2robot_tpu_torch.data import tfrecord

      for path in self._finished:
        try:
          self._record_counts[path] = tfrecord.count_records(path)
        except (OSError, IOError):
          self._record_counts[path] = 0
        self._finished_records += self._record_counts[path]
    for stale in glob_lib.glob(
        os.path.join(self._directory, "shard-*.tfrecord.tmp")):
      try:
        os.remove(stale)
      except OSError:
        pass
    if self._finished:
      last = os.path.basename(self._finished[-1])
      self._shard_index = int(last[len("shard-"):-len(".tfrecord")]) + 1
    self._update_gauges_locked()

  # -- introspection --------------------------------------------------------

  @property
  def directory(self) -> str:
    return self._directory

  @property
  def file_patterns(self) -> str:
    """Glob for the learner's input generator: FINISHED shards only
    (the in-progress `.tmp` shard never matches)."""
    return os.path.join(self._directory, "shard-*.tfrecord")

  def finished_shards(self) -> List[str]:
    with self._lock:
      return list(self._finished)

  def shard_spans(self) -> Dict[str, str]:
    """{finished shard path: span_id of its rotation event} — the
    learner links its training round to the shards it consumed."""
    with self._lock:
      return dict(self._shard_span_ids)

  def finished_records(self) -> int:
    """Records inside FINISHED shards (what a learner's glob can read).
    The loop's data gate holds on this, not shard count alone: a single
    short shard with fewer records than one training batch makes a
    drop_remainder pipeline yield ZERO batches per epoch and spin empty
    epochs forever (warm actors rotate the first shard out almost at
    once, so a shard-count gate can pass on one 8-record file)."""
    with self._lock:
      return self._finished_records

  def total_bytes(self) -> int:
    with self._lock:
      return self._total_bytes_locked()

  def _total_bytes_locked(self) -> int:
    return self._finished_bytes + self._current_bytes

  def stats(self) -> Dict[str, Any]:
    with self._lock:
      return {
          "bytes": self._total_bytes_locked(),
          "finished_shards": len(self._finished),
          "finished_records": self._finished_records,
          "current_shard_episodes": self._shard_episodes,
      }

  def _update_gauges_locked(self) -> None:
    obs_metrics.gauge("loop/replay/bytes").set(
        float(self._total_bytes_locked()))
    obs_metrics.gauge("loop/replay/shards").set(float(len(self._finished)))

  # -- writing --------------------------------------------------------------

  def _open_shard_locked(self) -> None:
    from tensor2robot_tpu_torch.data import tfrecord

    self._shard_path = os.path.join(
        self._directory, f"shard-{self._shard_index:08d}.tfrecord.tmp")
    self._writer = tfrecord.RecordWriter(self._shard_path)
    self._shard_episodes = 0
    self._current_bytes = 0

  def _rotate_locked(self) -> None:
    """Finalizes the current shard: flush+close, rename to the learner-
    visible name. A shard the glob matches is complete by construction."""
    if self._writer is None:
      return
    self._writer.flush()
    self._writer.close()
    final = self._shard_path[:-len(".tmp")]
    os.replace(self._shard_path, final)
    self._finished.append(final)
    try:
      # One stat per SHARD (not per append): the framing estimate the
      # in-progress accounting used is replaced by the on-disk truth.
      self._sizes[final] = os.path.getsize(final)
    except OSError:
      self._sizes[final] = self._current_bytes
    self._finished_bytes += self._sizes[final]
    self._record_counts[final] = self._shard_records
    self._finished_records += self._shard_records
    # Rotation is the shard's causal birth: one instant event whose
    # `links` are the episode spans that fed it — the timeline edge
    # from each actor's collect to this shard.
    shard_ctx = graftrace.mint()
    self._shard_span_ids[final] = shard_ctx.span_id
    obs_trace.instant(
        "loop/replay/shard", cat="loop",
        shard=os.path.basename(final), records=self._shard_records,
        links=list(self._episode_spans), **shard_ctx.args())
    self._episode_spans = []
    self._writer = None
    self._shard_path = None
    self._shard_index += 1
    self._shard_episodes = 0
    self._shard_records = 0
    self._current_bytes = 0

  def _enforce_cap_locked(self) -> bool:
    """True when the append may proceed; False = shed. drop_oldest
    deletes finished shards (never the in-progress one) until under
    cap — if there is nothing left to drop the episode still flows (the
    cap then bounds to ~one shard)."""
    while self._total_bytes_locked() > self._max_bytes:
      if self._on_full == "shed":
        obs_metrics.counter("loop/replay/shed_episodes").inc()
        return False
      if not self._finished:
        break
      oldest = self._finished.pop(0)
      self._finished_bytes -= self._sizes.pop(oldest, 0)
      self._finished_records -= self._record_counts.pop(oldest, 0)
      self._shard_span_ids.pop(oldest, None)
      try:
        os.remove(oldest)
      except OSError:
        pass
      obs_metrics.counter("loop/replay/dropped_shards").inc()
    return True

  def append_episode(self, transitions: Sequence[Any],
                     trace_ctx=None) -> bool:
    """Appends one episode's transitions (mappings for
    `codec.encode_example`, or pre-serialized bytes). Returns False
    when the episode was SHED under the byte cap (`on_full='shed'`).

    `trace_ctx` (a `graftrace.TraceContext`, default: the thread's
    active context — `run_env` streams through `write()` inside the
    actor's `loop/episode` activation) attributes the episode to its
    collect span; the shard rotation event links them."""
    if not transitions:
      return True
    if trace_ctx is None:
      trace_ctx = graftrace.current()
    payloads = [t if isinstance(t, bytes) else self._encode(t)
                for t in transitions]
    with self._lock:
      if self._closed:
        raise RuntimeError("replay sink is closed")
      if not self._enforce_cap_locked():
        return False
      if self._writer is None:
        self._open_shard_locked()
      if trace_ctx is not None:
        self._episode_spans.append(trace_ctx.span_id)
      for payload in payloads:
        self._writer.write(payload)
        # TFRecord framing: u64 length + 2x masked crc32 = 16 bytes.
        self._current_bytes += len(payload) + 16
      self._shard_records += len(payloads)
      self._shard_episodes += 1
      obs_metrics.counter("loop/replay/episodes").inc()
      obs_metrics.counter("loop/replay/records").inc(len(payloads))
      if self._shard_episodes >= self._episodes_per_shard:
        self._rotate_locked()
      self._update_gauges_locked()
    return True

  def _encode(self, transition) -> bytes:
    # Imported here: the codec brings torch, which bytes payloads skip.
    from tensor2robot_tpu_torch.data import codec

    return codec.encode_example(transition, self._spec_structure)

  # replay_writer duck-type: run_env's `replay_writer=` seam.
  def write(self, transitions: Sequence[Any]) -> None:
    self.append_episode(transitions)

  def flush(self) -> None:
    """Finalizes the in-progress shard so the learner sees everything
    collected so far (an explicit epoch boundary, e.g. before the first
    training round)."""
    with self._lock:
      if self._shard_episodes > 0:
        self._rotate_locked()
      self._update_gauges_locked()

  def close(self) -> None:
    with self._lock:
      if self._closed:
        return
      if self._shard_episodes > 0:
        self._rotate_locked()
      elif self._writer is not None:
        # Empty in-progress shard: discard, never publish a 0-record file.
        self._writer.close()
        try:
          os.remove(self._shard_path)
        except OSError:
          pass
        self._writer = None
        self._shard_path = None
        self._current_bytes = 0
        self._shard_records = 0
      self._closed = True
      self._update_gauges_locked()

  def __enter__(self) -> "ReplayRecordSink":
    return self

  def __exit__(self, *exc) -> None:
    self.close()
