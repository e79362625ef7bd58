"""Session serving: device-resident decode caches for O(1) ticks.

Counterpart of `tensor2robot_tpu.serving.session`.

`SessionEngine` serves each robot episode as one session whose decode
state lives on the device between control ticks:

* the ARENA: a dict of device tensors whose leading dim is
  max_sessions + 1, built from the model's `init_session_state`. Slot 0
  is the reserved NULL slot: pad lanes of a partial bucket ride it with
  mask False and change nothing. The arena is updated IN PLACE, never
  copied per tick, on one of two paths, as the model offers:
  - a KV arena (`SequenceRegressionModel`): the model's
    `decode_arena_fn`, the fused decode-tick kernel per attention block
    and an in-place index advance;
  - any other session state (the LSTM carry of `LSTMRegressionModel`):
    the lanes' slots are gathered, the model's `decode_fn` runs one
    tick on them, and the new rows are scattered back where the mask is
    set (a pad lane writes back the null slot's own values);
* a bucket ladder (1, 2, 4, ..., max_tick_batch): a tick of n sessions
  runs at the smallest bucket >= n, the rest pad lanes;
* session lifecycle: `open()` admits, or under slot pressure evicts the
  least-recently ticked idle session (`admission='evict_lru'`) or refuses
  (`admission='shed'`); `step` / `step_many` advance one tick;
  `close_session()` frees the slot once any tick that includes the
  session has finished;
* the horizon guard: a session that has run `max_ticks` ticks (the KV
  capacity) gets `SessionHorizonError` instead of a tick. On the card an
  index past the horizon is a write into another slot's rows, so the
  guard runs before every dispatch;
* `restore()` hot-swap: parameters are read through the bundle's state
  getter at every dispatch, so a swap lands on the next tick while the
  open sessions keep their caches.

`SessionBatcher` is the continuous-batching front: concurrent per-robot
`step()` calls coalesce into one `step_many`, with session affinity (a
session appears at most once per dispatch).

Telemetry (`obs.metrics`): serve/session/active, slot_occupancy,
cache_bytes (gauges); tick_ms (histogram); opens, closes, evictions,
shed, ticks, dispatches, padded_lanes, shed_queue_full, fetched_bytes
(counters). Each `step_many` is a `serve/session/step` span (`obs.trace`)
tiled by six children: admit (the lifecycle and horizon guards, the
slots), stack (the feature stack), h2d (the three copies in), dispatch
(the tick), fetch (each output's copy back, which waits for the device)
and book (the bookkeeping and the per-session results). `SessionBatcher`
adds the JAX package's request tracing (`obs.graftrace`): a context per
tick at admission, a `serve/session/batch` span per dispatch whose
`links` name its ticks, the `queue_wait` and `dispatch` stages per tick,
a `usage=(busy_s, ticks)` call per dispatch, and a shard flush when its
worker ends.

With `cache` (an `obs.excache.ExecutableCache` or a directory) every
decode rung and the slot reset are compiled (`obs.xray.analyze_jit` under
`<cache_namespace>/decode<rung>` and `<cache_namespace>/reset_slot`; the
arena is an input the graph updates in place, through the registered
operator `t2r::decode_tick` on the KV path), their artifacts loaded from
or stored into the cache; `rung_traces`, `rung_cache_keys`,
`compile_records` and `warmup_provenance` describe them as the JAX
engine's do. Without one the rungs and the reset run eagerly.
"""

from __future__ import annotations

import collections
import functools
import itertools
import threading
import time
from typing import (Any, Callable, Dict, List, Mapping, Optional, Sequence,
                    Tuple)

import numpy as np
import torch

from tensor2robot_tpu_torch.obs import excache as excache_lib
from tensor2robot_tpu_torch.obs import graftrace
from tensor2robot_tpu_torch.obs import metrics as obs_metrics
from tensor2robot_tpu_torch.obs import trace as obs_trace
from tensor2robot_tpu_torch.obs import xray as obs_xray
from tensor2robot_tpu_torch.serving import batcher as batcher_lib
from tensor2robot_tpu_torch.serving import engine as engine_lib
from tensor2robot_tpu_torch.utils import config
from tensor2robot_tpu_torch.utils import device as device_lib

__all__ = ["SessionEngine", "SessionBatcher", "SessionError",
           "SessionShedError", "SessionEvictedError",
           "UnknownSessionError", "SessionClosedError",
           "SessionHorizonError"]


class SessionError(RuntimeError):
  """Base of the session-lifecycle error family."""

  def __init__(self, message: str, session_id: Optional[int] = None):
    super().__init__(message)
    self.session_id = session_id


class SessionShedError(SessionError):
  """Admission refused: no free slot and nothing evictable."""


class SessionEvictedError(SessionError):
  """The session's slot was reclaimed under pressure; its next step
  fails with this so the robot re-opens instead of silently continuing
  on another episode's cache."""


class UnknownSessionError(SessionError):
  """step/close on a session id this engine never opened (or already
  closed and forgot)."""


class SessionClosedError(SessionError):
  """step on a session after close()."""


class SessionHorizonError(SessionError):
  """The episode outran the model's decode horizon (KV-cache capacity).
  A tick past it would write past the session's cache rows."""


# Terminal session ids (closed / evicted) remembered for precise error
# messages; bounded, so a long-running server does not grow one entry per
# episode forever. A forgotten id degrades to UnknownSessionError.
_TERMINAL_IDS_CAP = 4096


# The arena's position among the arguments of a tick and of the reset:
# the graph updates it in place.
_ARENA_ARGNUMS = {False: (1,), True: (0,)}


def _tick(bundle, state, arena: Dict[str, torch.Tensor], slots: torch.Tensor,
          features, mask: torch.Tensor):
  """One tick of the lanes `slots` (mask False on pad lanes, which ride
  the null slot) against `arena`, in place; returns the outputs: the KV
  path's `decode_arena_fn`, or gather, `decode_fn` and a masked scatter
  for any other session state."""
  if bundle.decode_arena_fn is not None:
    return bundle.decode_arena_fn(state, arena, slots, features, mask)[1]
  slots = slots.long()
  gathered = {k: leaf[slots] for k, leaf in arena.items()}
  new_state, outputs = bundle.decode_fn(state, gathered, features)
  for key, leaf in arena.items():
    keep = mask.reshape(mask.shape + (1,) * (leaf.ndim - 1))
    leaf.index_copy_(0, slots, torch.where(
        keep, new_state[key].to(leaf.dtype), gathered[key]))
  return outputs


def _reset_slot(arena: Dict[str, torch.Tensor], slot: torch.Tensor) -> None:
  """Zeroes the arena rows of `slot` ([1] int64) in place."""
  for leaf in arena.values():
    leaf.index_fill_(0, slot, 0)


@config.configurable
class SessionEngine:
  """Stateful session serving over a predictor's decode bundle (module
  docstring). Runs on `device` (CUDA unless given), which must be the
  predictor's."""

  def __init__(self, predictor=None,
               max_sessions: int = 64,
               max_tick_batch: int = 8,
               buckets: Optional[Sequence[int]] = None,
               admission: str = "evict_lru",
               device=None,
               cache=None,
               cache_namespace: str = "serve/session"):
    if predictor is None:
      raise ValueError("predictor is required.")
    if max_sessions < 1:
      raise ValueError(f"max_sessions must be >= 1, got {max_sessions}")
    if admission not in ("evict_lru", "shed"):
      raise ValueError(f"admission must be 'evict_lru' or 'shed', "
                       f"got {admission!r}")
    self._device = device_lib.resolve_device(device)
    if not device_lib.same_device(self._device,
                                  getattr(predictor, "device", None)):
      raise ValueError(f"the engine runs on {self._device} but the "
                       f"predictor holds its state on "
                       f"{getattr(predictor, 'device', None)}")
    self._predictor = predictor
    self._max_sessions = max_sessions
    if buckets is not None:
      buckets = sorted(set(int(b) for b in buckets))
      if not buckets or buckets[0] < 1:
        raise ValueError(f"buckets must be positive ints, got {buckets}")
      max_tick_batch = buckets[-1]
    else:
      buckets = engine_lib.bucket_ladder(max_tick_batch)
    if max_tick_batch > max_sessions:
      raise ValueError(
          f"max_tick_batch {max_tick_batch} exceeds max_sessions "
          f"{max_sessions}: a dispatch can never gather that many "
          "distinct live slots")
    self._buckets = buckets
    self._max_tick_batch = max_tick_batch
    self._admission = admission
    # Host bookkeeping (self._lock): slot table + LRU + in-flight set.
    self._lock = threading.Lock()
    self._idle = threading.Condition(self._lock)
    self._slots: Dict[int, int] = {}  # session_id -> arena slot
    self._free: List[int] = list(range(1, max_sessions + 1))  # 0 = null
    self._last_tick: Dict[int, float] = {}
    self._tick_count: Dict[int, int] = {}
    self._in_flight: set = set()
    self._evicted: set = set()
    self._evicted_order: "collections.deque[int]" = collections.deque()
    self._closed_ids: set = set()
    self._closed_order: "collections.deque[int]" = collections.deque()
    self._next_id = itertools.count(1)
    # Device state (self._arena_lock): every arena touch serializes, as
    # the dispatches update it in place.
    self._arena_lock = threading.Lock()
    self._arena: Optional[Dict[str, torch.Tensor]] = None
    self._bundle = None
    self._max_ticks: Optional[int] = None
    self._cache = cache
    self._cache_namespace = cache_namespace
    # Compiled per rung ('reset' for the slot reset), with provenance.
    self._compiled: Dict[Any, Any] = {}
    self._records: Dict[Any, Dict[str, Any]] = {}
    self._warmup_provenance: List[Dict[str, Any]] = []

  @property
  def buckets(self) -> List[int]:
    return list(self._buckets)

  @property
  def max_sessions(self) -> int:
    return self._max_sessions

  @property
  def max_tick_batch(self) -> int:
    return self._max_tick_batch

  @property
  def device(self) -> torch.device:
    return self._device

  @property
  def active_sessions(self) -> int:
    with self._lock:
      return len(self._slots)

  @property
  def arena(self) -> Optional[Dict[str, torch.Tensor]]:
    """The arena tensors (None before warmup); updated in place."""
    return self._arena

  @property
  def cache_bytes(self) -> int:
    """Device bytes held by the session arena."""
    if self._arena is None:
      return 0
    return sum(t.numel() * t.element_size() for t in self._arena.values())

  # -- warmup ---------------------------------------------------------------

  def _load_bundle(self):
    return self._predictor.decode_bundle()

  def _dispatch(self, bundle, state, slots: torch.Tensor, features,
                mask: torch.Tensor):
    """One tick of the lanes `slots` (mask False on pad lanes, which ride
    the null slot) against the arena, in place, on the bucket's compiled
    rung where there is one; returns the outputs. The caller holds
    _arena_lock."""
    tick = self._compiled.get(int(slots.shape[0]))
    if tick is None:
      return _tick(bundle, state, self._arena, slots, features, mask)
    return tick(state, self._arena, slots, features, mask)

  def _build_arena_locked(self) -> bool:
    """Loads the decode bundle and builds the arena on the device, once
    (caller holds _arena_lock); True when this call built it. Runs no
    tick."""
    if self._bundle is None:
      self._bundle = self._load_bundle()
      self._max_ticks = self._bundle.max_ticks
    if self._arena is not None:
      return False
    self._arena = self._bundle.init_session_state(self._max_sessions + 1)
    obs_metrics.gauge("serve/session/cache_bytes").set(
        float(self.cache_bytes))
    return True

  def rung_traces(self) -> List[Tuple[Any, Callable, Tuple]]:
    """`[(rung, function, args), ...]` for every decode rung and the slot
    reset ('reset'): what warmup runs and compiles, without running it
    (the arena, which the args hold, is built here when absent; no tick
    runs)."""
    with self._arena_lock:
      self._build_arena_locked()
      return self._rung_traces_locked()

  def _rung_traces_locked(self) -> List[Tuple[Any, Callable, Tuple]]:
    traces = [(bucket, functools.partial(_tick, self._bundle),
               self._rung_args(bucket)) for bucket in self._buckets]
    traces.append(("reset", _reset_slot,
                   (self._arena, torch.zeros((1,), dtype=torch.int64,
                                             device=self._device))))
    return traces

  def _rung_args(self, bucket: int) -> Tuple:
    """An all-pad tick of `bucket` lanes on the null slot (it writes
    nothing)."""
    features = {k: torch.zeros((bucket,) + tuple(spec.shape),
                               dtype=torch.float32, device=self._device)
                for k, spec in self._bundle.observation_spec.items()}
    slots = torch.zeros((bucket,), dtype=torch.int32, device=self._device)
    mask = torch.zeros((bucket,), dtype=torch.bool, device=self._device)
    return (self._bundle.get_state(), self._arena, slots, features, mask)

  def _rung_name(self, rung) -> str:
    return (f"{self._cache_namespace}/reset_slot" if rung == "reset"
            else f"{self._cache_namespace}/decode{rung}")

  def rung_cache_keys(self) -> Dict[Any, str]:
    """The graftcache key of every rung and the reset WITHOUT compiling
    (graftforge `--verify`)."""
    model = getattr(self._predictor, "model", None)
    return {rung: obs_xray.step_cache_key(
        self._rung_name(rung), args, model,
        _ARENA_ARGNUMS[rung == "reset"])[0]
            for rung, _, args in self.rung_traces()}

  @property
  def compile_records(self) -> List[Dict[str, Any]]:
    """The xray records of the compiled rungs and reset."""
    return [dict(r) for r in self._records.values()]

  @property
  def warmup_provenance(self) -> List[Dict[str, Any]]:
    """Per rung and the reset: `{rung, source, ms, key}` (the sources of
    `BucketedEngine.warmup_provenance`)."""
    return [dict(p) for p in self._warmup_provenance]

  def warmup(self) -> "SessionEngine":
    """Builds the arena on the device and runs one all-pad tick per
    bucket on the null slot (which writes nothing), and with a cache
    compiles each rung and the slot reset, so the kernels are built and
    loaded before the first real tick. Idempotent."""
    with self._arena_lock:
      if not self._build_arena_locked():
        return self
      cache = excache_lib.as_cache(self._cache)
      model = getattr(self._predictor, "model", None)
      for rung, fn, args in self._rung_traces_locked():
        start = time.perf_counter()
        source, record = "eager", {}
        with torch.no_grad():
          if cache is None:
            if rung != "reset":
              fn(*args)
          else:
            xf = obs_xray.XrayedFunction(
                self._rung_name(rung), fn, cache=cache, model=model,
                donate_argnums=_ARENA_ARGNUMS[rung == "reset"])
            xf(*args)
            if xf.compiled:
              self._compiled[rung] = xf
              record = self._records[rung] = xf.record
              source = ("cache" if (record.get("cache") or {}).get("hit")
                        else "compile")
            else:
              source = "fallback"
        self._warmup_provenance.append(
            {"rung": rung, "source": source,
             "ms": (time.perf_counter() - start) * 1e3,
             "key": (record.get("cache") or {}).get("key")})
    return self

  # -- lifecycle ------------------------------------------------------------

  def open(self) -> int:
    """Admits a new session; returns its id. Under slot pressure either
    evicts the least-recently-ticked idle session (`evict_lru`) or
    refuses (`shed`); an in-flight session is never evicted."""
    if self._arena is None:
      self.warmup()
    with self._lock:
      if not self._free:
        victim = (self._pick_victim_locked()
                  if self._admission == "evict_lru" else None)
        if victim is None:
          obs_metrics.counter("serve/session/shed").inc()
          raise SessionShedError(
              f"all {self._max_sessions} slots are held"
              + (" and nothing is evictable" if self._admission
                 == "evict_lru" else " (admission='shed')")
              + "; shedding the open()")
        self._evict_locked(victim)
      slot = self._free.pop()
      sid = next(self._next_id)
      self._slots[sid] = slot
      self._last_tick[sid] = time.monotonic()
      self._tick_count[sid] = 0
      # In flight until the slot reset lands: a concurrent open() under
      # pressure must not evict this new session and reuse its slot.
      self._in_flight.add(sid)
      obs_metrics.counter("serve/session/opens").inc()
      self._occupancy_locked()
    try:
      with self._arena_lock:
        self._reset_slot(slot)
    except BaseException:
      # A failed reset must not strand a ghost session that nothing will
      # ever close.
      with self._lock:
        if self._slots.get(sid) == slot:
          self._slots.pop(sid)
          self._free.append(slot)
          self._last_tick.pop(sid, None)
          self._tick_count.pop(sid, None)
          self._occupancy_locked()
      raise
    finally:
      with self._idle:
        self._in_flight.discard(sid)
        self._idle.notify_all()
    return sid

  def _reset_slot(self, slot: int) -> None:
    """Zeroes one arena slot in place, on the compiled reset where there
    is one (caller holds _arena_lock)."""
    reset = self._compiled.get("reset", _reset_slot)
    with torch.no_grad():  # as at warmup: a compiled graph guards on it
      reset(self._arena, torch.full((1,), slot, dtype=torch.int64,
                                    device=self._device))

  def _pick_victim_locked(self) -> Optional[int]:
    candidates = [sid for sid in self._slots if sid not in self._in_flight]
    if not candidates:
      return None
    return min(candidates, key=lambda sid: self._last_tick[sid])

  @staticmethod
  def _remember_terminal(ids: set, order: "collections.deque[int]",
                         sid: int) -> None:
    ids.add(sid)
    order.append(sid)
    while len(order) > _TERMINAL_IDS_CAP:
      ids.discard(order.popleft())

  def _evict_locked(self, sid: int) -> None:
    slot = self._slots.pop(sid)
    self._free.append(slot)
    self._remember_terminal(self._evicted, self._evicted_order, sid)
    self._last_tick.pop(sid, None)
    self._tick_count.pop(sid, None)
    obs_metrics.counter("serve/session/evictions").inc()

  def _occupancy_locked(self) -> None:
    obs_metrics.gauge("serve/session/active").set(float(len(self._slots)))
    obs_metrics.gauge("serve/session/slot_occupancy").set(
        len(self._slots) / self._max_sessions)

  def close_session(self, session_id: int) -> None:
    """Frees the session's slot, after any dispatch that includes it
    completes."""
    with self._idle:
      while session_id in self._in_flight:
        self._idle.wait(timeout=0.1)
      if session_id in self._evicted:
        self._evicted.discard(session_id)
        return
      if session_id in self._closed_ids:
        return
      if session_id not in self._slots:
        raise UnknownSessionError(f"unknown session {session_id}",
                                  session_id)
      slot = self._slots.pop(session_id)
      self._free.append(slot)
      self._remember_terminal(self._closed_ids, self._closed_order,
                              session_id)
      self._last_tick.pop(session_id, None)
      self._tick_count.pop(session_id, None)
      obs_metrics.counter("serve/session/closes").inc()
      self._occupancy_locked()

  def session_ticks(self, session_id: int) -> int:
    with self._lock:
      if session_id not in self._tick_count:
        raise UnknownSessionError(f"unknown session {session_id}",
                                  session_id)
      return self._tick_count[session_id]

  # -- decode ---------------------------------------------------------------

  def _check_sid_locked(self, sid: int) -> None:
    if sid in self._evicted:
      raise SessionEvictedError(
          f"session {sid} was evicted under slot pressure; re-open and "
          "replay or restart the episode", sid)
    if sid in self._closed_ids:
      raise SessionClosedError(f"session {sid} is closed", sid)
    if sid not in self._slots:
      raise UnknownSessionError(f"unknown session {sid}", sid)

  def step(self, session_id: int, features: Mapping[str, Any]
           ) -> Dict[str, np.ndarray]:
    """Advances ONE session one tick; returns its per-tick outputs."""
    return self.step_many([(session_id, features)])[0]

  def step_many(self, items: Sequence[Tuple[int, Mapping[str, Any]]]
                ) -> List[Dict[str, np.ndarray]]:
    """Advances several DISTINCT sessions one tick in one dispatch.

    Items must name distinct sessions and at most `max_tick_batch` of
    them. Lifecycle errors and the horizon guard raise before any device
    work.
    """
    if not items:
      return []
    phases = obs_trace.phases("serve/session/step", "serve/session/admit",
                              cat="serve")
    try:
      return self._step_many(items, phases)
    finally:
      phases.end()

  def _step_many(self, items: Sequence[Tuple[int, Mapping[str, Any]]],
                 phases: obs_trace.Phases) -> List[Dict[str, np.ndarray]]:
    """`step_many`'s body, cut into the children of its
    `serve/session/step` span: admit, stack, h2d, dispatch, fetch,
    book."""
    if len(items) > self._max_tick_batch:
      raise ValueError(f"{len(items)} session steps exceed "
                       f"max_tick_batch {self._max_tick_batch}")
    sids = [sid for sid, _ in items]
    if len(set(sids)) != len(sids):
      raise ValueError("step_many items must name distinct sessions "
                       "(queued ticks of one session serialize)")
    if self._arena is None:
      self.warmup()
    start = time.perf_counter()
    with self._lock:
      for sid in sids:
        self._check_sid_locked(sid)
        if (self._max_ticks is not None
            and self._tick_count[sid] >= self._max_ticks):
          raise SessionHorizonError(
              f"session {sid} has run {self._tick_count[sid]} ticks — "
              f"the model's decode horizon (KV capacity) is "
              f"{self._max_ticks}; close and re-open the episode", sid)
        if sid in self._in_flight:
          raise SessionError(
              f"session {sid} already has a step in flight; an "
              "episode's ticks must serialize (use SessionBatcher for "
              "concurrent callers)", sid)
      slots = [self._slots[sid] for sid in sids]
      self._in_flight.update(sids)
    ticked = False
    try:
      phases.next("serve/session/stack")
      n = len(items)
      bucket = self._bucket_for(n)
      if bucket != n:
        obs_metrics.counter("serve/session/padded_lanes").inc(bucket - n)
      slot_arr = np.zeros((bucket,), np.int32)
      slot_arr[:n] = slots
      mask = np.zeros((bucket,), bool)
      mask[:n] = True
      features = self._stack_features([f for _, f in items], bucket)
      bundle = self._bundle
      state = bundle.get_state()
      with self._arena_lock, torch.no_grad():
        phases.next("serve/session/h2d")
        device_slots = torch.from_numpy(slot_arr).to(self._device)
        device_features = {k: torch.from_numpy(v).to(self._device)
                           for k, v in features.items()}
        device_mask = torch.from_numpy(mask).to(self._device)
        phases.next("serve/session/dispatch", sessions=n, bucket=bucket)
        outputs = self._dispatch(bundle, state, device_slots,
                                 device_features, device_mask)
        # The arena has advanced: the bookkeeping advances with it even if
        # the fetch below fails, or a retry would append twice and the
        # horizon guard would under-count.
        ticked = True
        phases.next("serve/session/fetch")
        fetched = {k: v.cpu().numpy() for k, v in outputs.items()}
        obs_metrics.counter("serve/session/fetched_bytes").inc(
            sum(v.nbytes for v in fetched.values()))
      phases.next("serve/session/book")
      return [{k: v[i] for k, v in fetched.items()} for i in range(n)]
    finally:
      now = time.monotonic()
      with self._idle:
        for sid in sids:
          self._in_flight.discard(sid)
          if ticked and sid in self._tick_count:
            self._last_tick[sid] = now
            self._tick_count[sid] += 1
        self._idle.notify_all()
      if ticked:
        obs_metrics.histogram("serve/session/tick_ms").record(
            (time.perf_counter() - start) * 1e3)
        obs_metrics.counter("serve/session/ticks").inc(len(items))
        obs_metrics.counter("serve/session/dispatches").inc()

  def _bucket_for(self, rows: int) -> int:
    for bucket in self._buckets:
      if bucket >= rows:
        return bucket
    raise AssertionError(f"no bucket covers {rows} rows")  # guarded above

  @staticmethod
  def _stack_features(feature_dicts: List[Mapping[str, Any]],
                      bucket: int) -> Dict[str, np.ndarray]:
    """[B=bucket] feature stack; pad lanes repeat row 0 (their outputs
    are dropped and they write nothing)."""
    out = {}
    for key in dict(feature_dicts[0]):
      stack = np.stack([np.asarray(dict(f)[key], np.float32)
                        for f in feature_dicts], axis=0)
      if bucket != len(feature_dicts):
        pad = np.broadcast_to(stack[:1],
                              (bucket - len(feature_dicts),) + stack.shape[1:])
        stack = np.concatenate([stack, pad], axis=0)
      out[key] = stack
    return out

  # -- predictor passthroughs -----------------------------------------------

  def restore(self) -> bool:
    """Hot-swaps parameters under live sessions: the arena is untouched,
    open sessions keep their caches, and the next tick runs under the
    new parameters."""
    ok = self._predictor.restore()
    if ok and self._bundle is not None:
      bundle = self._load_bundle()
      with self._arena_lock:
        self._bundle, self._max_ticks = bundle, bundle.max_ticks
    return ok

  @property
  def global_step(self) -> int:
    return self._predictor.global_step

  def close(self) -> None:
    self._predictor.close()


class SessionBatcher:
  """Continuous-batching front of a `SessionEngine`: concurrent
  per-robot `step(session_id, obs)` calls coalesce into `step_many`
  dispatches, with session AFFINITY — a session appears at most once per
  dispatch, so one episode's queued ticks keep their order.

  `open` / `close_session` / `restore` pass through to the engine;
  `close()` joins the worker and fails still-queued ticks with
  `ShutdownError`.
  """

  def __init__(self, engine: Optional[SessionEngine] = None,
               max_delay_ms: float = 2.0,
               max_queue: int = 256,
               usage: Optional[Callable[[float, int], None]] = None):
    if engine is None:
      raise ValueError("engine is required.")
    self._engine = engine
    self._max_delay_s = max_delay_ms / 1e3
    self._max_queue = max_queue
    # Device-time ledger hook (same `(busy_s, requests)` contract as
    # `MicroBatcher`): one call per step_many dispatch window.
    self._usage = usage
    self._pending: "collections.deque[_TickRequest]" = collections.deque()
    self._lock = threading.Lock()
    self._have_work = threading.Condition(self._lock)
    self._closed = False
    self._phase = "idle"
    self._worker = threading.Thread(target=self._run, daemon=True,
                                    name="session-batcher")
    self._worker.start()

  # -- client side ----------------------------------------------------------

  def open(self) -> int:
    return self._engine.open()

  def close_session(self, session_id: int) -> None:
    self._engine.close_session(session_id)

  def step(self, session_id: int, features: Mapping[str, Any]
           ) -> Dict[str, np.ndarray]:
    request = _TickRequest(session_id, dict(features),
                           ctx=graftrace.request_context())
    with self._have_work:
      if self._closed:
        raise batcher_lib.ShutdownError("session batcher is closed")
      if len(self._pending) >= self._max_queue:
        obs_metrics.counter("serve/session/shed_queue_full").inc()
        raise batcher_lib.ShedError(
            f"session tick queue full ({self._max_queue} pending)")
      was_empty = not self._pending
      self._pending.append(request)
      if was_empty:
        self._have_work.notify()
    request.event.wait()
    if request.error is not None:
      raise request.error
    return request.result

  # -- worker side ----------------------------------------------------------

  def _gather(self) -> Optional[List["_TickRequest"]]:
    """Next affinity-respecting batch: up to the engine's max_tick_batch
    DISTINCT sessions, flushed `max_delay_s` after the oldest pending
    tick. A second tick of a session already in the batch stays queued
    for the next dispatch."""
    with self._have_work:
      while not self._pending:
        if self._closed:
          return None
        self._phase = "idle"
        self._have_work.wait(timeout=0.1)
      if self._closed:
        return None
      self._phase = "gather"
      flush_at = self._pending[0].enqueued_s + self._max_delay_s
      limit = self._engine.max_tick_batch
      while len(self._pending) < limit and not self._closed:
        remaining = flush_at - time.monotonic()
        if remaining <= 0:
          break
        self._have_work.wait(timeout=remaining)
      if self._closed:
        return None
      batch: List[_TickRequest] = []
      seen: set = set()
      kept: List[_TickRequest] = []
      while self._pending and len(batch) < limit:
        request = self._pending.popleft()
        if request.session_id in seen:
          kept.append(request)  # affinity: serialize same-session ticks
          continue
        seen.add(request.session_id)
        request.pop_ns = time.perf_counter_ns()
        batch.append(request)
      for request in reversed(kept):
        self._pending.appendleft(request)
      return batch

  def _serve_batch(self, batch: List["_TickRequest"]) -> None:
    self._phase = "dispatch"
    try:
      items = [(r.session_id, r.features) for r in batch]
      dispatch_ns = time.perf_counter_ns()
      # A fresh batch-level context whose span `links` name every tick:
      # the merged timeline draws one flow arrow per tick into the
      # shared dispatch.
      batch_ctx = graftrace.mint()
      try:
        with graftrace.activate(batch_ctx):
          with obs_trace.span(
              "serve/session/batch", cat="serve", ticks=len(batch),
              links=[r.ctx.span_id for r in batch if r.ctx is not None]):
            results = self._engine.step_many(items)
      except SessionError as e:
        # A lifecycle error names ONE session: fail that tick, retry the
        # rest once as a batch.
        bad = [r for r in batch if r.session_id == e.session_id]
        rest = [r for r in batch if r.session_id != e.session_id]
        if not bad:
          raise
        for request in bad:
          request.complete(error=e)
        if rest:
          self._serve_batch(rest)
        return
      end_ns = time.perf_counter_ns()
      graftrace.record_stage_many(
          "queue_wait",
          [(r.pop_ns - r.enq_ns) / 1e6 for r in batch if r.pop_ns])
      graftrace.record_stage_many(
          "dispatch", [(end_ns - dispatch_ns) / 1e6] * len(batch))
      if self._usage is not None:
        self._usage((end_ns - dispatch_ns) / 1e9, len(batch))
      if obs_trace.get_tracer().enabled:
        for r in batch:
          if r.ctx is None:
            continue
          if r.pop_ns:
            obs_trace.add_complete(
                "serve/stage/queue_wait", r.enq_ns, r.pop_ns - r.enq_ns,
                cat="serve", args=r.ctx.args())
          obs_trace.add_complete(
              "serve/stage/dispatch", dispatch_ns, end_ns - dispatch_ns,
              cat="serve", args=r.ctx.args())
      for request, result in zip(batch, results):
        request.complete(result=result)
    finally:
      self._phase = "gather"

  def _run(self) -> None:
    try:
      while True:
        batch = self._gather()
        if batch is None:
          return
        if not batch:
          continue
        try:
          self._serve_batch(batch)
        except BaseException as e:  # noqa: BLE001 - fan out to callers
          for request in batch:
            if not request.event.is_set():
              request.complete(error=e)
    finally:
      self._phase = "done"
      with self._have_work:
        self._closed = True
        pending = list(self._pending)
        self._pending.clear()
      for request in pending:
        request.complete(
            error=batcher_lib.ShutdownError("session batcher worker exited"))
      graftrace.flush()  # teardown drain (no-op unless configured)

  # -- lifecycle ------------------------------------------------------------

  def restore(self) -> bool:
    return self._engine.restore()

  def warmup(self) -> None:
    self._engine.warmup()

  @property
  def global_step(self) -> int:
    return self._engine.global_step

  def close(self, timeout: float = 60.0) -> None:
    """Stops and joins the worker. A worker mid-dispatch is waited out
    (its tick is in flight on the device); in any other phase it sees
    the close flag within 0.1 s."""
    with self._have_work:
      if self._closed and not self._worker.is_alive():
        return
      self._closed = True
      self._have_work.notify_all()
    deadline = None
    while True:
      self._worker.join(timeout=1.0)
      if not self._worker.is_alive():
        return
      if self._phase == "dispatch":
        deadline = None
        continue
      if deadline is None:
        deadline = time.monotonic() + timeout
      elif time.monotonic() >= deadline:
        raise RuntimeError(
            f"SessionBatcher.close(): worker still alive after "
            f"{timeout:.0f}s in phase {self._phase!r}")

  def __enter__(self) -> "SessionBatcher":
    return self

  def __exit__(self, exc_type, exc_value, traceback) -> bool:
    self.close()
    return False


class _TickRequest:
  """One queued session tick: features, result slot, completion event,
  its graftrace context and its enqueue/pop perf-clock stamps."""

  __slots__ = ("session_id", "features", "enqueued_s", "event", "result",
               "error", "ctx", "enq_ns", "pop_ns")

  def __init__(self, session_id: int, features: Dict[str, Any],
               ctx: Optional[graftrace.TraceContext] = None):
    self.session_id = session_id
    self.features = features
    self.enqueued_s = time.monotonic()
    self.event = threading.Event()
    self.result: Optional[Dict[str, np.ndarray]] = None
    self.error: Optional[BaseException] = None
    self.ctx = ctx
    self.enq_ns = time.perf_counter_ns()
    self.pop_ns = 0

  def complete(self, result=None, error=None) -> None:
    self.result = result
    self.error = error
    self.event.set()
