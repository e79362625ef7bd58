"""The micro-batcher: coalesces concurrent predicts into batches.

Counterpart of `tensor2robot_tpu.serving.batcher`. Every robot or client
that calls `predict()` alone pays one full dispatch; `MicroBatcher`
turns N concurrent requests into ONE padded dispatch, dividing the
per-dispatch overhead by N. It never imports torch: the wrapped
`backend` callable owns the device.

* a bounded request queue (`max_queue`): a full queue SHEDS the new
  request immediately (`ShedError`, `serve/batcher/shed_queue_full`)
  instead of queueing unboundedly: admission control, not backlog;
* a single dispatch worker gathers requests until `max_batch_size` rows
  are pending or `max_delay_ms` has passed since the oldest request
  (partial batches flush at the deadline: latency is bounded, not
  traded away);
* per-request deadlines: a request whose deadline expires before its
  batch dispatches is shed (NOT served: the robot has already moved on),
  completes with `DeadlineError` (`serve/batcher/shed_deadline`) and
  feeds the `serve/slo_breaches` counter via
  `obs.sentinel.observe_serving_latency`. A falsy deadline (None or 0)
  is no deadline. Requests larger than `max_batch_size` bypass the
  queue and are never checked against a deadline;
* outputs are split back per request by row offsets: callers see
  exactly the arrays an unbatched `predict` would have returned;
* shutdown: `close()` JOINS the worker, waiting out an in-flight
  dispatch no matter what, then fails still-queued requests with
  `ShutdownError`.

Telemetry (`obs.metrics`): serve/batcher/requests, batches, bypass,
shed_queue_full, shed_deadline, shed_shutdown, serve/slo_breaches
(counters); serve/request_rows, serve/batch_rows, serve/request_ms
(histograms, the last with a worst-request trace-id exemplar).

Request tracing (`obs.graftrace`), as in the JAX package: each request
gets a trace context at admission (a child of the caller's active
context, else a fresh root) that rides the request object to the
worker; the per-request stages `queue_wait` (enqueue -> gather pop),
`batch_form` (pop -> dispatch start), `dispatch` (backend call) and
`split` (output split + bookkeeping) go to `serve/stage/<name>_ms` and
sum to `serve/request_ms` less the client's wakeup. With the tracer on,
each request leaves a `serve/request` event and its four stage events,
and each dispatch a `serve/batcher/dispatch` span whose `links` name
its requests. `usage=` (`obs.usage.UsageLedger.recorder(group)`) is
called `(busy_seconds, requests)` once per dispatch window. The worker
drains the tracer to the graftrace shard exporter (`graftrace.flush`,
a no-op unless configured) when it dies and at `close()`.

The batcher duck-types the predictor contract (`predict` /
`get_feature_specification` / `restore` / `warmup` / `global_step`), so
policies and env loops take one in place of a raw predictor unchanged.
"""

from __future__ import annotations

import collections
import logging
import threading
import time
from typing import Any, Callable, Dict, List, Mapping, Optional

import numpy as np

from tensor2robot_tpu_torch.obs import graftrace
from tensor2robot_tpu_torch.obs import metrics as obs_metrics
from tensor2robot_tpu_torch.obs import sentinel as obs_sentinel
from tensor2robot_tpu_torch.obs import trace as obs_trace
from tensor2robot_tpu_torch.utils import config

__all__ = ["MicroBatcher", "ShedError", "DeadlineError", "ShutdownError"]


class ShedError(RuntimeError):
  """The batcher refused the request (admission control)."""


class DeadlineError(ShedError):
  """The request's deadline expired before its batch dispatched."""


class ShutdownError(ShedError):
  """The batcher was closed while the request was still queued."""


class _Request:
  """One in-flight predict: features, result slot, completion event.

  Carries its graftrace context (minted at admission) and the
  perf-clock stamps (`enq_ns` at enqueue, `pop_ns` when `_gather` pops
  it) the per-request stage decomposition is computed from: the context
  rides the request object across the client->worker thread boundary.
  """

  __slots__ = ("features", "rows", "deadline", "enqueued_s", "event",
               "result", "error", "ctx", "enq_ns", "pop_ns")

  def __init__(self, features: Dict[str, np.ndarray], rows: int,
               deadline: Optional[float], enqueued_s: float,
               ctx: Optional[graftrace.TraceContext] = None):
    self.features = features
    self.rows = rows
    self.deadline = deadline  # absolute monotonic seconds, or None
    self.enqueued_s = enqueued_s
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


def _rows_of(features: Mapping[str, Any]) -> int:
  """Leading-dim row count, validated consistent across every leaf."""
  rows = None
  for key, value in features.items():
    shape = getattr(value, "shape", None)
    if not shape:
      raise ValueError(f"feature {key!r} has no leading batch dim")
    if rows is None:
      rows = int(shape[0])
    elif int(shape[0]) != rows:
      raise ValueError(
          f"inconsistent leading dims in request: {key!r} has "
          f"{shape[0]}, another feature has {rows}")
  if rows is None:
    raise ValueError("empty feature dict")
  if rows < 1:
    raise ValueError("request must have at least one row (got 0)")
  return rows


def _concat_requests(requests: List[_Request]) -> Dict[str, np.ndarray]:
  """One batch dict from several requests (row-wise concatenation)."""
  if len(requests) == 1:
    return {k: np.asarray(v) for k, v in requests[0].features.items()}
  keys = list(requests[0].features)
  key_set = set(keys)
  for request in requests[1:]:
    if set(request.features) != key_set:
      raise ValueError(
          "requests in one batch disagree on feature keys: "
          f"{sorted(key_set)} vs {sorted(request.features)}")
  return {k: np.concatenate([np.asarray(r.features[k]) for r in requests],
                            axis=0) for k in keys}


def _split_outputs(outputs: Mapping[str, Any],
                   requests: List[_Request]) -> List[Dict[str, np.ndarray]]:
  """Row-offset split of batch outputs back into per-request dicts."""
  splits: List[Dict[str, np.ndarray]] = [{} for _ in requests]
  total = sum(r.rows for r in requests)
  for key, value in dict(outputs).items():
    value = np.asarray(value)
    if value.ndim == 0 or value.shape[0] != total:
      # A non-batched output (e.g. a scalar diagnostic) is replicated to
      # every request rather than mis-sliced.
      for split in splits:
        split[key] = value
      continue
    offset = 0
    for i, request in enumerate(requests):
      splits[i][key] = value[offset:offset + request.rows]
      offset += request.rows
  return splits


@config.configurable
class MicroBatcher:
  """Dynamic batching front of any batch predictor (see module doc).

  `backend` is any callable `dict[str, array] -> dict[str, array]` over
  a leading batch dim — a `BucketedEngine` (its `predict`), a raw
  `predictor.predict`, or a plain numpy function in tests. Requests
  larger than `max_batch_size` bypass coalescing and dispatch directly
  from the caller's thread (counted: `serve/batcher/bypass`): a full
  batch gains nothing from waiting for company.
  """

  def __init__(self, backend: Optional[Callable] = None,
               max_batch_size: int = 8,
               max_delay_ms: float = 5.0,
               max_queue: int = 64,
               default_deadline_ms: Optional[float] = None,
               usage: Optional[Callable[[float, int], None]] = None):
    if backend is None:
      raise ValueError("backend is required.")
    if max_batch_size < 1:
      raise ValueError(f"max_batch_size must be >= 1, got {max_batch_size}")
    if max_queue < 1:
      raise ValueError(f"max_queue must be >= 1, got {max_queue}")
    self._backend = backend
    self._predict_backend = getattr(backend, "predict", backend)
    self._max_batch_size = max_batch_size
    self._max_delay_s = max_delay_ms / 1e3
    self._max_queue = max_queue
    self._default_deadline_ms = default_deadline_ms
    # Device-time ledger hook (`obs.usage.UsageLedger.recorder(group)`):
    # called `(busy_seconds, requests)` once per backend dispatch window.
    self._usage = usage
    self._pending: "collections.deque[_Request]" = collections.deque()
    self._pending_rows = 0
    self._lock = threading.Lock()
    self._have_work = threading.Condition(self._lock)
    self._closed = False
    # Worker phase, readable by close(): "idle"/"gather" may be
    # interrupted, "dispatch" is an in-flight device call that must be
    # waited out.
    self._phase = ["idle"]
    self._worker = threading.Thread(target=self._run, daemon=True,
                                    name="micro-batcher")
    self._worker.start()

  # -- client side ----------------------------------------------------------

  def predict(self, features: Mapping[str, Any],
              deadline_ms: Optional[float] = None
              ) -> Dict[str, np.ndarray]:
    """Blocking predict through the batch coalescer.

    Raises `ShedError` when admission control refuses the request
    (queue full / closed), `DeadlineError` when `deadline_ms` (or the
    batcher default) expires before dispatch, and re-raises any backend
    error for the whole batch.
    """
    start = time.monotonic()
    if deadline_ms is None:
      deadline_ms = self._default_deadline_ms
    features = dict(features)
    rows = _rows_of(features)
    obs_metrics.counter("serve/batcher/requests").inc()
    # Observed request-size stream: the reservoir behind the
    # traffic-derived bucket ladder (`engine.observed_request_rows`).
    obs_metrics.histogram("serve/request_rows").record(float(rows))
    # Trace admission: a child of the caller's active context, a fresh
    # root otherwise.
    ctx = graftrace.request_context()
    if rows > self._max_batch_size:
      # Already a full batch (e.g. a CEM candidate sweep): coalescing
      # cannot help, dispatch directly — but never after close(): the
      # backend may already be torn down.
      with self._lock:
        if self._closed:
          obs_metrics.counter("serve/batcher/shed_shutdown").inc()
          raise ShutdownError("batcher is closed")
      obs_metrics.counter("serve/batcher/bypass").inc()
      t0_ns = time.perf_counter_ns()
      with graftrace.activate(ctx):
        with obs_trace.span("serve/batcher/bypass", cat="serve"):
          result = dict(self._predict_backend(features))
      # The whole bypass window IS its dispatch stage: recorded so the
      # stage sums still reconcile with serve/request_ms when traffic
      # mixes bypass and coalesced requests.
      end_ns = time.perf_counter_ns()
      graftrace.record_stage(
          "dispatch", (end_ns - t0_ns) / 1e6, ctx=ctx, start_ns=t0_ns)
      if self._usage is not None:
        self._usage((end_ns - t0_ns) / 1e9, 1)
      self._observe(start, ctx)
      return result
    request = _Request(features, rows,
                       None if not deadline_ms
                       else start + deadline_ms / 1e3, start, ctx=ctx)
    with self._have_work:
      if self._closed:
        obs_metrics.counter("serve/batcher/shed_shutdown").inc()
        raise ShutdownError("batcher is closed")
      if len(self._pending) >= self._max_queue:
        obs_metrics.counter("serve/batcher/shed_queue_full").inc()
        raise ShedError(
            f"request queue full ({self._max_queue} pending); "
            "backpressure — retry later or add capacity")
      was = self._pending_rows
      self._pending.append(request)
      self._pending_rows = was + rows
      # Wake the worker only on the two edges it can act on: first
      # arrival (it may be idle) and batch-full (it should dispatch NOW
      # instead of at the flush deadline). Notifying on every arrival
      # costs a worker wakeup per request.
      if was == 0 or (was < self._max_batch_size <= self._pending_rows):
        self._have_work.notify()
    request.event.wait()
    if request.error is not None:
      raise request.error
    if obs_trace.get_tracer().enabled:
      # The client-visible request window: the parent span every stage
      # event nests under in the merged timeline.
      end_ns = time.perf_counter_ns()
      obs_trace.add_complete("serve/request", request.enq_ns,
                             end_ns - request.enq_ns, cat="serve",
                             args={**ctx.args(), "rows": rows})
    self._observe(start, ctx)
    return request.result

  def _observe(self, start: float,
               ctx: Optional[graftrace.TraceContext] = None) -> None:
    # The exemplar ties the window's WORST request to its trace id: the
    # link from a p99 regression to the timeline.
    obs_metrics.histogram("serve/request_ms").record(
        (time.monotonic() - start) * 1e3,
        exemplar=ctx.trace_id if ctx is not None else None)

  # -- worker side ----------------------------------------------------------

  def _gather(self) -> Optional[List[_Request]]:
    """Blocks for the next batch: up to `max_batch_size` rows, flushed
    `max_delay_s` after the OLDEST pending request arrived. Returns None
    only at shutdown.

    Requests are left ON the queue while waiting (popped only at flush
    time) so the queue-full and batch-full accounting stay in one
    place, and the worker sleeps through intermediate arrivals.
    """
    with self._have_work:
      while not self._pending or self._closed:
        if self._closed:
          # Close sheds still-queued requests (the `_run` finally fails
          # them with ShutdownError); only the batch already mid-flight
          # finishes.
          return None
        self._phase[0] = "idle"
        self._have_work.wait(timeout=0.1)
      self._phase[0] = "gather"
      flush_at = self._pending[0].enqueued_s + self._max_delay_s
      while (self._pending_rows < self._max_batch_size
             and not self._closed):
        remaining = flush_at - time.monotonic()
        if remaining <= 0:
          break
        self._have_work.wait(timeout=remaining)
        if not self._pending:  # spurious wake after a racing shed/close
          return None if self._closed else []
      if self._closed:
        # A close() racing the gather: nothing here has been dispatched
        # yet, so the shed-on-shutdown contract applies.
        return None
      batch = [self._pending.popleft()]
      rows = batch[0].rows
      while (self._pending
             and rows + self._pending[0].rows <= self._max_batch_size):
        request = self._pending.popleft()
        batch.append(request)
        rows += request.rows
      self._pending_rows -= rows
      pop_ns = time.perf_counter_ns()
      for request in batch:
        request.pop_ns = pop_ns  # queue_wait ends at flush-time pop
      return batch

  def _serve_batch(self, batch: List[_Request]) -> None:
    now = time.monotonic()
    live: List[_Request] = []
    for request in batch:
      if request.deadline is not None and now > request.deadline:
        # Stale before dispatch: shed, never serve — and count it as the
        # SLO breach it is (the deadline is the per-request SLO).
        elapsed_ms = (now - request.enqueued_s) * 1e3
        slo_ms = (request.deadline - request.enqueued_s) * 1e3
        request.complete(error=DeadlineError(
            f"deadline {slo_ms:.1f} ms expired after "
            f"{elapsed_ms:.1f} ms in queue; request shed unserved"))
        obs_sentinel.observe_serving_latency(elapsed_ms, slo_ms)
        obs_metrics.counter("serve/batcher/shed_deadline").inc()
        continue
      live.append(request)
    if not live:
      return
    self._phase[0] = "dispatch"
    # The dispatch runs under a fresh batch-level context whose span
    # `links` name every coalesced request: the aggregator draws one
    # flow arrow per request into the shared dispatch, and everything
    # the engine records inside (pad/device stages, engine spans)
    # attaches the batch context via the thread-local.
    batch_ctx = graftrace.mint()
    try:
      dispatch_ns = time.perf_counter_ns()
      with graftrace.activate(batch_ctx):
        with obs_trace.span("serve/batcher/dispatch", cat="serve",
                            requests=len(live),
                            rows=sum(r.rows for r in live),
                            links=[r.ctx.span_id for r in live
                                   if r.ctx is not None]):
          outputs = self._predict_backend(_concat_requests(live))
      split_ns = time.perf_counter_ns()
      splits = _split_outputs(outputs, live)
      end_ns = time.perf_counter_ns()
    finally:
      self._phase[0] = "gather"
    # Record batch telemetry BEFORE completing: a caller woken by
    # complete() may snapshot the registry immediately. A telemetry
    # failure here cannot orphan a request: the `_run` handler fails
    # every not-yet-completed request in the batch.
    self._record_stages(live, dispatch_ns, split_ns, end_ns)
    if self._usage is not None:
      # The dispatch window (backend call wall) is the device-busy time
      # this batch bought; split/bookkeeping is host work, not charged.
      self._usage((split_ns - dispatch_ns) / 1e9, len(live))
    obs_metrics.counter("serve/batcher/batches").inc()
    obs_metrics.histogram("serve/batch_rows").record(
        float(sum(r.rows for r in live)))
    for request, split in zip(live, splits):
      request.complete(result=split)

  def _record_stages(self, live: List[_Request], dispatch_ns: int,
                     split_ns: int, end_ns: int) -> None:
    """Per-request latency decomposition (the graftrace stage contract):
    queue_wait + batch_form + dispatch + split sums to the client's
    serve/request_ms window minus its wakeup latency. Histograms are
    batch-amortized; per-request trace events only when the tracer is
    on."""
    dispatch_ms = (split_ns - dispatch_ns) / 1e6
    split_ms = (end_ns - split_ns) / 1e6
    graftrace.record_stage_many(
        "queue_wait", [(r.pop_ns - r.enq_ns) / 1e6 for r in live])
    graftrace.record_stage_many(
        "batch_form", [(dispatch_ns - r.pop_ns) / 1e6 for r in live])
    graftrace.record_stage_many("dispatch", [dispatch_ms] * len(live))
    graftrace.record_stage_many("split", [split_ms] * len(live))
    if obs_trace.get_tracer().enabled:
      for r in live:
        args = r.ctx.args() if r.ctx else None
        for name, start_ns, stop_ns in (
            ("queue_wait", r.enq_ns, r.pop_ns),
            ("batch_form", r.pop_ns, dispatch_ns),
            ("dispatch", dispatch_ns, split_ns),
            ("split", split_ns, end_ns)):
          obs_trace.add_complete(graftrace.STAGE_PREFIX + name, start_ns,
                                 stop_ns - start_ns, cat="stage",
                                 args=args)

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
          # ANY per-batch failure (backend, split, telemetry) fans out
          # to every not-yet-completed request in the batch (a caller
          # must never hang on its event) and the worker keeps serving.
          for request in batch:
            if not request.event.is_set():
              request.complete(error=e)
    finally:
      self._phase[0] = "done"
      # Fail whatever is still queued (a caller blocked on its event
      # must never hang on a dead worker) and close the batcher so a
      # LATER predict() raises ShutdownError instead of enqueueing to a
      # queue nobody will ever drain.
      with self._have_work:
        self._closed = True
        pending = list(self._pending)
        self._pending.clear()
        self._pending_rows = 0
      for request in pending:
        obs_metrics.counter("serve/batcher/shed_shutdown").inc()
        request.complete(error=ShutdownError("batcher worker exited"))
      # Worker teardown drains buffered spans to the shard exporter
      # (no-op unless graftrace is configured): a worker that dies
      # outside close() must not silently drop its trace window.
      graftrace.flush()

  # -- lifecycle ------------------------------------------------------------

  def close(self, timeout: float = 60.0) -> None:
    """Stops and JOINS the worker.

    While the worker is mid dispatch ("dispatch" phase) the join waits
    indefinitely: the in-flight batch finishes and its callers get their
    results. In any other phase the worker observes the close flag
    within 0.1 s, so the join is prompt; `timeout` only bounds
    pathological cases (a backend that blocks forever OUTSIDE the
    dispatch window), logged loudly rather than hung on.
    """
    with self._have_work:
      if self._closed and not self._worker.is_alive():
        return
      self._closed = True
      self._have_work.notify_all()
    deadline = None
    while True:
      self._worker.join(timeout=1.0)
      if not self._worker.is_alive():
        graftrace.flush()  # teardown drain (no-op unless configured)
        return
      if self._phase[0] == "dispatch":
        deadline = None  # device op in flight: wait it out, full stop
        continue
      if deadline is None:
        deadline = time.monotonic() + timeout
      elif time.monotonic() >= deadline:
        break
    logging.error(
        "MicroBatcher.close(): worker still alive after %.0fs in phase "
        "%r; abandoning the daemon thread.", timeout, self._phase[0])

  def __enter__(self) -> "MicroBatcher":
    return self

  def __exit__(self, exc_type, exc_value, traceback) -> bool:
    self.close()
    return False

  # -- predictor duck-type passthroughs -------------------------------------

  def get_feature_specification(self):
    return self._backend.get_feature_specification()

  def restore(self) -> bool:
    return self._backend.restore()

  def warmup(self) -> None:
    warm = getattr(self._backend, "warmup", None)
    if warm is not None:
      warm()

  @property
  def global_step(self) -> int:
    return getattr(self._backend, "global_step", -1)

  @property
  def model_version(self) -> int:
    return self.global_step
