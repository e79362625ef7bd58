"""Per-train-step telemetry: data-wait vs device time.

The port's copy of the JAX package's `obs.stepstats`, with the same
record fields and window arithmetic. A CUDA launch returns before the
device finishes, so the wall time around a step says little; the device
is waited on once per measured window, by `utils.backend.state_barrier`
(a CUDA event after the step, waited on, then the smallest parameter
leaf copied to the host: it depends on the full forward, backward and
update).

Accounting per measured window (`every_n_steps` steps, default 1):

* `data_wait_ms`  — host time staging batches (`data_wait()` windows).
  Behind the `DevicePrefetcher` the loop's `data_wait()` wraps only the
  DEQUEUE of an already-placed batch, so parse/preprocess/place work
  running in worker threads concurrently with device compute inflates
  NEITHER `data_wait_ms` NOR `device_ms`: a near-zero `data_wait_ms`
  with healthy throughput means the pipeline keeps up, and a growing
  one means the consumer outran it — read the `data/overlap_*` stage
  timings to see which stage binds;
* `device_ms`     — un-overlapped device wait: the time inside the step
  call (launching its kernels; where the host waits on the device
  inside the step, that too) plus the closing barrier. Host staging that
  overlaps device compute is deliberately NOT charged to the device —
  the split answers "what is the loop's wall clock spent waiting on";
* `host_ms`       — the remainder (hooks, metric fetch, logging);
* `step_ms`       — full window wall time / steps;
* `examples_per_sec`; `compile`, which is 0 on every window (eager
  PyTorch compiles nothing at dispatch; the JAX package counts its
  first dispatch and re-traces here); the allocator gauges on the card.

The barrier costs one device wait per measured window and serializes
the launch queue there: use `every_n_steps=1` for CPU and debug runs
and a coarser cadence on the card so the wait amortizes (the windowed
averages stay exact) — `train_eval_model`'s default picks per-step on
the CPU and the log cadence on CUDA. Importing this module never
touches torch (device access is lazy, from inside a live loop); the
train-loop integration lives in `train_eval.py` +
`hooks.core.StepStatsHook`.
"""

from __future__ import annotations

import sys
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from tensor2robot_tpu_torch.obs import metrics as metrics_lib
from tensor2robot_tpu_torch.obs import trace as trace_lib

__all__ = ["StepStatsRecorder"]

# A window whose post-barrier residual is below this fraction of the
# window is "barrier dominated": its step_ms is an upper bound, not a
# measurement — flagged in the record so obs.sentinel's spike detector
# skips it.
BARRIER_DOMINATED_RESIDUAL = 0.2


class _WaitTimer:
  """Accumulates one staging window into the recorder (+ trace span)."""

  __slots__ = ("_rec", "_start_ns")

  def __init__(self, rec: "StepStatsRecorder"):
    self._rec = rec
    self._start_ns = 0

  def __enter__(self) -> "_WaitTimer":
    self._start_ns = time.perf_counter_ns()
    return self

  def __exit__(self, exc_type, exc, tb) -> None:
    dur_ns = time.perf_counter_ns() - self._start_ns
    self._rec._data_wait_ns += dur_ns
    self._rec._tracer.add_complete("train/data_wait", self._start_ns,
                                   dur_ns, cat="train")


class _NullTimer:
  __slots__ = ()

  def __enter__(self):
    return self

  def __exit__(self, exc_type, exc, tb):
    return None


_NULL_TIMER = _NullTimer()


def _default_barrier(state):
  from tensor2robot_tpu_torch.utils import backend

  # Return the fetched leaf: it is ALREADY on the host, so the
  # non-finite divergence check piggybacks on it for free.
  return backend.state_barrier(state)


class StepStatsRecorder:
  """Train-loop step accountant; all clock reads live in this module.

  Protocol (see `train_eval.py`):

    rec.start()                       # after data/state bring-up
    with rec.data_wait(): batch = next(...)
    rec.before_dispatch(); state, m = step(...); rec.after_dispatch()
    with rec.data_wait(): next_batch = next(...)   # overlapped staging
    rec.end_step(step, state, num_steps=k)         # barrier at cadence
    for step, record in rec.drain(): writer.write_scalars(step, record)

  A disabled recorder (`every_n_steps=0`) keeps the call sites
  unconditional and no-ops at one attribute check per call.
  """

  def __init__(self,
               batch_size: int,
               every_n_steps: int = 1,
               barrier: Optional[Callable[[Any], None]] = None,
               registry: Optional[metrics_lib.Registry] = None,
               tracer: Optional[trace_lib.Tracer] = None,
               device_gauges: bool = True):
    self._enabled = every_n_steps > 0
    self._batch_size = int(batch_size)
    self._every_n = max(int(every_n_steps), 1)
    self._barrier = barrier or _default_barrier
    self._registry = registry or metrics_lib.get_registry()
    self._tracer = tracer or trace_lib.get_tracer()
    self._device_gauges = device_gauges
    self._records: List[Tuple[int, Dict[str, float]]] = []
    self._window_start_ns = 0
    self._data_wait_ns = 0
    self._dispatch_ns = 0
    self._barrier_ns = 0
    self._steps_in_window = 0
    self._t_dispatch_ns = 0
    self._observers: List[Callable[[int, Dict[str, float]], Any]] = []
    self._last_barrier_nonfinite: Optional[float] = None
    # The CUDA device the last barrier waited on (None: the CPU).
    self._card = None

  @property
  def enabled(self) -> bool:
    return self._enabled

  def add_observer(self,
                   observer: Callable[[int, Dict[str, float]], Any]
                   ) -> None:
    """Registers `observer(step, record)`, called synchronously for
    every emitted window record (drain() is untouched — observers are
    the online path, e.g. `obs.sentinel` / the flight recorder). An
    observer that raises is warned about and dropped — telemetry must
    never take down a train loop."""
    self._observers.append(observer)

  def start(self) -> None:
    """Marks the start of the first measurement window."""
    if self._enabled:
      self._window_start_ns = time.perf_counter_ns()

  def data_wait(self):
    """Context manager charging its window to `data_wait_ms`."""
    return _WaitTimer(self) if self._enabled else _NULL_TIMER

  def before_dispatch(self) -> None:
    if self._enabled:
      self._t_dispatch_ns = time.perf_counter_ns()

  def after_dispatch(self) -> None:
    """Call immediately after the step call returns."""
    if not self._enabled:
      return
    self._dispatch_ns += time.perf_counter_ns() - self._t_dispatch_ns

  def end_step(self, step: int, state: Any, num_steps: int = 1) -> None:
    """Closes the step; at the cadence, barriers and emits a record."""
    if not self._enabled:
      return
    self._steps_in_window += num_steps
    if self._steps_in_window < self._every_n:
      return
    self._card = self._card_of(state)
    barrier_start_ns = time.perf_counter_ns()
    try:
      fetched = self._barrier(state)
    except Exception:
      # A FAILING barrier is the strongest device evidence there is:
      # stamp it before the exception unwinds into the flight-recorder
      # dump, so the bundle's heartbeat timeline carries the death time
      # and cause.
      self._record_barrier_failure(
          (time.perf_counter_ns() - barrier_start_ns) / 1e9)
      raise
    now_ns = time.perf_counter_ns()
    self._barrier_ns += now_ns - barrier_start_ns
    self._tracer.add_complete("train/barrier", barrier_start_ns,
                              now_ns - barrier_start_ns, cat="train")
    self._observe_barrier(fetched, (now_ns - barrier_start_ns) / 1e9)
    self._emit(step, now_ns)

  @staticmethod
  def _card_of(state) -> Any:
    """The CUDA device of `state`'s parameters, else None."""
    from tensor2robot_tpu_torch.utils import backend

    try:
      device = backend.state_device(state)
    except (AttributeError, TypeError, ValueError):
      return None  # a state without tensor parameters
    return device if getattr(device, "type", None) == "cuda" else None

  def _stamp_heartbeat(self, ok: bool, barrier_s: float,
                       cause: Optional[str] = None) -> None:
    """The ONE place holding the evidence rule for barriers: stamp the
    heartbeat monitor only when the barrier waited on the card — a CPU
    run's barriers say nothing about the device's health. Never raises
    (and in the failure path, never masks the barrier's own error)."""
    if self._card is None:
      return
    try:
      from tensor2robot_tpu_torch.utils import backend

      backend.record_heartbeat(ok, elapsed_s=barrier_s,
                               source="state_barrier", cause=cause)
    except Exception:  # noqa: BLE001 - heartbeat is best-effort
      pass

  def _record_barrier_failure(self, barrier_s: float) -> None:
    self._stamp_heartbeat(False, barrier_s, cause="barrier_failed")

  def _observe_barrier(self, fetched: Any, barrier_s: float) -> None:
    """Piggybacks on the barrier's host copy: non-finite divergence
    check on the fetched param leaf + a heartbeat stamp (see
    `_stamp_heartbeat` for the on-the-card gate)."""
    self._last_barrier_nonfinite = None
    if fetched is not None:
      try:
        import numpy as np

        self._last_barrier_nonfinite = float(
            not bool(np.all(np.isfinite(np.asarray(fetched)))))
      except Exception:  # noqa: BLE001 - non-float leaves etc.
        self._last_barrier_nonfinite = None
    self._stamp_heartbeat(True, barrier_s)

  def _emit(self, step: int, now_ns: int) -> None:
    n = self._steps_in_window
    window_s = max((now_ns - self._window_start_ns) / 1e9, 1e-9)
    data_wait_ms = self._data_wait_ns / 1e6 / n
    device_ms = (self._dispatch_ns + self._barrier_ns) / 1e6 / n
    step_ms = window_s * 1e3 / n
    record: Dict[str, float] = {
        "step_ms": step_ms,
        "device_ms": device_ms,
        "data_wait_ms": data_wait_ms,
        "host_ms": max(step_ms - device_ms - data_wait_ms, 0.0),
        "dispatch_ms": self._dispatch_ns / 1e6 / n,
        "examples_per_sec": n * self._batch_size / window_s,
        "compile": 0.0,
        "steps_in_window": float(n),
        # The 0.2-residual clamp rule: a window the barrier swallowed is
        # an upper bound — the sentinel spike detector must skip it.
        "barrier_dominated": float(
            window_s * 1e9 - self._barrier_ns
            < BARRIER_DOMINATED_RESIDUAL * window_s * 1e9),
    }
    if self._last_barrier_nonfinite is not None:
      record["nonfinite_params"] = self._last_barrier_nonfinite
    record.update(self._read_device_gauges())
    self._records.append((int(step), record))
    for observer in list(self._observers):
      try:
        observer(int(step), record)
      except Exception as e:  # noqa: BLE001 - drop a broken observer
        self._observers.remove(observer)
        print(f"stepstats: observer {observer!r} failed and was "
              f"detached ({type(e).__name__}: {e})", file=sys.stderr)
    reg = self._registry
    reg.histogram("stepstats/step_ms").record(step_ms)
    reg.histogram("stepstats/device_ms").record(device_ms)
    reg.histogram("stepstats/data_wait_ms").record(data_wait_ms)
    reg.histogram("stepstats/examples_per_sec").record(
        record["examples_per_sec"])
    reg.gauge("stepstats/examples_per_sec").set(record["examples_per_sec"])
    first_step = int(step) - n + 1
    self._tracer.add_complete(
        "train/step_window", self._window_start_ns,
        now_ns - self._window_start_ns, cat="train",
        args={"first_step": first_step, "last_step": int(step), "steps": n})
    self._window_start_ns = now_ns
    self._data_wait_ns = self._dispatch_ns = self._barrier_ns = 0
    self._steps_in_window = 0

  def _read_device_gauges(self) -> Dict[str, float]:
    """Allocator counts and bytes on the card (`live_arrays`,
    `live_bytes`, `device_bytes_*`). Latches off on first failure —
    telemetry must never take down a train loop — and on the CPU, which
    reports none."""
    if not self._device_gauges:
      return {}
    try:
      from tensor2robot_tpu_torch.utils import backend

      out = backend.device_memory_stats(self._card)
      if not out:  # the CPU
        self._device_gauges = False
        return {}
      self._registry.gauge("device/live_arrays").set(out["live_arrays"])
      self._registry.gauge("device/live_bytes").set(out["live_bytes"])
      return out
    except Exception:  # noqa: BLE001 - gauges are best-effort
      self._device_gauges = False
      return {}

  def drain(self) -> List[Tuple[int, Dict[str, float]]]:
    """Pops every completed (step, record) pair, oldest first."""
    records, self._records = self._records, []
    return records
