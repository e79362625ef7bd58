"""The shared retry and backoff policy.

The port's copy of `tensor2robot_tpu.utils.retry`. `RetryPolicy` gives:

* jittered exponential backoff: `base_delay_s * multiplier**n`, capped
  at `max_delay_s`, with +-`jitter` fractional randomization so clients
  retrying one dead dependency do not synchronize;
* a deadline budget: `deadline_s` bounds the total wall clock spent
  across attempts (sleeps are clipped to the remaining budget);
* a retryable predicate, `retryable(exc) -> bool`, separating transient
  faults from errors that must surface at once;
* telemetry: `retry/<name>/attempts`, `/retries`, `/giveups` counters
  and a `retry/<name>/sleep_ms` histogram in the port's metrics
  registry.

`OverlappedLoader.close()` paces its wait on a stalled source with it.
Deterministic under test: pass `rng=random.Random(seed)` and a fake
`sleep`/`clock`. Never imports torch.
"""

from __future__ import annotations

import random
import time
from typing import Any, Callable, Iterator, Optional

from tensor2robot_tpu_torch.obs import metrics as metrics_lib

__all__ = ["RetryPolicy", "RetryBudgetExhausted", "jittered_s"]


def jittered_s(base_s: float, jitter: float = 0.5,
               rng: Optional[random.Random] = None) -> float:
  """One jittered delay (`base_s` ± `jitter` fraction) for unbounded
  pacing loops — checkpoint appearance polls and the like, which do
  their own deadline control and only need the de-synchronization.
  A full `RetryPolicy` is for bounded retries; constructing one just
  to call `backoff_s(0)` leaves its attempt cap, deadline, and
  telemetry dead."""
  if not 0.0 <= jitter <= 1.0:
    raise ValueError(f"jitter must be in [0, 1], got {jitter}")
  delay = float(base_s)
  if jitter and delay > 0.0:
    delay *= 1.0 + jitter * (2.0 * (rng or random).random() - 1.0)
  return max(delay, 0.0)


class RetryBudgetExhausted(Exception):
  """Every attempt failed (attempt cap or deadline budget exhausted).

  `__cause__` carries the last underlying error when there was one.
  """


class RetryPolicy:
  """One named retry/backoff discipline (module docstring).

  `call(fn, *args, **kwargs)` runs fn under the policy: retries
  attempts that raise a retryable exception with a jittered
  exponential sleep between them, re-raises non-retryable errors
  immediately, and raises `RetryBudgetExhausted` (chained to the last
  error) when the attempt cap or the deadline budget runs out.

  `delays()` exposes the jittered backoff schedule directly for loops
  that are pacing rather than wrapping a callable (the checkpoint
  poll, the probation prober): each `next()` yields the next sleep in
  seconds, ending (StopIteration) when the policy would give up.
  """

  def __init__(self,
               name: str = "retry",
               max_attempts: int = 5,
               base_delay_s: float = 0.05,
               multiplier: float = 2.0,
               max_delay_s: float = 2.0,
               jitter: float = 0.5,
               deadline_s: Optional[float] = None,
               retryable: Optional[Callable[[BaseException], bool]] = None,
               sleep: Callable[[float], None] = time.sleep,
               clock: Callable[[], float] = time.monotonic,
               rng: Optional[random.Random] = None,
               registry: Optional[metrics_lib.Registry] = None):
    if max_attempts < 1:
      raise ValueError(f"max_attempts must be >= 1, got {max_attempts}")
    if not 0.0 <= jitter <= 1.0:
      raise ValueError(f"jitter must be in [0, 1], got {jitter}")
    self.name = name
    self.max_attempts = int(max_attempts)
    self.base_delay_s = float(base_delay_s)
    self.multiplier = float(multiplier)
    self.max_delay_s = float(max_delay_s)
    self.jitter = float(jitter)
    self.deadline_s = deadline_s
    self._retryable = retryable
    self._sleep = sleep
    self._clock = clock
    self._rng = rng if rng is not None else random.Random()
    self._registry = registry

  # -- introspection ---------------------------------------------------------

  def _reg(self) -> metrics_lib.Registry:
    return self._registry or metrics_lib.get_registry()

  def is_retryable(self, exc: BaseException) -> bool:
    if self._retryable is None:
      return isinstance(exc, Exception)
    try:
      return bool(self._retryable(exc))
    except Exception:  # noqa: BLE001 - a broken predicate never retries
      return False

  def backoff_s(self, attempt: int) -> float:
    """The jittered sleep AFTER a failed attempt `attempt` (0-based)."""
    return jittered_s(
        min(self.base_delay_s * (self.multiplier ** attempt),
            self.max_delay_s), self.jitter, self._rng)

  # -- the two consumption shapes -------------------------------------------

  def delays(self) -> Iterator[float]:
    """Jittered backoff schedule for pacing loops: yields the sleep (s)
    to take before retry n+1; ends when the policy gives up (attempt
    cap, or the deadline budget cannot fund the next sleep). The
    caller does its own sleeping — nothing here blocks."""
    start = self._clock()
    for attempt in range(self.max_attempts - 1):
      delay = self.backoff_s(attempt)
      if self.deadline_s is not None:
        remaining = self.deadline_s - (self._clock() - start)
        if remaining <= 0.0:
          return
        delay = min(delay, remaining)
      yield delay

  def call(self, fn: Callable[..., Any], *args, **kwargs) -> Any:
    """Runs `fn` under the policy (class docstring)."""
    reg = self._reg()
    attempts = reg.counter(f"retry/{self.name}/attempts")
    retries = reg.counter(f"retry/{self.name}/retries")
    giveups = reg.counter(f"retry/{self.name}/giveups")
    sleep_hist = reg.histogram(f"retry/{self.name}/sleep_ms")
    start = self._clock()
    last_error: Optional[BaseException] = None
    for attempt in range(self.max_attempts):
      if (self.deadline_s is not None
          and self._clock() - start >= self.deadline_s):
        break  # budget spent before this attempt could start
      attempts.inc()
      try:
        return fn(*args, **kwargs)
      except BaseException as e:  # noqa: BLE001 - predicate decides
        if not self.is_retryable(e):
          raise
        last_error = e
      if attempt + 1 >= self.max_attempts:
        break
      delay = self.backoff_s(attempt)
      if self.deadline_s is not None:
        remaining = self.deadline_s - (self._clock() - start)
        if remaining <= 0.0:
          break
        delay = min(delay, remaining)
      retries.inc()
      sleep_hist.record(delay * 1e3)
      if delay > 0.0:
        self._sleep(delay)
    giveups.inc()
    raise RetryBudgetExhausted(
        f"retry policy {self.name!r} exhausted "
        f"({self.max_attempts} attempt(s), deadline_s={self.deadline_s})"
    ) from last_error
