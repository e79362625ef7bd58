"""faultlab: seeded, deterministic fault injection for graftguard.

The port's own copy of the JAX package's `obs.faultlab`: the same ten
points, the same `FaultSpec` / `FaultPlan` rules and the same
crc32-derived draw (`_unit`), so one plan fires the same arrivals in
both packages. Nothing can test recovery without a fault on demand;
this is the deterministic fault plane threaded through the seams.

Injection points (the seam that checks each one is named in situ):

  data.record_io       record-source I/O error (`data/pipeline.py`
                       record stream, both the native-stager and the
                       pure-Python fallback paths)
  data.corrupt_record  corrupt-record bytes: a record in the batch is
                       bit-flipped BEFORE parse, so the parser fails
                       exactly the way real corruption fails
  data.preprocess      preprocess exception inside the parse/preprocess
                       stage
  serve.dispatch       per-replica dispatch failure (a serving fleet;
                       no seam in the port yet)
  serve.latency        per-replica latency spike (spec.arg = ms; no
                       seam in the port yet)
  loop.actor_crash     actor-process death in an actor/learner loop
                       (key = actor index; no seam in the port yet)
  loop.actor_hang      actor heartbeat stall (spec.arg = seconds; no
                       seam in the port yet)
  ckpt.torn            torn (truncated) checkpoint file right after
                       `CheckpointManager.save` wrote its manifest
  ckpt.bitflip         single flipped byte in a checkpoint file after
                       save (the silent-corruption case the manifest
                       checksums exist to catch)
  train.nonfinite      non-finite loss injected into the train loop's
                       host-side metric fetch (drives the sentinel
                       divergence incident -> rewind path)

Determinism: every decision is a pure function of (plan seed, point,
key, arrival index) — a crc32-derived uniform — and arrivals are counted
per (point, key) under a lock, so "the 3rd dispatch on replica 1 fails"
means the same event every run regardless of thread interleaving
elsewhere. Every injected fault is counted (`faultlab/injected`,
`faultlab/<point>`) and remembered (bounded), so a chaos run's
runs.jsonl record is attributable fault by fault.

Activation is explicit and process-global (`activate(plan)` /
`plan.activated()` context manager); with no active plan every
`maybe_fire` is None and the seams cost one attribute read.
Framework-free at import like the rest of `obs/`.
"""

from __future__ import annotations

import collections
import dataclasses
import threading
import zlib
from typing import Any, Deque, Dict, List, Mapping, Optional, Sequence, Tuple

from tensor2robot_tpu_torch.obs import metrics as metrics_lib

__all__ = ["FaultSpec", "FaultPlan", "activate", "deactivate", "active",
           "maybe_fire", "InjectedIOError", "InjectedDispatchError",
           "InjectedPreprocessError", "InjectedActorCrash",
           "DATA_RECORD_IO", "DATA_CORRUPT_RECORD", "DATA_PREPROCESS",
           "SERVE_DISPATCH", "SERVE_LATENCY", "CKPT_TORN", "CKPT_BITFLIP",
           "TRAIN_NONFINITE", "LOOP_ACTOR_CRASH", "LOOP_ACTOR_HANG"]

DATA_RECORD_IO = "data.record_io"
DATA_CORRUPT_RECORD = "data.corrupt_record"
DATA_PREPROCESS = "data.preprocess"
SERVE_DISPATCH = "serve.dispatch"
SERVE_LATENCY = "serve.latency"
CKPT_TORN = "ckpt.torn"
CKPT_BITFLIP = "ckpt.bitflip"
TRAIN_NONFINITE = "train.nonfinite"
LOOP_ACTOR_CRASH = "loop.actor_crash"
LOOP_ACTOR_HANG = "loop.actor_hang"

KNOWN_POINTS = frozenset({
    DATA_RECORD_IO, DATA_CORRUPT_RECORD, DATA_PREPROCESS,
    SERVE_DISPATCH, SERVE_LATENCY, CKPT_TORN, CKPT_BITFLIP,
    TRAIN_NONFINITE, LOOP_ACTOR_CRASH, LOOP_ACTOR_HANG})

# Remembered fire events per plan (attribution, not accounting — the
# registry counters are unbounded).
_MAX_FIRED = 512


class InjectedIOError(IOError):
  """Injected record-source I/O error (real-IOError subclass on
  purpose: recovery code MUST treat it exactly like real corruption)."""


class InjectedDispatchError(RuntimeError):
  """Injected serving dispatch failure."""


class InjectedPreprocessError(ValueError):
  """Injected preprocess-stage exception."""


class InjectedActorCrash(RuntimeError):
  """Injected graftloop actor death (the supervisor must restart)."""


@dataclasses.dataclass(frozen=True)
class FaultSpec:
  """One fault rule: WHERE (`point` + optional `key` targeting) and
  WHEN (exactly one of `at` / `every` / `rate`).

  * `at`    — fire on these 0-based arrival indices at the point;
  * `every` — fire on every Nth arrival (n % every == every - 1);
  * `rate`  — Bernoulli(rate) per arrival from the seeded stream;
  * `count` — cap on TOTAL fires of this spec (0 = unlimited);
  * `key`   — only arrivals carrying this key match (e.g. a replica
    index for `serve.*`); None matches any key;
  * `arg`   — mode argument read by the seam (latency ms, etc.).
  """

  point: str
  at: Tuple[int, ...] = ()
  every: int = 0
  rate: float = 0.0
  count: int = 0
  key: Optional[Any] = None
  arg: Any = None

  def __post_init__(self):
    if self.point not in KNOWN_POINTS:
      raise ValueError(f"Unknown faultlab point {self.point!r} "
                       f"(known: {sorted(KNOWN_POINTS)})")
    modes = sum((bool(self.at), bool(self.every), bool(self.rate)))
    if modes != 1:
      raise ValueError(
          "Exactly one of at/every/rate must be set, got "
          f"at={self.at!r} every={self.every!r} rate={self.rate!r}")
    if self.rate and not 0.0 < self.rate <= 1.0:
      raise ValueError(f"rate must be in (0, 1], got {self.rate}")
    if self.every and self.every < 1:
      # bool(-5) passes the one-mode check above, but no arrival index
      # satisfies `n % -5 == -6` — the spec would silently never fire.
      raise ValueError(f"every must be >= 1, got {self.every}")
    object.__setattr__(self, "at", tuple(int(i) for i in self.at))
    if any(i < 0 for i in self.at):
      raise ValueError(f"at indices must be >= 0, got {self.at}")


def _unit(seed: int, point: str, key: Any, n: int) -> float:
  """Deterministic uniform in [0, 1) for one arrival (crc32-derived —
  stable across processes, the `serving/fleet.py` hash-ring choice)."""
  text = f"{seed}/{point}/{key}/{n}"
  return (zlib.crc32(text.encode("utf-8")) & 0xFFFFFFFF) / 2.0**32


class FaultPlan:
  """A seeded set of `FaultSpec`s plus the per-(point, key) arrival
  accounting that makes firing deterministic (module docstring)."""

  def __init__(self, faults: Sequence[FaultSpec] = (), seed: int = 0,
               registry: Optional[metrics_lib.Registry] = None):
    self.seed = int(seed)
    self._faults: List[FaultSpec] = list(faults)
    self._registry = registry
    self._lock = threading.Lock()
    self._arrivals: Dict[Tuple[str, Any], int] = {}
    self._fires_per_spec: Dict[int, int] = {}
    self._fired: Deque[Dict[str, Any]] = collections.deque(
        maxlen=_MAX_FIRED)
    self._by_point: Dict[str, int] = {}

  @classmethod
  def from_config(cls, config: Mapping[str, Any],
                  registry: Optional[metrics_lib.Registry] = None
                  ) -> "FaultPlan":
    """Builds a plan from a JSON-safe dict:
    `{"seed": 7, "faults": [{"point": "serve.dispatch", "at": [3],
    "key": 1}, ...]}` — the shape config files carry."""
    faults = [FaultSpec(**dict(f)) for f in config.get("faults", ())]
    return cls(faults, seed=int(config.get("seed", 0)), registry=registry)

  def _reg(self) -> metrics_lib.Registry:
    return self._registry or metrics_lib.get_registry()

  def maybe_fire(self, point: str, key: Optional[Any] = None
                 ) -> Optional[FaultSpec]:
    """One arrival at `point` (with optional targeting `key`): returns
    the firing `FaultSpec` — the seam then enacts the fault — or None.
    Deterministic per (seed, point, key, arrival index)."""
    with self._lock:
      slot = (point, key)
      n = self._arrivals.get(slot, 0)
      self._arrivals[slot] = n + 1
      for index, spec in enumerate(self._faults):
        if spec.point != point:
          continue
        if spec.key is not None and spec.key != key:
          continue
        fires = self._fires_per_spec.get(index, 0)
        if spec.count and fires >= spec.count:
          continue
        if spec.at:
          hit = n in spec.at
        elif spec.every:
          hit = n % spec.every == spec.every - 1
        else:
          hit = _unit(self.seed, point, key, n) < spec.rate
        if not hit:
          continue
        self._fires_per_spec[index] = fires + 1
        self._by_point[point] = self._by_point.get(point, 0) + 1
        self._fired.append({"point": point, "key": key, "arrival": n,
                            "spec": index})
        break
      else:
        return None
    reg = self._reg()
    reg.counter("faultlab/injected").inc()
    reg.counter(f"faultlab/{point}").inc()
    return spec

  # -- attribution -----------------------------------------------------------

  def fired(self) -> List[Dict[str, Any]]:
    """The (bounded) fire events so far, oldest first."""
    with self._lock:
      return list(self._fired)

  def summary(self) -> Dict[str, Any]:
    """JSON-safe block for runs.jsonl stamping: seed, totals per point,
    arrival counts — a chaos record is attributable from this alone."""
    with self._lock:
      return {
          "seed": self.seed,
          "injected": sum(self._by_point.values()),
          "by_point": dict(self._by_point),
          "arrivals": {f"{p}" + (f"[{k}]" if k is not None else ""): n
                       for (p, k), n in sorted(self._arrivals.items(),
                                               key=lambda kv: str(kv[0]))},
      }

  # -- activation ------------------------------------------------------------

  def activated(self):
    """Context manager: activates this plan for the `with` body."""
    plan = self

    class _Activation:
      def __enter__(self):
        activate(plan)
        return plan

      def __exit__(self, *exc):
        deactivate()
        return False

    return _Activation()


_active_lock = threading.Lock()
_active_plan: Optional[FaultPlan] = None


def activate(plan: FaultPlan) -> FaultPlan:
  """Makes `plan` the process-global active plan (returns it)."""
  global _active_plan
  with _active_lock:
    _active_plan = plan
  return plan


def deactivate() -> None:
  global _active_plan
  with _active_lock:
    _active_plan = None


def active() -> Optional[FaultPlan]:
  return _active_plan


def maybe_fire(point: str, key: Optional[Any] = None
               ) -> Optional[FaultSpec]:
  """The seam entry point: one attribute read when no plan is active."""
  plan = _active_plan
  if plan is None:
    return None
  return plan.maybe_fire(point, key=key)


# Config-engine activation (utils/config is stdlib-only, so this keeps
# the framework-free import contract): a research config can arm a chaos
# plan for the run it configures, e.g.
#   activate_fault_plan.seed = 13
#   activate_fault_plan.faults = [{"point": "train.nonfinite", "at": [24]}]
from tensor2robot_tpu_torch.utils import config as _config  # noqa: E402


@_config.configurable
def activate_fault_plan(seed: int = 0,
                        faults: Sequence[Mapping[str, Any]] = ()
                        ) -> FaultPlan:
  """Builds and ACTIVATES a `FaultPlan` from JSON-safe spec dicts (the
  `FaultPlan.from_config` shape); returns the active plan."""
  return activate(FaultPlan.from_config({"seed": seed,
                                         "faults": list(faults)}))
