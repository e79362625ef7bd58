"""SLO engine: declarative objectives, error budgets, and multi-window
burn-rate alerting over the metrics stream.

The port's own copy of the JAX package's `obs.slo`, with the same specs,
arithmetic, incident records and `config.configurable` names. An SLO is
a target ratio of good events over a compliance period, the ERROR
BUDGET is the allowed bad fraction, and alerting fires on the BURN RATE
— how many times faster than budget-rate the service is consuming its
budget — evaluated over a fast AND a slow window simultaneously (the
fast window catches cliffs in minutes, the slow window gates out blips;
both must exceed the factor to fire).

* `SloSpec` — one declarative objective. Two families:
  - RATIO: a bad-events counter over a total-events counter
    (latency-SLO breaches over requests, sheds over requests, …);
    `budget` is the allowed bad/total fraction.
  - VALUE: a snapshot scalar (gauge or histogram stat) against a
    `ceiling`; each evaluation is one event, breaching when value >
    ceiling, and `budget` is the allowed breaching-sample fraction.
  Burn windows and the budget are REQUIRED at construction — an SLO
  without an explicit budget is an alert nobody sized.
* `SloEngine` — feed it `Registry.snapshot()` dicts (or graftrace
  metrics-shard snapshots, same flat schema) via `observe()`; it keeps
  per-spec cumulative counts and a sample window, computes fast/slow
  burn rates and budget consumption, and emits ONE `SLO_BURN`
  sentinel-kind incident per episode: a rising burn-rate edge (warn,
  re-arms when the fast window clears) and a budget exhaustion latch
  (fatal, once). Incidents are `obs.runlog.make_incident` records
  fanned to sinks exactly like `obs.sentinel.Sentinel._emit` — the
  flight recorder and the postmortem CLI consume them unchanged.
* `evaluate_snapshot` — the windowless point-in-time judgment
  (cumulative bad/total vs budget) `graftscope watch` renders from
  shard files alone.

The stock specs (`default_serving_slos`, `default_loop_slos`) read the
counters of the serving fleet (`serving/fleet.py`) and the actor/learner
loop (`loop/`); where a shard holds none of them, a ratio spec judges 0
of 0 events and is healthy.

Deterministic by construction: `observe(snapshot, now=...)` takes the
clock as data and every derived number is pure arithmetic over the
sample deque, so a seeded fault storm reproduces its incident stream.
Framework-free: stdlib + obs only.
"""

from __future__ import annotations

import collections
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence

from tensor2robot_tpu_torch.obs import metrics as obs_metrics
from tensor2robot_tpu_torch.obs import runlog as runlog_lib
from tensor2robot_tpu_torch.obs import sentinel as sentinel_lib
from tensor2robot_tpu_torch.utils import config

__all__ = ["SloSpec", "SloEngine", "evaluate_snapshot",
           "default_serving_slos", "default_loop_slos"]

RATIO = "ratio"
VALUE = "value"

# Google-SRE multi-window default: a 14.4x burn consumes a 30-day
# budget in ~2 days — the canonical page-severity factor. Specs may
# override per objective; the budget/windows themselves have NO default
# (the slo-unbudgeted rule makes the caller own them).
DEFAULT_BURN_FACTOR = 14.4


class SloSpec:
  """One declarative service-level objective (module docstring).

  RATIO family: `bad_key` / `total_key` name cumulative counters in the
  flat snapshot schema (`counter/<name>`). VALUE family: `value_key`
  names any snapshot scalar (`gauge/<name>`, `hist/<name>/<stat>`) and
  `ceiling` is the bound. `budget`, `fast_window_s` and `slow_window_s`
  are keyword-REQUIRED: the burn math is meaningless without them and
  the JAX package's `slo-unbudgeted` lint rule flags constructions that
  omit them.
  """

  def __init__(self, name: str, *,
               budget: float,
               fast_window_s: float,
               slow_window_s: float,
               bad_key: Optional[str] = None,
               total_key: Optional[str] = None,
               value_key: Optional[str] = None,
               ceiling: Optional[float] = None,
               burn_factor: float = DEFAULT_BURN_FACTOR,
               description: str = ""):
    if not name:
      raise ValueError("SloSpec needs a name")
    if not 0.0 < float(budget) <= 1.0:
      raise ValueError(f"budget must be in (0, 1], got {budget}")
    if not 0.0 < float(fast_window_s) < float(slow_window_s):
      raise ValueError(
          "windows must satisfy 0 < fast_window_s < slow_window_s, got "
          f"fast={fast_window_s} slow={slow_window_s}")
    ratio = bad_key is not None or total_key is not None
    value = value_key is not None or ceiling is not None
    if ratio == value:
      raise ValueError(
          "exactly one family: (bad_key, total_key) XOR "
          f"(value_key, ceiling) — got spec {name!r} with "
          f"bad_key={bad_key!r} value_key={value_key!r}")
    if ratio and (bad_key is None or total_key is None):
      raise ValueError(f"ratio spec {name!r} needs both bad_key and "
                       "total_key")
    if value and (value_key is None or ceiling is None):
      raise ValueError(f"value spec {name!r} needs both value_key and "
                       "ceiling")
    if float(burn_factor) <= 1.0:
      raise ValueError(f"burn_factor must be > 1, got {burn_factor}")
    self.name = name
    self.kind = RATIO if ratio else VALUE
    self.budget = float(budget)
    self.fast_window_s = float(fast_window_s)
    self.slow_window_s = float(slow_window_s)
    self.bad_key = bad_key
    self.total_key = total_key
    self.value_key = value_key
    self.ceiling = None if ceiling is None else float(ceiling)
    self.burn_factor = float(burn_factor)
    self.description = description

  def counts(self, snapshot: Mapping[str, float],
             prev_bad: float, prev_total: float) -> tuple:
    """Cumulative (bad, total) event counts after folding `snapshot` in.

    RATIO specs read the counters directly (already cumulative). VALUE
    specs treat each evaluated snapshot as one event: total advances by
    one per observation carrying the key, bad by one when the value
    breaches the ceiling — so the same burn/budget arithmetic covers
    both families.
    """
    if self.kind == RATIO:
      bad = float(snapshot.get(self.bad_key, 0.0) or 0.0)
      total = float(snapshot.get(self.total_key, 0.0) or 0.0)
      return bad, total
    value = snapshot.get(self.value_key)
    if value is None:
      return prev_bad, prev_total  # key absent: not an observation
    breach = float(value) > self.ceiling
    return prev_bad + (1.0 if breach else 0.0), prev_total + 1.0

  def describe(self) -> Dict[str, Any]:
    out: Dict[str, Any] = {
        "name": self.name, "kind": self.kind, "budget": self.budget,
        "fast_window_s": self.fast_window_s,
        "slow_window_s": self.slow_window_s,
        "burn_factor": self.burn_factor,
    }
    if self.kind == RATIO:
      out["bad_key"] = self.bad_key
      out["total_key"] = self.total_key
    else:
      out["value_key"] = self.value_key
      out["ceiling"] = self.ceiling
    return out


class _SpecState:
  """Per-spec accumulator: cumulative counts, the burn-window sample
  deque, and the two alert latches."""

  __slots__ = ("samples", "bad", "total", "genesis", "burning",
               "exhausted", "incidents")

  def __init__(self):
    # (now_s, cum_bad, cum_total); pruned to the slow window + one
    # baseline sample past its edge (the windowed delta needs a sample
    # AT-or-before the window start to difference against).
    self.samples: "collections.deque" = collections.deque()
    self.bad = 0.0
    self.total = 0.0
    self.genesis: Optional[tuple] = None  # first (bad, total) seen
    self.burning = False
    self.exhausted = False
    self.incidents = 0


def _windowed_burn(samples, now: float, window_s: float,
                   budget: float) -> float:
  """Burn rate over the trailing window: (bad_delta / total_delta) /
  budget, differenced against the most recent sample at-or-before the
  window start (the whole history while the window is still filling).
  0.0 with no events — no traffic is not an outage."""
  if not samples:
    return 0.0
  cutoff = now - window_s
  baseline = samples[0]
  for sample in samples:
    if sample[0] <= cutoff:
      baseline = sample
    else:
      break
  latest = samples[-1]
  bad_delta = latest[1] - baseline[1]
  total_delta = latest[2] - baseline[2]
  if total_delta <= 0.0:
    return 0.0
  return (bad_delta / total_delta) / budget


class SloEngine:
  """Continuous SLO evaluation over registry snapshots (module doc).

  `sinks` receive `graftscope-incident-v1` records (the sentinel sink
  contract — wire `Sentinel` sinks, the flight recorder, or
  `ServingFleet.sentinel_sink()` directly). `observe()` is cheap
  (pure arithmetic over the sample deque) and safe to call per request
  or per supervisor tick.
  """

  def __init__(self, specs: Sequence[SloSpec],
               sinks: Sequence[Callable[[Dict[str, Any]], Any]] = (),
               registry: Optional[obs_metrics.Registry] = None):
    if not specs:
      raise ValueError("SloEngine needs at least one SloSpec")
    names = [s.name for s in specs]
    if len(set(names)) != len(names):
      raise ValueError(f"duplicate SloSpec names: {sorted(names)}")
    self._specs = list(specs)
    self._sinks = list(sinks)
    self._registry = registry
    self._state = {spec.name: _SpecState() for spec in self._specs}

  def _reg(self) -> obs_metrics.Registry:
    # Late-bound so an engine built outside a `metrics.isolated()`
    # window still lands its telemetry in the window's registry.
    return self._registry or obs_metrics.get_registry()

  def observe(self, snapshot: Mapping[str, float],
              now: float, step: int = 0) -> List[Dict[str, Any]]:
    """Folds one snapshot sample in; returns incidents emitted NOW.

    `now` is explicit data (monotonic seconds from the caller's clock):
    evaluation is a pure function of the (snapshot, now) stream, which
    is what makes a seeded fault storm reproduce an identical incident
    stream.
    """
    emitted: List[Dict[str, Any]] = []
    for spec in self._specs:
      st = self._state[spec.name]
      st.bad, st.total = spec.counts(snapshot, st.bad, st.total)
      if st.genesis is None:
        st.genesis = (st.bad, st.total)
      st.samples.append((now, st.bad, st.total))
      self._prune(st, now, spec.slow_window_s)
      fast = _windowed_burn(st.samples, now, spec.fast_window_s,
                            spec.budget)
      slow = _windowed_burn(st.samples, now, spec.slow_window_s,
                            spec.budget)
      consumed = self._consumed(spec, st)
      reg = self._reg()
      reg.gauge(f"slo/{spec.name}/fast_burn").set(fast)
      reg.gauge(f"slo/{spec.name}/slow_burn").set(slow)
      reg.gauge(f"slo/{spec.name}/budget_consumed").set(consumed)
      if consumed >= 1.0 and not st.exhausted:
        # Budget exhaustion latches ONCE per engine lifetime: the
        # budget does not refill mid-run, so re-emitting every observe
        # would flood the stream the postmortem has to read.
        st.exhausted = True
        emitted.append(self._emit(spec, st, step, "fatal",
                                  "budget_exhausted", fast, slow,
                                  consumed, now))
      burn_now = (fast >= spec.burn_factor and slow >= spec.burn_factor)
      if burn_now and not st.burning and not st.exhausted:
        # Rising-edge burn alert; re-arms when the fast window clears
        # (one incident per burn episode, the sentinel latch idiom).
        st.burning = True
        emitted.append(self._emit(spec, st, step, "warn", "burn_rate",
                                  fast, slow, consumed, now))
      elif not burn_now and fast < spec.burn_factor:
        st.burning = False
    return emitted

  def _prune(self, st: _SpecState, now: float, slow_window_s: float
             ) -> None:
    cutoff = now - slow_window_s
    # Keep ONE sample at-or-before the window edge as the differencing
    # baseline; everything older is dead weight.
    while (len(st.samples) >= 2 and st.samples[0][0] <= cutoff
           and st.samples[1][0] <= cutoff):
      st.samples.popleft()

  def _consumed(self, spec: SloSpec, st: _SpecState) -> float:
    bad = st.bad - st.genesis[0]
    total = st.total - st.genesis[1]
    if total <= 0.0:
      return 0.0
    return (bad / total) / spec.budget

  def _emit(self, spec: SloSpec, st: _SpecState, step: int,
            severity: str, trigger: str, fast: float, slow: float,
            consumed: float, now: float) -> Dict[str, Any]:
    st.incidents += 1
    record = runlog_lib.make_incident(
        sentinel_lib.SLO_BURN, step=step, severity=severity,
        value=round(consumed, 6), threshold=spec.budget,
        detail={
            "slo": spec.name, "trigger": trigger,
            "fast_burn": round(fast, 4), "slow_burn": round(slow, 4),
            "budget_consumed": round(consumed, 6),
            "bad": st.bad - st.genesis[0],
            "total": st.total - st.genesis[1],
            "observed_s": round(now - st.samples[0][0], 3),
            "spec": spec.describe(),
        })
    reg = self._reg()
    reg.counter("sentinel/incidents").inc()
    reg.counter(f"sentinel/{sentinel_lib.SLO_BURN}").inc()
    for sink in self._sinks:
      try:
        sink(record)
      except Exception:  # noqa: BLE001 - a sink must not break evaluation
        pass
    return record

  def state(self, now: Optional[float] = None) -> Dict[str, Any]:
    """JSON-safe per-spec budget state (a run record's `slo` block)."""
    out: Dict[str, Any] = {}
    for spec in self._specs:
      st = self._state[spec.name]
      at = now if now is not None else (st.samples[-1][0]
                                        if st.samples else 0.0)
      bad = st.bad - (st.genesis[0] if st.genesis else 0.0)
      total = st.total - (st.genesis[1] if st.genesis else 0.0)
      out[spec.name] = {
          "kind": spec.kind,
          "budget": spec.budget,
          "bad": bad,
          "total": total,
          "ratio": round(bad / total, 6) if total else 0.0,
          "fast_burn": round(_windowed_burn(
              st.samples, at, spec.fast_window_s, spec.budget), 4),
          "slow_burn": round(_windowed_burn(
              st.samples, at, spec.slow_window_s, spec.budget), 4),
          "budget_consumed": round(self._consumed(spec, st), 6),
          "burning": st.burning,
          "exhausted": st.exhausted,
          "incidents": st.incidents,
      }
    return out

  def worst_burn(self) -> float:
    """Max fast-window burn across specs — the one-number headline
    scalar (`slo_budget_burn`, diff-gated up-bad)."""
    state = self.state()
    return max((entry["fast_burn"] for entry in state.values()),
               default=0.0)

  def healthy(self) -> bool:
    return not any(st.burning or st.exhausted
                   for st in self._state.values())


def evaluate_snapshot(specs: Sequence[SloSpec],
                      snapshot: Mapping[str, float]) -> Dict[str, Any]:
  """Windowless point-in-time judgment of one flat snapshot (summed
  graftrace metrics shards, a registry snapshot): cumulative bad/total
  per spec vs its budget. `ok` is the watch dashboard's health bit —
  cumulative-over-budget means the budget is ALREADY spent, whatever
  the windows would say. VALUE specs judge the current value against
  the ceiling directly (one sample is all a point-in-time read has)."""
  out: Dict[str, Any] = {}
  for spec in specs:
    if spec.kind == RATIO:
      bad = float(snapshot.get(spec.bad_key, 0.0) or 0.0)
      total = float(snapshot.get(spec.total_key, 0.0) or 0.0)
      ratio = bad / total if total else 0.0
      consumed = (ratio / spec.budget) if total else 0.0
      out[spec.name] = {
          "kind": RATIO, "bad": bad, "total": total,
          "ratio": round(ratio, 6), "budget": spec.budget,
          "budget_consumed": round(consumed, 6),
          "ok": consumed < 1.0,
      }
    else:
      value = snapshot.get(spec.value_key)
      breached = value is not None and float(value) > spec.ceiling
      out[spec.name] = {
          "kind": VALUE,
          "value": None if value is None else float(value),
          "ceiling": spec.ceiling, "budget": spec.budget,
          "ok": not breached,
      }
  return out


@config.configurable
def default_serving_slos(latency_budget: float = 0.01,
                         shed_budget: float = 0.02,
                         fast_window_s: float = 60.0,
                         slow_window_s: float = 300.0,
                         burn_factor: float = DEFAULT_BURN_FACTOR
                         ) -> List[SloSpec]:
  """The stock serving objectives (fleet bench, watch default):
  latency-SLO breach ratio and fleet shed ratio over routed requests.
  Budgets/windows are explicit HERE so every construction site stays
  `slo-unbudgeted`-clean — override per deployment via config."""
  return [
      SloSpec(
          "serve_latency", budget=latency_budget,
          fast_window_s=fast_window_s, slow_window_s=slow_window_s,
          bad_key="counter/serve/slo_breaches",
          total_key="counter/serve/fleet/requests",
          burn_factor=burn_factor,
          description="end-to-end predict latency over the fleet's "
                      "latency_slo_ms, as counted by "
                      "obs.sentinel.observe_serving_latency"),
      SloSpec(
          "serve_shed", budget=shed_budget,
          fast_window_s=fast_window_s, slow_window_s=slow_window_s,
          bad_key="counter/serve/fleet/shed",
          total_key="counter/serve/fleet/requests",
          burn_factor=burn_factor,
          description="queue-bound sheds over routed requests "
                      "(admission refusals are budgeted errors)"),
  ]


@config.configurable
def default_loop_slos(staleness_bound: float = 1.0,
                      publish_to_serve_ms: float = 60000.0,
                      sample_budget: float = 0.1,
                      fast_window_s: float = 30.0,
                      slow_window_s: float = 120.0,
                      burn_factor: float = DEFAULT_BURN_FACTOR
                      ) -> List[SloSpec]:
  """The graftloop objectives: policy staleness (served versions behind
  the published head) and publish-to-serve deploy latency, both VALUE
  specs over the loop's existing telemetry."""
  return [
      SloSpec(
          "loop_staleness", budget=sample_budget,
          fast_window_s=fast_window_s, slow_window_s=slow_window_s,
          value_key="gauge/loop/staleness",
          ceiling=staleness_bound, burn_factor=burn_factor,
          description="served-policy staleness in published versions"),
      SloSpec(
          "loop_publish_to_serve", budget=sample_budget,
          fast_window_s=fast_window_s, slow_window_s=slow_window_s,
          value_key="hist/loop/publish_to_serve_ms/max",
          ceiling=publish_to_serve_ms, burn_factor=burn_factor,
          description="worst checkpoint-verified -> rollout-complete "
                      "deploy latency"),
  ]
