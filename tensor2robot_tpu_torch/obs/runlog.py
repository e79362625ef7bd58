"""Run-history records (`runs.jsonl`) and regression diffing.

The port's own copy of the JAX package's `obs.runlog`, kept separate so
that the PyTorch port never imports the JAX package; the record schema
is the same, so `graftscope diff` compares runs of either package. Every
train run appends ONE schema-versioned JSON line — step-stat summary,
memory watermark, sentinel and recovery blocks — to an append-only
`runs.jsonl`, and `diff_records` compares two records' canonical metrics
against direction-aware regression thresholds (throughput regresses
DOWN, step time / compile time / watermark regress UP). A run whose step
was compiled (`train_eval_model(executable_cache_dir=...)`) carries the
`compile` block of `obs.xray` records, and `compile_time_s` is its
train step's first-call wall; an eager run has none, and the compile
metrics are simply absent.

Readers are tolerant by contract: a torn tail line from a live run or a
corrupt record is skipped and counted (`runlog/corrupt_lines`), never
raised — same discipline as `bin/graftscope`'s metrics reader.

Framework-free by construction (stdlib + the metrics registry only), so
`python -m tensor2robot_tpu_torch.bin.graftscope diff` is safe beside a
job that owns the card (tests/test_torch_telemetry.py imports it with
torch blocked).
"""

from __future__ import annotations

import json
import os
import sys
import time
import uuid
from typing import Any, Dict, List, Optional, Sequence, Tuple

from tensor2robot_tpu_torch.obs import metrics as metrics_lib

__all__ = ["SCHEMA", "SCHEMA_VERSION", "RUNS_FILENAME", "new_run_id",
           "make_record", "append_record", "read_jsonl", "load_records",
           "step_stats_summary", "overlap_summary", "key_metrics",
           "DEFAULT_THRESHOLDS",
           "diff_records", "format_diff", "trend_records", "format_trend",
           "resolve_run", "history_lines",
           "RunResolveError", "INCIDENT_SCHEMA", "INCIDENTS_FILENAME",
           "make_incident"]

SCHEMA = "graftscope-run-v1"
SCHEMA_VERSION = 1
RUNS_FILENAME = "runs.jsonl"

# Online-anomaly incident records (`obs.sentinel` is the writer; the
# flight recorder and `graftscope postmortem` are the readers). One
# JSON line per incident in `incidents.jsonl`, same tolerant-reader /
# fsynced-append contract as runs.jsonl.
INCIDENT_SCHEMA = "graftscope-incident-v1"
INCIDENT_SCHEMA_VERSION = 1
INCIDENTS_FILENAME = "incidents.jsonl"

# metric name -> (bad direction, default relative threshold). "up" means
# an increase beyond the threshold is a regression; "down" a decrease.
# The JAX package's table, unchanged, so a record of either package diffs
# alike: compile time gets the loosest band (host-load noise swings it),
# flops the tightest (a deterministic count), wall-clock bench figures a
# loose 50% band and the paired (load-invariant) ratios 15%. The bench
# families' keys stay for records the JAX package's bench writes.
DEFAULT_THRESHOLDS: Dict[str, Tuple[str, float]] = {
    "examples_per_sec": ("down", 0.10),
    "mfu": ("down", 0.10),
    "step_ms": ("up", 0.10),
    "compile_time_s": ("up", 0.50),
    "flops_per_step": ("up", 0.05),
    "bytes_per_step": ("up", 0.10),
    "jaxpr_eqns": ("up", 0.25),
    "hbm_watermark_bytes": ("up", 0.10),
    "stager_vs_python_chain": ("down", 0.15),
    "data_vs_synthetic": ("down", 0.15),
    "warmup_ms": ("up", 0.50),
    "cold_vs_warm_warmup": ("down", 0.30),
    "onefonb_vs_gpipe": ("down", 0.15),
    "pp_bubble_fraction": ("up", 0.02),
    "session_vs_stateless": ("down", 0.15),
    "decode_tick_ms": ("up", 0.50),
    "decode_kernel_vs_xla": ("down", 0.15),
    "fleet_vs_single_replica": ("down", 0.15),
    "fleet_rollout_shed": ("up", 0.0),
    "chaos_goodput_ratio": ("down", 0.15),
    "chaos_recovery_ms": ("up", 0.50),
    "loop_goodput_ratio": ("down", 0.15),
    "publish_to_serve_ms": ("up", 0.50),
    "forged_vs_cold": ("down", 0.30),
    "forged_start_ms": ("up", 0.50),
    "forge_compile_share": ("up", 0.0),
    "lint_parse_ms": ("up", 0.50),
    "lint_rules_ms": ("up", 0.50),
    "serve_queue_wait_p99_ms": ("up", 0.50),
    "trace_overhead_ratio": ("up", 0.50),
    "fleet_utilization": ("down", 0.50),
    "slo_budget_burn": ("up", 1.00),
}


class RunResolveError(ValueError):
  """A run reference did not resolve to a record (CLI exits 2 on it)."""


def new_run_id() -> str:
  return (time.strftime("%Y%m%dT%H%M%S")
          + f"-{os.getpid()}-{uuid.uuid4().hex[:6]}")


def make_record(kind: str,
                run_id: Optional[str] = None,
                platform: Optional[str] = None,
                device_kind: Optional[str] = None,
                num_devices: Optional[int] = None,
                step_stats: Optional[Dict[str, float]] = None,
                compile_records: Optional[Sequence[Dict[str, Any]]] = None,
                memory: Optional[Dict[str, float]] = None,
                bench: Optional[Dict[str, Any]] = None,
                extra: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
  """One schema-versioned run record (JSON-safe plain dict)."""
  if kind not in ("train", "bench"):
    raise ValueError(f"Unknown run-record kind {kind!r}")
  record: Dict[str, Any] = {
      "schema": SCHEMA,
      "schema_version": SCHEMA_VERSION,
      "kind": kind,
      "run_id": run_id or new_run_id(),
      "unix_time": time.time(),
  }
  if platform is not None:
    record["platform"] = platform
  if device_kind is not None:
    record["device_kind"] = device_kind
  if num_devices is not None:
    record["num_devices"] = int(num_devices)
  if step_stats:
    record["step_stats"] = dict(step_stats)
  if compile_records:
    record["compile"] = [dict(r) for r in compile_records]
  if memory:
    record["memory"] = dict(memory)
  if bench:
    record["bench"] = dict(bench)
  if extra:
    record["extra"] = dict(extra)
  return record


def make_incident(kind: str,
                  step: Optional[int] = None,
                  severity: str = "warn",
                  value: Optional[float] = None,
                  threshold: Optional[float] = None,
                  detail: Optional[Dict[str, Any]] = None,
                  unix_time: Optional[float] = None) -> Dict[str, Any]:
  """One schema-versioned `graftscope-incident-v1` record (JSON-safe).

  `severity` is `"warn"` (informational anomaly) or `"fatal"` (the run
  is diverging/dying — the flight recorder dumps a postmortem bundle on
  these). A non-finite `value` — the whole point of a nonfinite-loss
  incident — would violate the strict-JSON append contract
  (allow_nan=False), so it is recorded as `detail["value_repr"]` and
  the numeric field dropped.
  """
  if severity not in ("warn", "fatal"):
    raise ValueError(f"Unknown incident severity {severity!r}")
  record: Dict[str, Any] = {
      "schema": INCIDENT_SCHEMA,
      "schema_version": INCIDENT_SCHEMA_VERSION,
      "kind": str(kind),
      "severity": severity,
      "unix_time": time.time() if unix_time is None else float(unix_time),
  }
  detail = dict(detail or {})
  if step is not None:
    record["step"] = int(step)
  if value is not None:
    value = float(value)
    if value == value and abs(value) != float("inf"):
      record["value"] = value
    else:
      detail["value_repr"] = repr(value)
  if threshold is not None:
    record["threshold"] = float(threshold)
  if detail:
    record["detail"] = detail
  return record


def append_record(path: str, record: Dict[str, Any]) -> str:
  """Appends one strict-JSON line (fsynced — a crash right after a run
  must not lose the record); returns `path`."""
  os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
  line = json.dumps(record, allow_nan=False, sort_keys=True)
  with open(path, "a") as f:
    f.write(line + "\n")
    f.flush()
    os.fsync(f.fileno())
  return path


def read_jsonl(path: str, counter_name: str = "runlog/corrupt_lines",
               registry: Optional[metrics_lib.Registry] = None
               ) -> Tuple[List[Dict[str, Any]], int]:
  """THE tolerant JSONL reader: (dict records, corrupt-line count).

  Corrupt / truncated lines (torn tail of a live run, binary garbage,
  disk hiccups) are skipped with a stderr warning and counted in
  `counter/<counter_name>` — a reader must never raise on a file a
  crashed writer left behind (`errors="replace"` keeps even invalid
  UTF-8 from raising). A missing file is an empty history. The one
  shared implementation behind `load_records` AND `bin/graftscope`'s
  metrics reader, so a tolerance fix lands in both.
  """
  reg = registry or metrics_lib.get_registry()
  records: List[Dict[str, Any]] = []
  if not os.path.isfile(path):
    return records, 0
  skipped = 0
  try:
    with open(path, errors="replace") as f:
      for line in f:
        line = line.strip()
        if not line:
          continue
        try:
          record = json.loads(line)
          if not isinstance(record, dict):
            raise ValueError("record is not an object")
          records.append(record)
        except ValueError:
          skipped += 1
  except OSError as e:
    print(f"runlog: cannot read {path}: {e}", file=sys.stderr)
    skipped += 1
  if skipped:
    reg.counter(counter_name).inc(skipped)
    print(f"runlog: skipped {skipped} corrupt line(s) in {path}",
          file=sys.stderr)
  return records, skipped


def load_records(path: str,
                 registry: Optional[metrics_lib.Registry] = None
                 ) -> List[Dict[str, Any]]:
  """Every parseable record in `path`, oldest first (see `read_jsonl`)."""
  records, _ = read_jsonl(path, registry=registry)
  return records


def step_stats_summary(snapshot: Dict[str, float]) -> Dict[str, float]:
  """Run-record step-stat summary from a metrics-registry snapshot
  (the `stepstats/*` histograms `obs.stepstats` feeds every window)."""
  out: Dict[str, float] = {}
  for hist, dst in (("step_ms", "step_ms"), ("device_ms", "device_ms"),
                    ("data_wait_ms", "data_wait_ms"),
                    ("examples_per_sec", "examples_per_sec")):
    for stat in ("mean", "p50", "p90"):
      value = snapshot.get(f"hist/stepstats/{hist}/{stat}")
      if value is not None:
        out[f"{dst}_{stat}"] = float(value)
  count = snapshot.get("hist/stepstats/step_ms/count")
  if count is not None:
    out["windows"] = float(count)
  compiles = snapshot.get("counter/stepstats/compile_events")
  if compiles is not None:
    out["compile_events"] = float(compiles)
  # Overlapped-host-pipeline attribution, so a data_wait_ms movement in
  # a diff is attributable stage by stage from the same record.
  out.update(overlap_summary(snapshot))
  return out


def overlap_summary(snapshot: Dict[str, float]) -> Dict[str, float]:
  """`data/overlap_*` stage attribution from a registry snapshot —
  per-stage timing means/p90s and queue-depth gauges (fed by
  data/overlap.py + DevicePrefetcher), under ONE canonical key shape
  (`overlap_<stage>_<stat>`). The single munging shared by the train
  run record (`step_stats_summary`) and the bench headline's `overlap`
  block, so one runs.jsonl history can never carry two spellings of
  the same stage metric."""
  out: Dict[str, float] = {}
  for key, value in snapshot.items():
    if key.startswith("hist/data/overlap_") and key.endswith(
        ("/mean", "/p90")):
      out["overlap_"
          + key[len("hist/data/overlap_"):].replace("/", "_")] = (
              float(value))
    elif key.startswith("gauge/data/overlap_"):
      out["overlap_" + key[len("gauge/data/overlap_"):]] = float(value)
  return out


def _primary_compile_record(record: Dict[str, Any]
                            ) -> Optional[Dict[str, Any]]:
  """The PRIMARY compile record — the first train-named one (the main
  loop/step, analyzed on first dispatch), falling back to the first.
  Summing across records would diff the telemetry SHAPE, not the
  compiler: a run that also analyzed a loop tail or an in-process
  predictor must not read as a compile-time regression against one
  that didn't."""
  compiles = record.get("compile") or []
  if not compiles:
    return None
  return next((r for r in compiles
               if "train" in str(r.get("name", ""))), compiles[0])


def _primary_compile_cache_hit(record: Dict[str, Any]) -> Optional[bool]:
  """Whether the primary executable came out of graftcache (None when
  the record carries no compile records or no cache block)."""
  primary = _primary_compile_record(record)
  if primary is None or "cache" not in primary:
    return None
  return bool((primary.get("cache") or {}).get("hit"))


# Bench headline fields that `key_metrics` reads under their own names
# (records of the JAX package's bench families).
_BENCH_HEADLINE_KEYS = (
    "mfu", "stager_vs_python_chain", "data_vs_synthetic", "warmup_ms",
    "cold_vs_warm_warmup", "onefonb_vs_gpipe", "pp_bubble_fraction",
    "session_vs_stateless", "decode_tick_ms", "decode_kernel_vs_xla",
    "fleet_vs_single_replica", "chaos_goodput_ratio", "chaos_recovery_ms",
    "forged_vs_cold", "forged_start_ms", "forge_compile_share",
    "lint_parse_ms", "lint_rules_ms", "serve_queue_wait_p99_ms",
    "trace_overhead_ratio", "fleet_utilization", "slo_budget_burn")


def key_metrics(record: Dict[str, Any]) -> Dict[str, float]:
  """The canonical comparable metrics of one record (diff vocabulary).

  Sourced in priority order: step-stat summary, then bench headline
  fields, then compile records (the `train`-named record is primary),
  then the memory watermark. Missing sources just omit keys.
  """
  out: Dict[str, float] = {}
  step_stats = record.get("step_stats") or {}
  if step_stats.get("examples_per_sec_mean") is not None:
    out["examples_per_sec"] = float(step_stats["examples_per_sec_mean"])
  if step_stats.get("step_ms_mean") is not None:
    out["step_ms"] = float(step_stats["step_ms_mean"])
  bench = record.get("bench") or {}
  if bench.get("value") is not None and "sec" in str(bench.get("unit", "")):
    out.setdefault("examples_per_sec", float(bench["value"]))
  if bench.get("step_sec") is not None:
    out.setdefault("step_ms", float(bench["step_sec"]) * 1e3)
  for name in _BENCH_HEADLINE_KEYS:
    if bench.get(name) is not None:
      out[name] = float(bench[name])
  rollout = bench.get("rollout") or {}
  if rollout.get("window_shed") is not None:
    out["fleet_rollout_shed"] = float(rollout["window_shed"])
  compiles = record.get("compile") or []
  if compiles:
    primary = _primary_compile_record(record)
    out["compile_time_s"] = (
        float(primary.get("trace_s") or 0.0)
        + float(primary.get("lower_s") or 0.0)
        + float(primary.get("compile_s") or 0.0))
    for src, dst in (("flops", "flops_per_step"),
                     ("bytes_accessed", "bytes_per_step"),
                     ("jaxpr_eqns", "jaxpr_eqns")):
      if primary.get(src) is not None:
        out[dst] = float(primary[src])
  memory = record.get("memory") or {}
  if memory.get("hbm_watermark_bytes"):
    out["hbm_watermark_bytes"] = float(memory["hbm_watermark_bytes"])
  return out


def _bench_not_comparable(a: Dict[str, Any], b: Dict[str, Any]) -> bool:
  """True when two bench records' headline numbers measure different
  things: different metric names, or the same smoke metric across the
  record-fed semantic boundary (`data_vs_synthetic` on one side
  only). `diff_records` lists-but-never-flags across these; the
  matching `comparability_warnings` entries do the shouting."""
  metric_a = (a.get("bench") or {}).get("metric")
  metric_b = (b.get("bench") or {}).get("metric")
  if not metric_a or not metric_b:
    return False
  if metric_a != metric_b:
    return True
  has_dvs_a = (a.get("bench") or {}).get("data_vs_synthetic") is not None
  has_dvs_b = (b.get("bench") or {}).get("data_vs_synthetic") is not None
  return has_dvs_a != has_dvs_b


def diff_records(a: Dict[str, Any], b: Dict[str, Any],
                 thresholds: Optional[Dict[str, Tuple[str, float]]] = None,
                 default_threshold: float = 0.10
                 ) -> List[Dict[str, Any]]:
  """Metric deltas b-vs-a with direction-aware regression flags.

  `thresholds` overrides/extends `DEFAULT_THRESHOLDS` per metric;
  metrics absent from both maps regress on |relative change| >
  `default_threshold`. A metric present in only one record is listed
  (delta None) but never flagged — new telemetry must not read as a
  regression. Two bench records with DIFFERENT bench metric names
  (accelerator headline vs CPU fallback, cold-start vs warm-start,
  serve vs data) are likewise listed-not-flagged: `comparability_warnings`
  already shouts that the deltas are not meaningful, and a bogus
  exit-3 across that boundary would train people to ignore the gate.
  """
  merged = dict(DEFAULT_THRESHOLDS)
  merged.update(thresholds or {})
  cross_metric = _bench_not_comparable(a, b)
  hit_a, hit_b = (_primary_compile_cache_hit(a),
                  _primary_compile_cache_hit(b))
  cache_hit_differs = (hit_a is not None and hit_b is not None
                       and hit_a != hit_b)
  metrics_a, metrics_b = key_metrics(a), key_metrics(b)
  deltas: List[Dict[str, Any]] = []
  for name in sorted(set(metrics_a) | set(metrics_b)):
    va, vb = metrics_a.get(name), metrics_b.get(name)
    entry: Dict[str, Any] = {"metric": name, "a": va, "b": vb,
                             "delta": None, "rel": None,
                             "regressed": False}
    if va is not None and vb is not None:
      entry["delta"] = vb - va
      rel = ((vb - va) / abs(va)) if va else (0.0 if vb == va
                                             else float("inf"))
      entry["rel"] = rel
      direction, threshold = merged.get(name, (None, default_threshold))
      entry["threshold"] = threshold
      if direction == "up":
        entry["regressed"] = rel > threshold
      elif direction == "down":
        entry["regressed"] = rel < -threshold
      else:
        entry["regressed"] = abs(rel) > threshold
      if cross_metric:
        entry["regressed"] = False
      if name == "compile_time_s" and cache_hit_differs:
        # A cache HIT rewrites compile_s to ~0 (the compile was paid by
        # an earlier process); hit-vs-miss compile-time deltas price
        # cache economics, not the compiler. Listed + warned, never
        # flagged.
        entry["regressed"] = False
    deltas.append(entry)
  return deltas


def _describe(record: Dict[str, Any]) -> str:
  when = record.get("unix_time")
  stamp = (time.strftime("%Y-%m-%d %H:%M:%S", time.localtime(when))
           if when else "?")
  return (f"{record.get('run_id', '?')} ({record.get('kind', '?')}, "
          f"{record.get('platform', '?')}, {stamp})")


def comparability_warnings(a: Dict[str, Any], b: Dict[str, Any]
                           ) -> List[str]:
  """Reasons the two records' deltas may not be meaningful.

  The recurring case: a bench that fell back to its CPU smoke config
  (its own metric name, NOT comparable to the accelerator number)
  lands in the same `runs.jsonl` as the accelerator's, and
  `key_metrics` folds both onto `examples_per_sec`. Diffing across
  that boundary must shout, not silently flag a bogus regression.
  """
  warnings = []
  for field in ("platform", "kind", "device_kind"):
    va, vb = a.get(field), b.get(field)
    if va and vb and va != vb:
      warnings.append(f"{field} differs: {va} vs {vb}")
  metric_a = (a.get("bench") or {}).get("metric")
  metric_b = (b.get("bench") or {}).get("metric")
  if metric_a and metric_b and metric_a != metric_b:
    warnings.append(f"bench metric differs: {metric_a} vs {metric_b}")
  # The JAX package's smoke headline switched from a synthetic
  # device-resident feed to the real record pipeline under one name; a
  # record-fed headline carries data_vs_synthetic, and diffing it
  # against a synthetic one is a measurement change, not a regression.
  has_dvs_a = (a.get("bench") or {}).get("data_vs_synthetic") is not None
  has_dvs_b = (b.get("bench") or {}).get("data_vs_synthetic") is not None
  if metric_a and metric_a == metric_b and has_dvs_a != has_dvs_b:
    warnings.append(
        "smoke headline semantics differ: one side is record-fed "
        "(data_vs_synthetic present), the other synthetic")
  hit_a, hit_b = (_primary_compile_cache_hit(a),
                  _primary_compile_cache_hit(b))
  if hit_a is not None and hit_b is not None and hit_a != hit_b:
    warnings.append(
        "graftcache hit/miss differs for the primary executable: "
        "compile_time_s deltas price cache economics, not the compiler")
  return warnings


def format_diff(a: Dict[str, Any], b: Dict[str, Any],
                deltas: Sequence[Dict[str, Any]]) -> str:
  lines = ["graftscope diff",
           f"  A: {_describe(a)}",
           f"  B: {_describe(b)}"]
  for warning in comparability_warnings(a, b):
    lines.append(f"  WARNING: {warning} — deltas may not be comparable")
  lines.append(f"  {'metric':<22}{'A':>16}{'B':>16}{'Δ%':>9}  verdict")
  regressions = 0
  for d in deltas:
    fmt = lambda v: f"{v:>16.6g}" if v is not None else f"{'—':>16}"
    if d["rel"] is None:
      verdict = "(only one run)"
      rel = f"{'—':>9}"
    else:
      rel = f"{100.0 * d['rel']:>+8.1f}%"
      if d["regressed"]:
        regressions += 1
        verdict = f"REGRESSED (>{100.0 * d['threshold']:.0f}%)"
      else:
        verdict = "ok"
    lines.append(f"  {d['metric']:<22}{fmt(d['a'])}{fmt(d['b'])}"
                 f"{rel}  {verdict}")
  lines.append(f"  {regressions} regression(s) beyond threshold"
               if regressions else "  no regressions beyond thresholds")
  return "\n".join(lines) + "\n"


def _median(values: Sequence[float]) -> float:
  ordered = sorted(values)
  mid = len(ordered) // 2
  if len(ordered) % 2:
    return float(ordered[mid])
  return (ordered[mid - 1] + ordered[mid]) / 2.0


def trend_records(records: Sequence[Dict[str, Any]], k: int = 3,
                  thresholds: Optional[Dict[str, Tuple[str, float]]] = None,
                  default_threshold: float = 0.10
                  ) -> List[Dict[str, Any]]:
  """N-record trend evaluation (`graftscope diff --trend`): per key
  metric, the MEDIAN of the last `k` records against the median of the
  `k` before them, judged by the same direction-aware thresholds
  `diff_records` uses.

  Pairwise diffing two wall-clock-noisy records flaps; the
  median-of-K window is the same trick the bench's paired arms use,
  applied along the history axis — a metric must move for several
  consecutive runs before the trend flags. Metrics with fewer than
  `k + 1` observations are skipped (no prior window to difference
  against); the prior window is allowed to be short (down to one
  record) so a freshly added metric starts trending as soon as it has
  any history at all. Records whose `key_metrics` lack a metric simply
  don't contribute to that metric's series (mixed-family histories —
  one runs.jsonl holding train AND fleet records — trend per metric,
  not per record).
  """
  if k < 1:
    raise ValueError(f"k must be >= 1, got {k}")
  series: Dict[str, List[float]] = {}
  for record in records:
    for name, value in key_metrics(record).items():
      series.setdefault(name, []).append(float(value))
  merged = dict(DEFAULT_THRESHOLDS)
  merged.update(thresholds or {})
  out: List[Dict[str, Any]] = []
  for name in sorted(series):
    values = series[name]
    if len(values) < k + 1:
      continue
    recent = values[-k:]
    prior = values[max(len(values) - 2 * k, 0):-k]
    recent_med = _median(recent)
    prior_med = _median(prior)
    delta = recent_med - prior_med
    rel = ((delta / abs(prior_med)) if prior_med
           else (0.0 if recent_med == prior_med else float("inf")))
    direction, threshold = merged.get(name, (None, default_threshold))
    if direction == "up":
      regressed = rel > threshold
    elif direction == "down":
      regressed = rel < -threshold
    else:
      regressed = abs(rel) > threshold
    out.append({
        "metric": name, "n": len(values),
        "prior": prior_med, "recent": recent_med,
        "delta": delta, "rel": rel,
        "threshold": threshold, "regressed": regressed,
    })
  return out


def format_trend(source: str, trends: Sequence[Dict[str, Any]],
                 k: int = 3) -> str:
  lines = [f"graftscope trend: {source} "
           f"(median of last {k} vs prior {k})",
           f"  {'metric':<22}{'prior':>16}{'recent':>16}{'Δ%':>9}"
           "  verdict"]
  regressions = 0
  for t in trends:
    rel = (f"{100.0 * t['rel']:>+8.1f}%" if t["rel"] != float("inf")
           else f"{'+inf':>9}")
    if t["regressed"]:
      regressions += 1
      verdict = f"REGRESSED (>{100.0 * t['threshold']:.0f}%)"
    else:
      verdict = "ok"
    lines.append(f"  {t['metric']:<22}{t['prior']:>16.6g}"
                 f"{t['recent']:>16.6g}{rel}  {verdict}")
  if not trends:
    lines.append("  (no metric has enough history to trend)")
  lines.append(f"  {regressions} trend regression(s) beyond threshold"
               if regressions else "  no trend regressions beyond "
               "thresholds")
  return "\n".join(lines) + "\n"


def resolve_run(ref: str) -> Tuple[Dict[str, Any], str]:
  """Resolves a run reference to (record, description).

  A reference is a model_dir (its `runs.jsonl`), a `runs.jsonl` path,
  or either with a `#selector` suffix — a run_id, or an integer index
  into the file (negative from the end). Without a selector the LATEST
  record wins.
  """
  path, selector = ref, None
  if not os.path.exists(path) and "#" in path:
    path, selector = path.rsplit("#", 1)
  if os.path.isdir(path):
    path = os.path.join(path, RUNS_FILENAME)
  if not os.path.isfile(path):
    raise RunResolveError(
        f"no run history at {ref!r} (no such file: {path})")
  records = load_records(path)
  if not records:
    raise RunResolveError(f"no parseable run records in {path}")
  if selector is None:
    return records[-1], f"{path} (latest of {len(records)})"
  try:
    index = int(selector)
  except ValueError:
    for record in reversed(records):
      if record.get("run_id") == selector:
        return record, f"{path}#{selector}"
    raise RunResolveError(f"run_id {selector!r} not found in {path}")
  try:
    return records[index], f"{path}#{index}"
  except IndexError:
    raise RunResolveError(
        f"index {index} out of range ({len(records)} record(s) in {path})")


def history_lines(records: Sequence[Dict[str, Any]], source: str
                  ) -> List[str]:
  """One line per record for `graftscope history`."""
  lines = [f"run history: {source} ({len(records)} record(s))"]
  for i, record in enumerate(records):
    metrics = key_metrics(record)
    parts = []
    for name in ("examples_per_sec", "step_ms", "compile_time_s",
                 "hbm_watermark_bytes"):
      if name in metrics:
        parts.append(f"{name}={metrics[name]:.6g}")
    lines.append(f"  [{i}] {_describe(record)} " + " ".join(parts))
  return lines
