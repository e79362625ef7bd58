"""graftscope reader CLI: reports, run history, regression diffs and
postmortems of the port's telemetry.

The write side lives in `tensor2robot_tpu_torch/obs/` (span tracer,
metrics registry, step stats, runlog, sentinel, flight recorder); this is
the read side, the port's copy of the JAX package's CLI. On the same
files the two render the same text (the heading of a profiler directory
aside), so either reads a model_dir written by either package; the
heartbeat keeps the JAX package's name, `tunnel heartbeat`:

  python -m tensor2robot_tpu_torch.bin.graftscope <model_dir> [--top N]
      walk the model_dir for `metrics.jsonl` streams, Chrome trace
      JSONs, `runs.jsonl` and profiler dirs; render the step-time
      breakdown, counters, gauges, histograms, slowest spans and the
      latest run's summary ("report" may be spelled explicitly);
  python -m tensor2robot_tpu_torch.bin.graftscope history <dir-or-runs.jsonl>
      one line per recorded run (index, run_id, key metrics);
  python -m tensor2robot_tpu_torch.bin.graftscope diff <runA> <runB>
      metric deltas with direction-aware regression thresholds
      (`obs.runlog.DEFAULT_THRESHOLDS`; override per metric with
      --threshold name=rel). A run reference is a model_dir, a
      runs.jsonl path, or either with `#run_id` / `#index` (negative
      from the end); bare paths mean the LATEST record. Exit 3 = a
      delta crossed its regression threshold (0 ok, 2 bad reference).
      `diff --trend <source>` instead evaluates the drift across the
      last 2K records of one runs.jsonl (median of the last K runs vs
      the prior K, per key metric);
  python -m tensor2robot_tpu_torch.bin.graftscope postmortem <dir>
      render a flight-recorder bundle (`obs.flightrec`, written on
      crash/SIGTERM/hang/fatal incident): the last N recorded steps,
      the incident timeline (bundle + the model_dir's incidents.jsonl),
      the heartbeat transitions, and the crash traceback. <dir> is a
      bundle dir, a flightrec/ dir, a model_dir (searched recursively;
      latest bundle by default, select with --index), or a
      postmortem.json path; --list enumerates bundles.

  python -m tensor2robot_tpu_torch.bin.graftscope timeline <dir> [--out P]
      merge every graftrace `trace-<pid>-<gen>.json` shard under <dir>
      (`obs.graftrace.flush`) into one clock-aligned Perfetto JSON with
      flow arrows along the causal edges (`obs.aggregate`); exit 0
      merged, 1 no usable shards, 2 usage;
  python -m tensor2robot_tpu_torch.bin.graftscope watch <dir> [--snapshot]
      a dashboard over the `metrics-<pid>-<gen>.json` shards: workers
      and shard ages (stale ones excluded), request counters and
      latency, per-group busy time and point-in-time SLO judgments
      (`obs.slo.default_serving_slos`); `--json` emits the frame; exit 0
      within budget, 1 over budget, 2 unreadable.

  python -m tensor2robot_tpu_torch.bin.graftscope cache <cache_dir>
      list, `--verify` (exit 1 on a bad entry) or `--evict` graftcache
      entries (`obs.excache`; sidecars only);
  python -m tensor2robot_tpu_torch.bin.graftscope forge <config.gin>
      the compile farm (`obs.forge`): `--plan` prints the enumeration,
      the default compiles every forgeable target into `--cache-dir`,
      `--verify` checks a cache against the plan without compiling;
      exit 0 ok, 1 missing or bad entries or farm errors, 2 usage.

  python -m tensor2robot_tpu_torch.bin.graftscope audit <config.gin>
      graftaudit (`analysis.graph_audit`): trace every compiled step the
      config deploys on fake tensors in a worker (on `--device`, default
      cuda) and audit the FX graphs; exit 0 clean, 1 findings or target
      errors, 2 usage (a missing config: "no such config").

Robustness contract: a torn tail line of a live run, a truncated trace
JSON, or binary garbage in any telemetry file is skipped with a warning
counter (`graftscope/corrupt_lines`, surfaced in the report) — the
reader NEVER raises on files a crashed writer left behind; a missing
model_dir is a clear message + exit 2. Framework-free (argparse, stdlib
only): safe to run beside a job that owns the card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Any, Dict, List, Optional, Tuple

from tensor2robot_tpu_torch.obs import flightrec as flightrec_lib
from tensor2robot_tpu_torch.obs import metrics as metrics_lib
from tensor2robot_tpu_torch.obs import runlog as runlog_lib

__all__ = ["build_report", "render_postmortem", "main"]

_PROG = "python -m tensor2robot_tpu_torch.bin.graftscope"

_SKIP_DIRS = {"checkpoints", "__pycache__", ".git"}
# Per-step record signature written by obs.stepstats via StepStatsHook.
_STEP_KEYS = ("data_wait_ms", "device_ms", "examples_per_sec")
_BREAKDOWN_ROWS = ("step_ms", "device_ms", "data_wait_ms", "host_ms",
                   "dispatch_ms")


def _discover(model_dir: str) -> Tuple[List[str], List[str], List[str]]:
  """(metrics.jsonl files, chrome-trace JSONs, profiler dirs)."""
  metrics_files: List[str] = []
  trace_files: List[str] = []
  profile_dirs: List[str] = []
  for dirpath, dirnames, filenames in os.walk(model_dir):
    dirnames[:] = sorted(d for d in dirnames if d not in _SKIP_DIRS)
    for name in sorted(filenames):
      path = os.path.join(dirpath, name)
      if name == "metrics.jsonl":
        metrics_files.append(path)
      elif name.endswith(".json") and "trace" in name:
        trace_files.append(path)
    if (os.path.basename(dirpath) == "profile"
        or "plugins" in dirnames):  # TensorBoard profiles: plugins/profile
      profile_dirs.append(dirpath)
  return metrics_files, trace_files, sorted(set(profile_dirs))


def _load_jsonl(path: str) -> Tuple[List[dict], int]:
  """(records, corrupt-line count) — torn tail lines of a live run and
  garbage are skipped, counted, and warned, never raised (the shared
  tolerant reader, `obs.runlog.read_jsonl`)."""
  return runlog_lib.read_jsonl(path,
                               counter_name="graftscope/corrupt_lines")


def _split_records(records: List[dict]
                   ) -> Tuple[List[dict], Dict[str, float]]:
  """(step-stats records, merged registry-snapshot values)."""
  step_records = []
  snapshot: Dict[str, float] = {}
  for record in records:
    if all(k in record for k in _STEP_KEYS):
      step_records.append(record)
    for key, value in record.items():
      if key.startswith(("counter/", "gauge/", "hist/")):
        snapshot[key] = value  # later snapshots win (counters grow)
  return step_records, snapshot


def _breakdown_table(step_records: List[dict]) -> List[str]:
  steps = [r.get("step") for r in step_records if "step" in r]
  lines = [f"step-time breakdown ({len(step_records)} records, "
           f"steps {min(steps)}..{max(steps)})" if steps else
           "step-time breakdown (no step records)"]
  header = f"  {'metric':<14}{'mean':>10}{'p50':>10}{'p90':>10}{'p99':>10}"
  lines.append(header)
  for key in _BREAKDOWN_ROWS:
    values = [float(r[key]) for r in step_records if key in r]
    if not values:
      continue
    p50, p90, p99 = metrics_lib.percentiles(values)
    mean = sum(values) / len(values)
    lines.append(f"  {key:<14}{mean:>10.2f}{p50:>10.2f}{p90:>10.2f}"
                 f"{p99:>10.2f}")
  eps = [float(r["examples_per_sec"]) for r in step_records
         if "examples_per_sec" in r]
  if eps:
    lines.append(f"  throughput: mean {sum(eps) / len(eps):.1f} "
                 f"examples/sec (max {max(eps):.1f})")
  compiles = sum(int(r.get("compile", 0)) for r in step_records)
  lines.append(f"  compile events: {compiles}")
  return lines


def _counter_lines(snapshot: Dict[str, float]) -> List[str]:
  counters = {k[len("counter/"):]: v for k, v in snapshot.items()
              if k.startswith("counter/")}
  if not counters:
    return []
  lines = ["counter totals"]
  for name in sorted(counters):
    lines.append(f"  {name:<36}{counters[name]:>12.0f}")
  return lines


def _gauge_lines(snapshot: Dict[str, float]) -> List[str]:
  gauges = {k[len("gauge/"):]: v for k, v in snapshot.items()
            if k.startswith("gauge/")}
  if not gauges:
    return []
  lines = ["gauges (last value)"]
  for name in sorted(gauges):
    lines.append(f"  {name:<36}{gauges[name]:>14.2f}")
  return lines


def _hist_lines(snapshot: Dict[str, float]) -> List[str]:
  """hist/<name>/<stat> snapshot entries regrouped per histogram."""
  hists: Dict[str, Dict[str, float]] = {}
  for key, value in snapshot.items():
    if key.startswith("hist/"):
      name, _, stat = key[len("hist/"):].rpartition("/")
      hists.setdefault(name, {})[stat] = value
  if not hists:
    return []
  lines = ["histograms",
           f"  {'name':<28}{'count':>8}{'mean':>10}{'p50':>10}"
           f"{'p90':>10}{'p99':>10}"]
  for name in sorted(hists):
    h = hists[name]
    lines.append(
        f"  {name:<28}{h.get('count', 0):>8.0f}{h.get('mean', 0):>10.2f}"
        f"{h.get('p50', 0):>10.2f}{h.get('p90', 0):>10.2f}"
        f"{h.get('p99', 0):>10.2f}")
  return lines


def _span_lines(trace_files: List[str], top: int) -> List[str]:
  spans: Dict[str, List[float]] = {}
  loaded = []
  for path in trace_files:
    try:
      with open(path) as f:
        payload = json.load(f)
    except (OSError, ValueError) as e:
      metrics_lib.counter("graftscope/corrupt_trace_files").inc()
      print(f"graftscope: skipping corrupt trace {path} "
            f"({type(e).__name__})", file=sys.stderr)
      continue
    events = payload.get("traceEvents", payload) \
        if isinstance(payload, dict) else payload
    if not isinstance(events, list):
      continue
    loaded.append(path)
    for event in events:
      if isinstance(event, dict) and event.get("ph") == "X":
        spans.setdefault(event.get("name", "?"), []).append(
            float(event.get("dur", 0.0)) / 1e3)  # us -> ms
  if not loaded:
    return []
  lines = [f"slowest spans (by total time, {len(loaded)} trace file(s) — "
           "open in https://ui.perfetto.dev)"]
  lines.append(f"  {'span':<28}{'count':>8}{'total_ms':>12}{'max_ms':>10}")
  ranked = sorted(spans.items(), key=lambda kv: -sum(kv[1]))[:top]
  for name, durs in ranked:
    lines.append(f"  {name:<28}{len(durs):>8}{sum(durs):>12.2f}"
                 f"{max(durs):>10.2f}")
  return lines


def _compile_lines(record: dict) -> List[str]:
  """xray compile-telemetry table from one runlog record."""
  compiles = record.get("compile") or []
  if not compiles:
    return []
  lines = ["xray compile telemetry (latest run)",
           f"  {'executable':<22}{'compile_s':>10}{'eqns':>8}"
           f"{'GF':>10}{'GB':>8}{'AI':>8}{'roofline_ms':>12}"]
  for rec in compiles:
    flops = rec.get("flops")
    nbytes = rec.get("bytes_accessed")
    ai = rec.get("arithmetic_intensity")
    roofline = rec.get("roofline_ms")
    fmt = lambda v, scale=1.0: (f"{v / scale:.2f}" if v is not None
                                else "—")
    lines.append(
        f"  {str(rec.get('name', '?')):<22}"
        f"{fmt(rec.get('compile_s')):>10}"
        f"{rec.get('jaxpr_eqns', 0):>8}"
        f"{fmt(flops, 1e9):>10}{fmt(nbytes, 1e9):>8}"
        f"{fmt(ai):>8}{fmt(roofline):>12}")
  return lines


def _runlog_sections(model_dir: str) -> Tuple[List[List[str]], int]:
  """(run-history summary + xray compile table sections for the latest
  record, corrupt-line count) — runs.jsonl garbage lands in the same
  report head count / graftscope counter as every other telemetry file."""
  path = os.path.join(model_dir, runlog_lib.RUNS_FILENAME)
  records, skipped = _load_jsonl(path)
  if not records:
    return [], skipped
  latest = records[-1]
  lines = [f"run history ({len(records)} record(s) in "
           f"{runlog_lib.RUNS_FILENAME}; compare with "
           "`graftscope diff`)"]
  metrics = runlog_lib.key_metrics(latest)
  for name in sorted(metrics):
    lines.append(f"  {name:<24}{metrics[name]:>16.6g}")
  memory = latest.get("memory") or {}
  if memory.get("hbm_watermark_bytes"):
    lines.append(f"  {'hbm_watermark':<24}"
                 f"{memory['hbm_watermark_bytes'] / 2**30:>13.3f} GiB"
                 "  (per-shard estimate)")
  sections = [lines]
  compile_sec = _compile_lines(latest)
  if compile_sec:
    sections.append(compile_sec)
  return sections, skipped


def build_report(model_dir: str, top: int = 10) -> Optional[str]:
  """Renders the text report; None when no telemetry exists at all."""
  metrics_files, trace_files, profile_dirs = _discover(model_dir)
  runs_path = os.path.join(model_dir, runlog_lib.RUNS_FILENAME)
  sections: List[List[str]] = []
  all_records: List[dict] = []
  corrupt = 0
  for path in metrics_files:
    records, skipped = _load_jsonl(path)
    all_records.extend(records)
    corrupt += skipped
  step_records, snapshot = _split_records(all_records)
  if step_records:
    sections.append(_breakdown_table(step_records))
  counter_sec = _counter_lines(snapshot)
  if counter_sec:
    sections.append(counter_sec)
  gauge_sec = _gauge_lines(snapshot)
  if gauge_sec:
    sections.append(gauge_sec)
  hist_sec = _hist_lines(snapshot)
  if hist_sec:
    sections.append(hist_sec)
  span_sec = _span_lines(trace_files, top)
  if span_sec:
    sections.append(span_sec)
  runlog_sections, runlog_skipped = _runlog_sections(model_dir)
  sections.extend(runlog_sections)
  corrupt += runlog_skipped
  if profile_dirs:
    sections.append(["profiler traces (TensorBoard/Perfetto)"]
                    + [f"  {d}" for d in profile_dirs])
  if (not metrics_files and not trace_files and not profile_dirs
      and not os.path.isfile(runs_path)):
    return None
  head = [f"graftscope report: {model_dir}",
          f"  {len(metrics_files)} metrics.jsonl file(s), "
          f"{len(all_records)} records, {len(trace_files)} trace file(s)"]
  if corrupt:
    head.append(f"  {corrupt} corrupt/truncated line(s) skipped "
                "(counter graftscope/corrupt_lines)")
  if not sections:
    sections = [["(telemetry files present but no graftscope records — "
                 "was the run made with step_stats_every_n_steps=0?)"]]
  return "\n\n".join("\n".join(s) for s in [head] + sections) + "\n"


def _main_report(argv: List[str]) -> int:
  parser = argparse.ArgumentParser(
      prog=f"{_PROG} [report]",
      description="Summarize graftscope telemetry (metrics.jsonl + "
                  "trace JSON + runs.jsonl) under a model_dir into a "
                  "text report.")
  parser.add_argument("model_dir", help="train/eval output directory")
  parser.add_argument("--top", type=int, default=10,
                      help="span rows in the slowest-spans table")
  args = parser.parse_args(argv)
  if not os.path.isdir(args.model_dir):
    print(f"graftscope: no such directory: {args.model_dir}",
          file=sys.stderr)
    return 2
  report = build_report(args.model_dir, top=args.top)
  if report is None:
    print(f"graftscope: no telemetry under {args.model_dir} "
          "(no metrics.jsonl, trace JSON, runs.jsonl, or profiler dirs)",
          file=sys.stderr)
    return 1
  print(report, end="")
  return 0


def _main_history(argv: List[str]) -> int:
  parser = argparse.ArgumentParser(
      prog=f"{_PROG} history",
      description="List the run records in a model_dir's (or file's) "
                  "runs.jsonl, one line per run.")
  parser.add_argument("source", help="model_dir or runs.jsonl path")
  args = parser.parse_args(argv)
  path = args.source
  if os.path.isdir(path):
    path = os.path.join(path, runlog_lib.RUNS_FILENAME)
  if not os.path.isfile(path):
    print(f"graftscope: no run history at {args.source} "
          f"(no such file: {path})", file=sys.stderr)
    return 2
  records = runlog_lib.load_records(path)
  if not records:
    print(f"graftscope: no parseable run records in {path}",
          file=sys.stderr)
    return 1
  print("\n".join(runlog_lib.history_lines(records, path)))
  return 0


def _parse_threshold(spec: str):
  name, _, value = spec.partition("=")
  if not name or not value:
    raise argparse.ArgumentTypeError(
        f"expected metric=relative_threshold, got {spec!r}")
  try:
    return name, float(value)
  except ValueError:
    raise argparse.ArgumentTypeError(
        f"threshold for {name!r} is not a number: {value!r}")


def _main_diff(argv: List[str]) -> int:
  parser = argparse.ArgumentParser(
      prog=f"{_PROG} diff",
      description="Compare two run records' key metrics with "
                  "direction-aware regression thresholds. A run "
                  "reference is a model_dir or runs.jsonl path, "
                  "optionally suffixed #run_id or #index (negative "
                  "from the end); bare paths pick the latest record. "
                  "With --trend, ONE source (model_dir or runs.jsonl) "
                  "is trended instead: median of the last K records "
                  "vs median of the prior K, per key metric. "
                  "Exit 3 when a delta/trend crosses its threshold.")
  parser.add_argument("run_a", help="baseline run reference "
                                    "(--trend: the runs.jsonl source)")
  parser.add_argument("run_b", nargs="?", default=None,
                      help="candidate run reference (omitted with "
                           "--trend)")
  parser.add_argument("--trend", action="store_true",
                      help="evaluate drift over the source's run "
                           "history instead of diffing two records")
  parser.add_argument("-k", "--trend-k", type=int, default=3,
                      help="--trend window: median of the last K vs "
                           "the prior K records (default 3)")
  parser.add_argument("--threshold", action="append", default=[],
                      type=_parse_threshold, metavar="METRIC=REL",
                      help="override a metric's relative regression "
                           "threshold (e.g. examples_per_sec=0.05); "
                           "repeatable; direction stays the metric's "
                           "default")
  parser.add_argument("--default-threshold", type=float, default=0.10,
                      help="|relative-change| threshold for metrics "
                           "without a configured direction")
  args = parser.parse_args(argv)
  overrides = {}
  for name, value in args.threshold:
    direction = runlog_lib.DEFAULT_THRESHOLDS.get(name, ("abs", 0.0))[0]
    overrides[name] = (direction, value)
  if args.trend:
    if args.run_b is not None:
      print("graftscope diff --trend takes ONE source (a model_dir or "
            "runs.jsonl), not two run references", file=sys.stderr)
      return 2
    path = args.run_a
    if os.path.isdir(path):
      path = os.path.join(path, runlog_lib.RUNS_FILENAME)
    if not os.path.isfile(path):
      print(f"graftscope: no run history at {args.run_a} "
            f"(no such file: {path})", file=sys.stderr)
      return 2
    records = runlog_lib.load_records(path)
    if not records:
      print(f"graftscope: no parseable run records in {path}",
            file=sys.stderr)
      return 2
    trends = runlog_lib.trend_records(
        records, k=args.trend_k, thresholds=overrides,
        default_threshold=args.default_threshold)
    print(runlog_lib.format_trend(path, trends, k=args.trend_k), end="")
    return 3 if any(t["regressed"] for t in trends) else 0
  if args.run_b is None:
    print("graftscope diff needs two run references (or --trend with "
          "one source)", file=sys.stderr)
    return 2
  try:
    record_a, _ = runlog_lib.resolve_run(args.run_a)
    record_b, _ = runlog_lib.resolve_run(args.run_b)
  except runlog_lib.RunResolveError as e:
    print(f"graftscope: {e}", file=sys.stderr)
    return 2
  deltas = runlog_lib.diff_records(
      record_a, record_b, thresholds=overrides,
      default_threshold=args.default_threshold)
  print(runlog_lib.format_diff(record_a, record_b, deltas), end="")
  return 3 if any(d["regressed"] for d in deltas) else 0


def _stamp(unix_time) -> str:
  try:
    return time.strftime("%Y-%m-%d %H:%M:%S",
                         time.localtime(float(unix_time)))
  except (TypeError, ValueError):
    return "?"


def _fmt_cell(value, width: int = 12) -> str:
  """Step-record cell: bundle values are floats OR repr strings for
  non-finites ('nan' is exactly the datum a postmortem is for)."""
  if isinstance(value, (int, float)):
    return f"{value:>{width}.2f}"
  return f"{str(value):>{width}}"


_STEP_COLUMNS = ("step_ms", "data_wait_ms", "device_ms",
                 "examples_per_sec", "nonfinite_params")


def _postmortem_steps_lines(steps: List[dict], last_n: int) -> List[str]:
  if not steps:
    return ["recorded steps: none (did the run crash before the first "
            "stepstats window?)"]
  shown = steps[-last_n:]
  lines = [f"last {len(shown)} recorded step window(s) "
           f"(of {len(steps)} in the ring buffer)"]
  columns = [c for c in _STEP_COLUMNS
             if any(c in record for record in shown)]
  lines.append("  " + f"{'step':>8}"
               + "".join(f"{c:>18}" for c in columns))
  for record in shown:
    lines.append("  " + f"{str(record.get('step', '?')):>8}"
                 + "".join(_fmt_cell(record.get(c, "—"), 18)
                           for c in columns))
  return lines


def _fmt_num(value) -> str:
  """Tolerant numeric format: a wrong-typed field in an otherwise
  parseable incident renders verbatim instead of raising (the CLI's
  never-raise contract covers wrong TYPES, not just invalid JSON)."""
  try:
    return f"{float(value):.6g}"
  except (TypeError, ValueError):
    return str(value)


def _postmortem_incident_lines(incidents: List[dict]) -> List[str]:
  if not incidents:
    return ["incident timeline: no incidents recorded"]
  lines = [f"incident timeline ({len(incidents)} record(s))",
           f"  {'time':<20}{'step':>8}  {'severity':<7} kind"]
  for record in incidents:
    detail = record.get("detail") if isinstance(record.get("detail"),
                                                dict) else {}
    extras = []
    if record.get("value") is not None:
      extras.append(f"value={_fmt_num(record['value'])}")
    if detail.get("value_repr"):
      extras.append(f"value={detail['value_repr']}")
    if record.get("threshold") is not None:
      extras.append(f"threshold={_fmt_num(record['threshold'])}")
    if detail.get("metric"):
      extras.append(f"metric={detail['metric']}")
    lines.append(f"  {_stamp(record.get('unix_time')):<20}"
                 f"{str(record.get('step', '—')):>8}  "
                 f"{str(record.get('severity', '?')):<7} "
                 f"{record.get('kind', '?')}"
                 + ("  (" + ", ".join(extras) + ")" if extras else ""))
  return lines


def _postmortem_heartbeat_lines(heartbeat: Optional[dict]) -> List[str]:
  if not heartbeat:
    return ["tunnel heartbeat: no monitor data in this bundle"]
  lines = [f"tunnel heartbeat: state={heartbeat.get('state', '?')}"
           + (f" cause={heartbeat['cause']}" if heartbeat.get("cause")
              else "")
           + f" ({heartbeat.get('probes', 0)} probe(s))"]
  for t in heartbeat.get("transitions") or []:
    lines.append(f"  {_stamp(t.get('unix_time')):<20}-> "
                 f"{t.get('state', '?'):<9}"
                 f" source={t.get('source', '?')}"
                 + (f" cause={t['cause']}" if t.get("cause") else ""))
  if not (heartbeat.get("transitions") or []):
    lines.append("  (no transitions recorded)")
  return lines


def render_postmortem(bundle: Dict[str, Any], source: str,
                      last_n: int = 20,
                      extra_incidents: Optional[List[dict]] = None) -> str:
  """Text report for one `graftscope-postmortem-v1` bundle."""
  head = [f"graftscope postmortem: {source}",
          f"  reason: {bundle.get('reason', '?')}   "
          f"at {_stamp(bundle.get('unix_time'))}   "
          f"pid {bundle.get('pid', '?')}"]
  watchdog = bundle.get("watchdog") or {}
  if watchdog.get("hang_timeout_secs"):
    head.append(f"  watchdog: timeout {watchdog['hang_timeout_secs']:.1f}s,"
                f" stalled {watchdog.get('stalled_secs', 0.0):.1f}s at dump")
  exception = bundle.get("exception")
  if exception:
    head.append(f"  exception: {exception.get('type', '?')}: "
                f"{exception.get('message', '')}"[:200])
  incidents = list(bundle.get("incidents") or [])
  seen = {(r.get("unix_time"), r.get("kind"), r.get("step"))
          for r in incidents}
  for record in extra_incidents or []:
    key = (record.get("unix_time"), record.get("kind"), record.get("step"))
    if key not in seen:
      incidents.append(record)
      seen.add(key)
  def _incident_order(record):
    try:
      when = float(record.get("unix_time") or 0.0)
    except (TypeError, ValueError):
      when = 0.0
    try:
      step = int(record.get("step") or 0)
    except (TypeError, ValueError):
      step = 0
    return (when, step)

  incidents.sort(key=_incident_order)
  sections = [head,
              _postmortem_steps_lines(list(bundle.get("steps") or []),
                                      last_n),
              _postmortem_incident_lines(incidents),
              _postmortem_heartbeat_lines(bundle.get("heartbeat"))]
  metrics = bundle.get("metrics") or {}
  highlights = {k: v for k, v in sorted(metrics.items())
                if "/sentinel/" in k or "/flightrec/" in k
                or k.startswith(("counter/sentinel", "counter/flightrec"))}
  if highlights:
    sections.append(["sentinel/flightrec counters"]
                    + [f"  {k:<44}{_fmt_cell(v)}"
                       for k, v in highlights.items()])
  if exception and exception.get("traceback"):
    tail = exception["traceback"].strip().splitlines()[-12:]
    sections.append(["traceback (tail)"] + [f"  {line}" for line in tail])
  return "\n\n".join("\n".join(s) for s in sections) + "\n"


def _load_bundle(path: str) -> Optional[Dict[str, Any]]:
  """Tolerant bundle read: a torn/corrupt bundle is a warning + None,
  never a raise (the writer may have died mid-crash)."""
  try:
    with open(path, errors="replace") as f:
      bundle = json.load(f)
    if not isinstance(bundle, dict):
      raise ValueError("bundle is not an object")
    return bundle
  except (OSError, ValueError) as e:
    metrics_lib.counter("graftscope/corrupt_bundles").inc()
    print(f"graftscope: skipping corrupt bundle {path} "
          f"({type(e).__name__}: {e})", file=sys.stderr)
    return None


def _main_postmortem(argv: List[str]) -> int:
  parser = argparse.ArgumentParser(
      prog=f"{_PROG} postmortem",
      description="Render a flight-recorder postmortem bundle: last "
                  "steps, incident timeline, tunnel-heartbeat "
                  "transitions, crash traceback.")
  parser.add_argument("source",
                      help="bundle dir / flightrec dir / model_dir / "
                           "postmortem.json path")
  parser.add_argument("--index", type=int, default=-1,
                      help="bundle to render when several exist "
                           "(chronological; negative from the end; "
                           "default: latest)")
  parser.add_argument("--steps", type=int, default=20,
                      help="step-window rows to show")
  parser.add_argument("--list", action="store_true", dest="list_only",
                      help="list discovered bundles and exit")
  args = parser.parse_args(argv)
  if not os.path.exists(args.source):
    print(f"graftscope: no such path: {args.source}", file=sys.stderr)
    return 2
  bundles = flightrec_lib.find_bundles(args.source)
  # The incident history file complements whatever the bundle rang.
  incidents_path = (os.path.join(args.source,
                                 runlog_lib.INCIDENTS_FILENAME)
                    if os.path.isdir(args.source) else "")
  extra_incidents, _ = (runlog_lib.read_jsonl(
      incidents_path, counter_name="graftscope/corrupt_lines")
      if incidents_path and os.path.isfile(incidents_path) else ([], 0))
  if args.list_only:
    if not bundles:
      print(f"graftscope: no postmortem bundles under {args.source}",
            file=sys.stderr)
      return 1
    for i, path in enumerate(bundles):
      print(f"[{i}] {os.path.dirname(path)}")
    return 0
  if not bundles:
    if extra_incidents:
      # No crash bundle, but the run DID log incidents: the timeline is
      # still the answer to "what went wrong".
      print(f"graftscope postmortem: {args.source} (no flight-recorder "
            "bundle; incident history only)\n")
      print("\n".join(_postmortem_incident_lines(extra_incidents)))
      return 0
    print(f"graftscope: no postmortem bundles (or incidents.jsonl) "
          f"under {args.source}", file=sys.stderr)
    return 1
  try:
    path = bundles[args.index]
  except IndexError:
    print(f"graftscope: bundle index {args.index} out of range "
          f"({len(bundles)} bundle(s))", file=sys.stderr)
    return 2
  bundle = _load_bundle(path)
  if bundle is None:
    return 2
  print(render_postmortem(bundle, path, last_n=args.steps,
                          extra_incidents=extra_incidents), end="")
  return 0


def _main_audit(argv: List[str]) -> int:
  parser = argparse.ArgumentParser(
      prog=f"{_PROG} audit",
      description="graftaudit: trace every compiled step a research "
                  "config deploys (train step, serving bucket rungs, "
                  "session decode ticks and the slot reset) on fake "
                  "tensors in a worker and audit the FX graphs — baked "
                  "constants, undonated state, host ops inside "
                  "while_loop bodies (analysis.graph_audit; rules "
                  "catalogued by `graftlint --list-rules`, suppressible "
                  "with a trailing `# graftlint: disable=<rule>` in the "
                  "config). Exit codes: 0 clean, 1 findings or target "
                  "errors, 2 usage.")
  parser.add_argument("config_files", nargs="+",
                      help="research config (.gin) files, e.g. "
                           "tensor2robot_tpu_torch/configs/"
                           "train_longcontext_flash.gin")
  parser.add_argument("--binding", action="append", default=[],
                      help="extra binding strings, applied last "
                           "(repeatable)")
  parser.add_argument("--model", default=None,
                      help="model source for serving-only configs: a "
                           "registered configurable name, or 'flagship' "
                           "(the QT-Opt smoke critic)")
  parser.add_argument("--export-dir", default=None,
                      help="audit the model served from this export-"
                           "bundle root instead of a configurable ctor")
  parser.add_argument("--model-dir", default=None,
                      help="deployment model_dir (predictors restore "
                           "its checkpoints when present; the audit is "
                           "value-independent either way)")
  parser.add_argument("--device", default="cuda",
                      help="device the worker builds the targets on "
                           "(default cuda; the tracing itself runs on "
                           "fake tensors)")
  parser.add_argument("--device-count", type=int, default=None,
                      help="the number of cards the worker sees "
                           "(CUDA_VISIBLE_DEVICES)")
  parser.add_argument("--json", action="store_true", dest="as_json",
                      help="emit findings as JSON lines (the lint "
                           "--json schema)")
  parser.add_argument("--timeout", type=float, default=600.0,
                      help="audit worker wall-clock budget in seconds")
  args = parser.parse_args(argv)
  missing = [p for p in args.config_files if not os.path.isfile(p)]
  if missing:
    print(f"graftscope audit: no such config: {', '.join(missing)}",
          file=sys.stderr)
    return 2
  from tensor2robot_tpu_torch.analysis import engine as lint_engine
  from tensor2robot_tpu_torch.analysis import graph_audit
  from tensor2robot_tpu_torch.obs import forge as forge_lib

  try:
    plan = forge_lib.plan_from_config(args.config_files, args.binding,
                                      model=args.model,
                                      export_dir=args.export_dir,
                                      model_dir=args.model_dir)
  except Exception as e:  # noqa: BLE001 - a config error is a usage error
    print(f"graftscope audit: cannot enumerate {args.config_files}: "
          f"{type(e).__name__}: {e}", file=sys.stderr)
    return 2
  auditable = [t for t in plan["targets"]
               if t["family"] in ("serve", "session", "train")]
  if auditable and plan.get("model") is None:
    print("graftscope audit: the plan has traceable serving/train "
          "targets but no model source — pass --model/--export-dir or "
          "bind graftforge.model in the config", file=sys.stderr)
    return 2
  results = graph_audit.run_targets(plan, auditable, device=args.device,
                                    device_count=args.device_count,
                                    timeout_s=args.timeout)
  findings = graph_audit.report_findings(plan, results)
  print(graph_audit.format_report(plan, results, findings))
  for finding in findings:
    if args.as_json:
      print(json.dumps({
          "path": finding.path, "line": finding.line,
          "rule": finding.rule,
          "severity": lint_engine.severity_of(finding.rule),
          "message": finding.message, "suppressed": False}))
    else:
      print(finding)
  errors = [r for r in results if r["status"] == "error"]
  for entry in errors:
    print(f"  ERROR   {entry.get('name')}: {entry.get('error')}",
          file=sys.stderr)
  return 1 if (findings or errors) else 0


def _main_cache(argv: List[str]) -> int:
  parser = argparse.ArgumentParser(
      prog=f"{_PROG} cache",
      description="List, verify, or evict graftcache entries "
                  "(obs.excache). Sidecars only: torch-free, safe beside "
                  "a job that owns the card.")
  parser.add_argument("cache_dir",
                      help="cache directory (e.g. .graftcache or "
                           "<model_dir>/excache)")
  parser.add_argument("--verify", action="store_true",
                      help="checksum every entry's blob against its "
                           "sidecar; exit 1 if any entry is bad")
  parser.add_argument("--evict", action="store_true",
                      help="remove entries (ALL, including the "
                           "inductor/ tier, without --key/--older-than/"
                           "--name-prefix)")
  parser.add_argument("--key", help="restrict --evict to one entry key")
  parser.add_argument("--older-than", type=float, metavar="SECS",
                      help="restrict --evict to entries created more "
                           "than SECS seconds ago")
  parser.add_argument("--name-prefix", metavar="PREFIX",
                      help="restrict --evict to entries whose recorded "
                           "name starts with PREFIX (e.g. serve/): "
                           "clears one namespace of a shared cache dir")
  args = parser.parse_args(argv)
  if not os.path.isdir(args.cache_dir):
    print(f"graftscope: no cache directory at {args.cache_dir}",
          file=sys.stderr)
    return 2
  from tensor2robot_tpu_torch.obs import excache as excache_lib

  cache = excache_lib.ExecutableCache(args.cache_dir)
  if args.evict:
    removed = cache.evict(key=args.key, older_than_secs=args.older_than,
                          name_prefix=args.name_prefix)
    print(f"graftcache: evicted {removed} entr"
          f"{'y' if removed == 1 else 'ies'} from {args.cache_dir}")
    return 0
  entries = cache.entries()
  bad: List[str] = []
  if args.verify:
    _, bad = cache.verify()
  print(f"graftcache: {args.cache_dir} ({len(entries)} entr"
        f"{'y' if len(entries) == 1 else 'ies'})")
  header = (f"  {'name':<28}{'bytes':>12}{'age':>10}"
            f"{'  key':<40}{'  status' if args.verify else ''}")
  print(header)
  now = time.time()
  total_bytes = 0
  for entry in entries:
    size = int(entry.get("blob_bytes") or 0)
    total_bytes += size
    age = now - float(entry.get("created_unix") or now)
    status = ""
    if args.verify:
      status = "  CORRUPT" if entry["key"] in bad else "  ok"
    if entry.get("orphan"):
      status = "  ORPHAN-BLOB" if args.verify else ""
    name = str(entry.get("name") or "?")[:27]
    print(f"  {name:<28}{size:>12}{age:>9.0f}s  {entry['key']:<38}"
          f"{status}")
  print(f"  total {total_bytes} bytes")
  if args.verify and bad:
    print(f"graftcache: {len(bad)} bad entr"
          f"{'y' if len(bad) == 1 else 'ies'} "
          "(evict with --evict --key <key>, or rely on the automatic "
          "quarantine-on-load)", file=sys.stderr)
    return 1
  return 0


def _main_forge(argv: List[str]) -> int:
  parser = argparse.ArgumentParser(
      prog=f"{_PROG} forge",
      description="graftforge: enumerate the compiled steps a config "
                  "deploys and warm the graftcache for all of them "
                  "before any process starts (obs.forge). --plan prints "
                  "the enumeration without building anything; the "
                  "default runs the compile farm; --verify checks an "
                  "existing cache against the plan without compiling. "
                  "Exit codes match `graftscope cache`: 0 ok, 1 bad/"
                  "missing entries or farm errors, 2 usage.")
  parser.add_argument("config_files", nargs="+",
                      help="config (.gin) files, e.g. "
                           "tensor2robot_tpu_torch/configs/serve_fleet.gin")
  parser.add_argument("--binding", action="append", default=[],
                      help="extra binding strings, applied last "
                           "(repeatable)")
  parser.add_argument("--cache-dir", default=os.environ.get(
      "GRAFTCACHE_DIR", ".graftcache"),
                      help="graftcache directory to populate/verify "
                           "(default $GRAFTCACHE_DIR or .graftcache)")
  parser.add_argument("--jobs", type=int, default=2,
                      help="compile-farm worker processes at once (one "
                           "fresh process per target)")
  parser.add_argument("--plan", action="store_true",
                      help="dry-run: print the enumeration and exit "
                           "(torch-free)")
  parser.add_argument("--verify", action="store_true",
                      help="check the cache against the plan without "
                           "compiling (exit 1 on missing/corrupt)")
  parser.add_argument("--model", default=None,
                      help="model source for serving-only configs: a "
                           "registered configurable name, or 'flagship' "
                           "(the QT-Opt critic)")
  parser.add_argument("--export-dir", default=None,
                      help="serve the model from this export-bundle "
                           "root instead of a configurable ctor")
  parser.add_argument("--model-dir", default=None,
                      help="deployment model_dir: predictors restore "
                           "its checkpoints when present (else random-"
                           "init: keys are value-independent), and "
                           "'--cache-dir auto' resolves to its excache/")
  parser.add_argument("--device", default="cuda",
                      help="the workers' device (default cuda; cpu for a "
                           "CPU deployment): a cache-key component")
  parser.add_argument("--runs", default=None,
                      help="runs.jsonl to append the forge manifest to "
                           "(default $GRAFTSCOPE_RUNS or ./runs.jsonl; "
                           "'' disables)")
  args = parser.parse_args(argv)
  missing = [p for p in args.config_files if not os.path.isfile(p)]
  if missing:
    print(f"graftscope forge: no such config: {', '.join(missing)}",
          file=sys.stderr)
    return 2
  from tensor2robot_tpu_torch.obs import forge as forge_lib

  cache_dir = args.cache_dir
  if cache_dir == "auto":
    if not args.model_dir:
      print("graftscope forge: --cache-dir auto needs --model-dir",
            file=sys.stderr)
      return 2
    cache_dir = os.path.join(args.model_dir, "excache")
  try:
    plan = forge_lib.plan_from_config(
        args.config_files, args.binding, model=args.model,
        export_dir=args.export_dir, model_dir=args.model_dir)
  except Exception as e:  # noqa: BLE001 - a config error is a usage error
    print(f"graftscope forge: cannot enumerate {args.config_files}: "
          f"{type(e).__name__}: {e}", file=sys.stderr)
    return 2
  print(forge_lib.format_plan(plan))
  if args.plan:
    return 0
  forgeable = [t for t in plan["targets"] if t["forgeable"]]
  if forgeable and plan.get("model") is None:
    print("graftscope forge: the plan has forgeable serving/train "
          "targets but no model source — pass --model/--export-dir or "
          "bind graftforge.model in the config", file=sys.stderr)
    return 2
  if args.verify:
    report = forge_lib.verify_plan(plan, cache_dir, device=args.device)
    print(f"graftforge verify: {cache_dir}: "
          f"{len(report['present'])} present, "
          f"{len(report['missing'])} missing, "
          f"{len(report['corrupt'])} corrupt, "
          f"{len(report['errors'])} error(s)")
    for entry in report["present"]:
      print(f"  HIT     {entry.get('name')}  {entry.get('key')}")
    for entry in report["missing"]:
      print(f"  MISSING {entry.get('name')}  {entry.get('key')}")
    for entry in report["corrupt"]:
      print(f"  CORRUPT {entry.get('name')}  {entry.get('key')}")
    for entry in report["errors"]:
      print(f"  ERROR   {entry.get('name')}: {entry.get('error')}",
            file=sys.stderr)
    return 1 if (report["missing"] or report["corrupt"]
                 or report["errors"]) else 0
  runs_path = args.runs
  if runs_path is None:
    runs_path = os.environ.get("GRAFTSCOPE_RUNS", "runs.jsonl")
  manifest = forge_lib.run_forge(plan, cache_dir, jobs=args.jobs,
                                 device=args.device,
                                 runs_path=runs_path or None)
  counts = manifest["counts"]
  print(f"graftforge: {counts['forged']} compiled + {counts['cached']} "
        f"already-cached executable(s) into {cache_dir} in "
        f"{manifest['wall_s']:.1f}s ({manifest['jobs']} job(s); "
        f"{counts['unforgeable']} unforgeable, {counts['fallback']} "
        f"fallback(s), {counts['errors']} error(s))")
  for entry in manifest["executables"]:
    print(f"  {entry.get('action', '?'):<9}{entry.get('name'):<28}"
          f"compile_s={entry.get('compile_s')}  {entry.get('key')}")
  for entry in manifest["errors"]:
    print(f"  ERROR   {entry.get('name')}: {entry.get('error')}",
          file=sys.stderr)
  if counts["fallback"]:
    print(f"graftscope forge: {counts['fallback']} step(s) failed to "
          "compile and ran eagerly: nothing was stored for them",
          file=sys.stderr)
  return 1 if (manifest["errors"] or counts["fallback"]) else 0


def _main_timeline(argv: List[str]) -> int:
  parser = argparse.ArgumentParser(
      prog=f"{_PROG} timeline",
      description="graftrace merge (obs.aggregate): collect every "
                  "trace-<pid>-<gen>.json shard under a directory into "
                  "ONE clock-aligned Perfetto/chrome://tracing JSON "
                  "with synthesized flow arrows along the causal edges "
                  "(request -> batch dispatch; session tick -> session "
                  "batch). "
                  "Tolerant: corrupt shards are counted and skipped. "
                  "Exit codes: 0 merged events, 1 no usable shards, "
                  "2 usage.")
  parser.add_argument("root",
                      help="directory to search recursively for "
                           "graftrace shards (a model_dir or a "
                           "GRAFTRACE_DIR)")
  parser.add_argument("--out", default=None,
                      help="output path (default: "
                           "<root>/timeline.json)")
  args = parser.parse_args(argv)
  if not os.path.isdir(args.root):
    print(f"graftscope timeline: no such directory: {args.root}",
          file=sys.stderr)
    return 2
  from tensor2robot_tpu_torch.obs import aggregate as aggregate_lib

  out = args.out or os.path.join(args.root, "timeline.json")
  stats = aggregate_lib.write_timeline(args.root, out)
  print(f"graftscope timeline: {stats['shards']} shard(s) over "
        f"{stats['processes']} process(es) -> {stats['events']} events, "
        f"{stats['flow_links']} flow link(s)"
        + (f", {stats['skipped']} unreadable shard(s) skipped"
           if stats["skipped"] else ""))
  if stats["skew_corrected_pids"]:
    shifts = ", ".join(f"pid {p}: +{ms}ms" for p, ms
                       in sorted(stats["skew_corrected_pids"].items()))
    print(f"  clock-skew repair (happened-before): {shifts}")
  print(f"  wrote {out} (load in https://ui.perfetto.dev or "
        "chrome://tracing)")
  return 0 if stats["events"] else 1


# -- graftwatch: live dashboard over graftrace metrics shards --

_BUSY_PREFIX = "counter/serve/fleet/busy_ms/"


def build_watch_view(root: str, stale_s: float = 30.0) -> Dict[str, Any]:
  """One dashboard frame from the shard directory alone: workers (with
  shard age from the paired epoch stamp), the fleet-wide merged
  snapshot, point-in-time SLO judgments, and the usage-ledger rollup.
  Stale workers (shard older than `stale_s` — a dead worker's FINAL
  flush keeps its last counters forever) are listed but excluded from
  the merge, so the SLO/utilization read reflects the live fleet."""
  from tensor2robot_tpu_torch.obs import aggregate as aggregate_lib
  from tensor2robot_tpu_torch.obs import slo as slo_lib

  found = aggregate_lib.latest_metrics_shards(root)
  now_ns = time.time_ns()
  workers: List[Dict[str, Any]] = []
  live: List[Dict[str, Any]] = []
  for shard in found["shards"]:
    clock = shard.get("clock")
    clock = clock if isinstance(clock, dict) else {}
    epoch_ns = clock.get("epoch_ns")
    age_s: Optional[float] = None
    if isinstance(epoch_ns, (int, float)) and epoch_ns > 0:
      age_s = max((now_ns - int(epoch_ns)) / 1e9, 0.0)
    # No stamp (a shard written without the clock pair) -> age unknown;
    # treat as live so old telemetry still renders rather than
    # vanishing.
    stale = age_s is not None and age_s > stale_s
    workers.append({"pid": shard.get("pid"), "role": shard.get("role"),
                    "gen": shard.get("gen"),
                    "age_s": None if age_s is None else round(age_s, 1),
                    "stale": stale})
    if not stale:
      live.append(shard)
  merged = aggregate_lib.sum_snapshots(live)
  slos = slo_lib.evaluate_snapshot(slo_lib.default_serving_slos(),
                                   merged)
  groups = {key[len(_BUSY_PREFIX):]: round(value / 1e3, 3)
            for key, value in sorted(merged.items())
            if key.startswith(_BUSY_PREFIX)}
  fleet = {
      "requests": merged.get("counter/serve/fleet/requests", 0.0),
      "shed": merged.get("counter/serve/fleet/shed", 0.0),
      "slo_breaches": merged.get("counter/serve/slo_breaches", 0.0),
      "latency_p50_ms": merged.get("hist/serve/request_ms/p50"),
      "latency_p99_ms": merged.get("hist/serve/request_ms/p99"),
  }
  utilization = {
      "utilization": merged.get("gauge/serve/fleet/utilization"),
      "device_seconds_busy":
          merged.get("gauge/serve/fleet/device_seconds_busy"),
      "device_seconds_idle":
          merged.get("gauge/serve/fleet/device_seconds_idle"),
      "cost_per_request_usd":
          merged.get("gauge/serve/fleet/cost_per_request_usd"),
      "busy_s_by_group": groups,
  }
  return {"root": root, "workers": workers, "skipped": found["skipped"],
          "live_workers": len(live), "fleet": fleet, "slo": slos,
          "utilization": utilization,
          "healthy": all(s["ok"] for s in slos.values())}


def _fmt_opt(value, fmt: str = "{:.2f}") -> str:
  return "—" if value is None else fmt.format(value)


def format_watch_view(view: Dict[str, Any],
                      qps: Optional[float] = None) -> str:
  lines = [f"graftwatch: {view['root']}   "
           f"{len(view['workers'])} worker(s), "
           f"{view['live_workers']} live"
           + (f", {view['skipped']} unreadable shard(s) skipped"
              if view["skipped"] else "")]
  lines.append(f"  {'role':<12}{'pid':>8}{'gen':>6}{'shard age':>12}"
               "  status")
  for worker in view["workers"]:
    age = ("?" if worker["age_s"] is None
           else f"{worker['age_s']:.1f}s")
    lines.append(f"  {str(worker['role'] or '?'):<12}"
                 f"{str(worker['pid'] or '?'):>8}"
                 f"{str(worker['gen'] if worker['gen'] is not None else '?'):>6}"
                 f"{age:>12}"
                 f"  {'STALE (excluded)' if worker['stale'] else 'ok'}")
  fleet = view["fleet"]
  lines.append("")
  lines.append(
      f"fleet: requests {fleet['requests']:.0f}   "
      f"shed {fleet['shed']:.0f}   "
      f"slo breaches {fleet['slo_breaches']:.0f}"
      + (f"   qps {qps:.1f}" if qps is not None else ""))
  lines.append(
      f"  latency p50 {_fmt_opt(fleet['latency_p50_ms'])} ms   "
      f"p99 {_fmt_opt(fleet['latency_p99_ms'])} ms")
  util = view["utilization"]
  lines.append(
      f"  utilization {_fmt_opt(util['utilization'], '{:.1%}')}   "
      f"device-s busy {_fmt_opt(util['device_seconds_busy'])} / idle "
      f"{_fmt_opt(util['device_seconds_idle'])}   cost/request "
      f"{_fmt_opt(util['cost_per_request_usd'], '${:.6f}')}")
  for group, busy_s in util["busy_s_by_group"].items():
    lines.append(f"    {group:<12} busy {busy_s:.3f}s")
  lines.append("")
  lines.append(f"slo ({'HEALTHY' if view['healthy'] else 'BURNING'})")
  for name, state in view["slo"].items():
    if state["kind"] == "ratio":
      lines.append(
          f"  {name:<20}{'ok' if state['ok'] else 'OVER BUDGET':<12}"
          f"bad {state['bad']:.0f}/{state['total']:.0f}"
          f" = {state['ratio']:.4f} vs budget {state['budget']:.4f}"
          f"  (consumed {state['budget_consumed']:.2f}x)")
    else:
      lines.append(
          f"  {name:<20}{'ok' if state['ok'] else 'BREACHED':<12}"
          f"value {_fmt_opt(state['value'], '{:.4g}')} vs ceiling "
          f"{state['ceiling']:.4g}")
  return "\n".join(lines) + "\n"


def _main_watch(argv: List[str]) -> int:
  parser = argparse.ArgumentParser(
      prog=f"{_PROG} watch",
      description="graftwatch: live fleet dashboard over the graftrace "
                  "metrics-<pid>-<gen>.json shard directory — worker "
                  "health with shard-age staleness, fleet counters + "
                  "QPS, latency percentiles, per-replica device time, "
                  "and point-in-time SLO judgments. Renders from "
                  "shards alone (backend-free). Exit 0 = every SLO "
                  "within budget, 1 = an SLO over budget/breached, "
                  "2 = unreadable directory or no usable shards.")
  parser.add_argument("root",
                      help="directory to search recursively for "
                           "graftrace metrics shards (a model_dir or "
                           "GRAFTRACE_DIR)")
  parser.add_argument("--snapshot", action="store_true",
                      help="render one frame and exit (CI mode)")
  parser.add_argument("--json", action="store_true", dest="as_json",
                      help="emit the frame as JSON instead of the "
                           "text dashboard")
  parser.add_argument("--stale-s", type=float, default=30.0,
                      help="shard age beyond which a worker is "
                           "reported stale and excluded from the "
                           "merge (default 30)")
  parser.add_argument("--interval", type=float, default=2.0,
                      help="refresh period in seconds (tail mode)")
  parser.add_argument("--frames", type=int, default=0,
                      help="stop tail mode after N frames (0 = until "
                           "interrupted; snapshot mode ignores this)")
  args = parser.parse_args(argv)
  if not os.path.isdir(args.root):
    print(f"graftscope watch: no such directory: {args.root}",
          file=sys.stderr)
    return 2

  def frame() -> Tuple[Optional[Dict[str, Any]], int]:
    view = build_watch_view(args.root, stale_s=args.stale_s)
    if not view["workers"]:
      return None, 2
    return view, (0 if view["healthy"] else 1)

  if args.snapshot:
    view, code = frame()
    if view is None:
      print(f"graftscope watch: no graftrace metrics shards under "
            f"{args.root}"
            + (" (unreadable shards were skipped)" if
               build_watch_view(args.root)["skipped"] else ""),
            file=sys.stderr)
      return 2
    if args.as_json:
      print(json.dumps(view, sort_keys=True))
    else:
      print(format_watch_view(view), end="")
    return code

  last_requests: Optional[float] = None
  last_t: Optional[float] = None
  code = 2
  frames = 0
  try:
    while True:
      view, code = frame()
      now = time.monotonic()
      qps = None
      if view is not None:
        requests = view["fleet"]["requests"]
        if last_requests is not None and now > last_t:
          qps = max(requests - last_requests, 0.0) / (now - last_t)
        last_requests, last_t = requests, now
      # ANSI clear-screen + home keeps the dashboard in place; piped
      # output just sees frame separators.
      print("\x1b[2J\x1b[H" if sys.stdout.isatty() else "\n---\n",
            end="")
      if view is None:
        print(f"graftscope watch: waiting for shards under {args.root} "
              "…")
      elif args.as_json:
        print(json.dumps(view, sort_keys=True))
      else:
        print(format_watch_view(view), end="")
      frames += 1
      if args.frames and frames >= args.frames:
        return code
      time.sleep(max(args.interval, 0.05))
  except KeyboardInterrupt:
    return code


_SUBCOMMANDS = {"report": _main_report, "history": _main_history,
                "diff": _main_diff, "postmortem": _main_postmortem,
                "timeline": _main_timeline, "watch": _main_watch,
                "cache": _main_cache, "forge": _main_forge,
                "audit": _main_audit}


def main(argv: Optional[List[str]] = None) -> int:
  argv = list(sys.argv[1:] if argv is None else argv)
  # `graftscope <model_dir>` (no subcommand) is a report. Subcommand names
  # win over a same-named relative model_dir — report a directory
  # literally called `diff` via `graftscope report diff` or
  # `graftscope ./diff`.
  if argv and argv[0] in _SUBCOMMANDS:
    return _SUBCOMMANDS[argv[0]](argv[1:])
  return _main_report(argv)


if __name__ == "__main__":
  sys.exit(main())
