"""graftlint CLI: run every static analyzer over configs and sources.

The port of the JAX package's `analysis.lint`. Usage (from the repo
root):

  python -m tensor2robot_tpu_torch.analysis.lint tensor2robot_tpu_torch
  python -m tensor2robot_tpu_torch.analysis.lint --json some/file.py
  python -m tensor2robot_tpu_torch.analysis.lint --list-rules
  python -m tensor2robot_tpu_torch.analysis.lint --cache-file .lintcache \
      --changed-only tensor2robot_tpu_torch

Thin shell over `analysis/engine.py`: the rule registry supplies the
checkers, the engine parses each file ONCE and runs every registered
rule over the shared tree, and this module owns argv/exit-code/output
concerns only. Mesh axis names are collected from ALL discovered
configs (and the package's own) before any Python file is checked, so
spec annotations are validated against the full declared vocabulary.
Exits non-zero iff findings remain after `# graftlint: disable=`
suppressions.

Output contracts (the JAX CLI's):

* plain text — byte-stable `path:line: [rule] message` lines;
* `--json` — one JSON object per line with `severity` (from the rule
  registry) and suppression provenance: suppressed findings are
  emitted too, with `"suppressed": true` and `"suppressed_by": <line
  of the disable comment>` (exit code counts only unsuppressed ones);
* `--list-rules` — the catalog, generated from the registry (README.md
  renders the same registry; a test pins them);
* `--stats` — `lint/files`, `lint/parse_ms`, `lint/rules_ms` on
  stderr; `--runs PATH` appends the same block to a runs.jsonl so lint
  latency is diff-gated like every other bench family;
* `--baseline` / `--write-baseline` — accept today's findings, gate
  only new ones (fingerprints are line-number-independent);
* `--cache-file` / `--changed-only` — content-hash incremental mode.

No CUDA context is ever created: the lint imports torch (through the
modules a config names) and may ask `torch.cuda.is_available()`, never
more (tests/test_torch_lint_cli.py runs it under a trap on
`torch.cuda._lazy_init`).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List, Optional

from tensor2robot_tpu_torch.analysis import engine as engine_lib
from tensor2robot_tpu_torch.analysis.findings import Finding

__all__ = ["run", "main"]

# Back-compat alias: callers (and tests) reached lint._discover.
_discover = engine_lib.discover


def run(paths: List[str]) -> List[Finding]:
  """Runs all analyzers; returns every unsuppressed finding."""
  return engine_lib.run_engine(paths).findings


def _finding_json(finding: Finding, suppressed_by: Optional[int] = None
                  ) -> str:
  record = {"path": finding.path, "line": finding.line,
            "rule": finding.rule,
            "severity": engine_lib.severity_of(finding.rule),
            "message": finding.message,
            "suppressed": suppressed_by is not None}
  if suppressed_by is not None:
    record["suppressed_by"] = suppressed_by
  return json.dumps(record)


def _append_runs_record(runs_path: str, stats: dict,
                        finding_count: int) -> None:
  """One runs.jsonl bench record carrying the lint telemetry block —
  `graftscope diff` gates lint_parse_ms/lint_rules_ms like any other
  wall-clock metric (runlog.DEFAULT_THRESHOLDS)."""
  from tensor2robot_tpu_torch.obs import runlog
  record = runlog.make_record(
      "bench",
      bench={"name": "lint", "unit": "ms",
             "lint_parse_ms": stats["parse_ms"],
             "lint_rules_ms": stats["rules_ms"]},
      extra={"lint": {"files": stats["files"],
                      "py_files": stats["py_files"],
                      "gin_files": stats["gin_files"],
                      "parses": stats["parses"],
                      "parse_ms": stats["parse_ms"],
                      "rules_ms": stats["rules_ms"],
                      "wall_ms": stats["wall_ms"],
                      "cache_hits": stats["cache_hits"],
                      "findings": finding_count}})
  runlog.append_record(runs_path, record)


def main(argv: List[str] = None) -> int:
  parser = argparse.ArgumentParser(
      prog="python -m tensor2robot_tpu_torch.analysis.lint",
      description="graftlint: static analysis for configs, specs, and "
                  "tracer hygiene (no CUDA context is created).")
  parser.add_argument("paths", nargs="*",
                      default=["tensor2robot_tpu_torch"],
                      help="files or directories to lint "
                           "(default: tensor2robot_tpu_torch)")
  parser.add_argument("--json", action="store_true", dest="as_json",
                      help="emit findings as JSON lines (includes rule "
                           "severity and suppression provenance)")
  parser.add_argument("--list-rules", action="store_true",
                      help="print the rule catalog (generated from the "
                           "rule registry) and exit")
  parser.add_argument("--stats", action="store_true",
                      help="print lint files/parse/rule timing to stderr")
  parser.add_argument("--runs", metavar="PATH",
                      help="append a lint telemetry record to this "
                           "runs.jsonl (diff-gated like bench metrics)")
  parser.add_argument("--baseline", metavar="PATH",
                      help="suppress findings recorded in this baseline "
                           "file (gate only NEW findings)")
  parser.add_argument("--write-baseline", metavar="PATH",
                      help="write current findings to a baseline file "
                           "and exit 0")
  parser.add_argument("--cache-file", metavar="PATH",
                      help="incremental mode: reuse findings of files "
                           "whose content hash is unchanged")
  parser.add_argument("--changed-only", action="store_true",
                      help="with --cache-file: report only files whose "
                           "content hash moved (CI fast path; .gin "
                           "results may be stale vs module edits — run "
                           "a full lint before release)")
  args = parser.parse_args(argv)
  if args.list_rules:
    print(engine_lib.catalog_text(), end="")
    return 0
  if args.changed_only and not args.cache_file:
    print("graftlint: --changed-only requires --cache-file",
          file=sys.stderr)
    return 2
  missing = [p for p in args.paths if not os.path.exists(p)]
  if missing:
    print(f"graftlint: no such path: {', '.join(missing)}",
          file=sys.stderr)
    return 2
  # An explicitly named file the analyzers would silently skip is an
  # operator error, not a clean result.
  unsupported = [p for p in args.paths
                 if os.path.isfile(p) and not p.endswith((".py", ".gin"))]
  if unsupported:
    print("graftlint: unsupported file type (want .py or .gin): "
          f"{', '.join(unsupported)}", file=sys.stderr)
    return 2
  result = engine_lib.run_engine(list(args.paths),
                                 cache_path=args.cache_file,
                                 changed_only=args.changed_only)
  findings = result.findings
  if args.write_baseline:
    engine_lib.write_baseline(args.write_baseline, findings)
    print(f"graftlint: baseline with {len(findings)} finding(s) "
          f"written to {args.write_baseline}", file=sys.stderr)
    return 0
  if args.baseline:
    try:
      known = engine_lib.load_baseline(args.baseline)
    except (OSError, ValueError) as e:
      print(f"graftlint: cannot read baseline: {e}", file=sys.stderr)
      return 2
    findings = [f for f in findings
                if engine_lib.finding_fingerprint(f) not in known]
  for finding in findings:
    if args.as_json:
      print(_finding_json(finding))
    else:
      print(finding)
  if args.as_json:
    # Suppression provenance: what `# graftlint: disable` comments ate,
    # and where — so a JSON consumer can audit the suppressions too.
    for finding, at_line in result.suppressed:
      print(_finding_json(finding, suppressed_by=at_line))
  if args.stats:
    s = result.stats
    print(f"graftlint: lint/files={s['files']} "
          f"lint/parse_ms={s['parse_ms']:.1f} "
          f"lint/rules_ms={s['rules_ms']:.1f} "
          f"(parses={s['parses']}, cache_hits={s['cache_hits']}, "
          f"wall_ms={s['wall_ms']:.1f})", file=sys.stderr)
  if args.runs:
    _append_runs_record(args.runs, result.stats, len(findings))
  if findings:
    print(f"graftlint: {len(findings)} finding(s)", file=sys.stderr)
    return 1
  return 0


if __name__ == "__main__":
  sys.exit(main())
