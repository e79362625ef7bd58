"""graftlint: pipeline train steps must be schedule-audited.

A pipelined train step is the one step in this repo whose cost is
dominated by its SCHEDULE, not its kernels: the bubble fraction and the
per-stage donation layout decide whether the pp dimension scales, and
both are only observable when the step is built through the `obs.xray`
path (`make_pipelined_train_step(audit_name=...)` wraps the step in an
`XrayedFunction`, whose record carries donated/undonated bytes by
`donate_argnums` next to the `pp/bubble_fraction` schedule gauges; on a
mesh of more than one rank the step stays eager, `cache/skipped_mesh`). A call site that builds the step
un-audited trains blind — a schedule regression (or a donation silently
dropped by a refactor) never reaches runs.jsonl and can't be gated by
`graftscope diff`:

* `pp-schedule-unaudited` — a `make_pipelined_train_step(...)` call
  site that passes no `audit_name=` (nor an `**kwargs` splat, which is
  not statically analyzable and is accepted like cache_check does).
  Passing `audit_name=None` explicitly is also flagged — spell a
  deliberate opt-out with a suppression comment instead, so the
  decision is visible at the call site.

The port of the JAX package's `analysis.pp_check`. Pure AST analysis,
device-free like every graftlint rule. Suppress with a trailing
`# graftlint: disable=pp-schedule-unaudited`.
"""

from __future__ import annotations

import ast
from typing import List

from tensor2robot_tpu_torch.analysis import engine as engine_lib
from tensor2robot_tpu_torch.analysis.findings import (Finding, filter_findings,
                                                load_suppressions)

__all__ = ["check_python_source", "check_python_file"]

_RULE = "pp-schedule-unaudited"
_FACTORY = "make_pipelined_train_step"


def _is_factory_call(func: ast.AST) -> bool:
  if isinstance(func, ast.Name):
    return func.id == _FACTORY
  if isinstance(func, ast.Attribute):
    return func.attr == _FACTORY
  return False


def _check_call(path: str, node: ast.Call) -> List[Finding]:
  """Findings for one Call node (shared by the standalone parse path
  and the engine's single-walk visitor dispatch)."""
  if not _is_factory_call(node.func):
    return []
  if any(kw.arg is None for kw in node.keywords):
    return []  # **splat: audit_name may arrive in the dict
  audit = next((kw for kw in node.keywords if kw.arg == "audit_name"),
               None)
  audited = audit is not None and not (
      isinstance(audit.value, ast.Constant) and audit.value.value is None)
  if audited:
    return []
  return [Finding(
      path=path, line=node.lineno, rule=_RULE,
      end_line=getattr(node, "end_lineno", node.lineno) or node.lineno,
      message=("pipelined train step built without audit_name= — the "
               "step never routes through obs.xray, so its "
               "per-stage donation bytes and pp/bubble_fraction "
               "schedule telemetry stay out of runs.jsonl and "
               "schedule regressions can't be diff-gated; pass "
               "audit_name='<run>/pp_train_step' (or suppress a "
               "deliberate opt-out)"))]


def check_python_source(path: str, source: str) -> List[Finding]:
  try:
    tree = ast.parse(source, filename=path)
  except SyntaxError:
    return []  # the engine reports unparseable files
  findings: List[Finding] = []
  for node in ast.walk(tree):
    if isinstance(node, ast.Call):
      findings.extend(_check_call(path, node))
  return findings


def check_python_file(path: str) -> List[Finding]:
  with open(path, encoding="utf-8", errors="replace") as f:
    source = f.read()
  return filter_findings(check_python_source(path, source),
                         load_suppressions(source))


engine_lib.register(engine_lib.Rule(
    name="pp", kind="py", scope=".py", family="pipeline",
    infos=(engine_lib.RuleInfo(
        id=_RULE,
        doc=("a `make_pipelined_train_step(...)` call site\n"
             "that passes no `audit_name=` (or an explicit\n"
             "None) — the step skips the obs.xray path,\n"
             "so per-stage donation bytes and the\n"
             "pp/bubble_fraction schedule telemetry never\n"
             "reach runs.jsonl; a `**splat` call site is\n"
             "accepted"),
        meaning=("a `make_pipelined_train_step(...)` call site passes no "
                 "`audit_name=` (or an explicit None) — the step skips "
                 "obs.xray, so per-stage donation bytes and "
                 "pp/bubble_fraction telemetry never reach runs.jsonl "
                 "(`**splat` accepted)")),),
    visitors={ast.Call: lambda ctx, node: _check_call(ctx.path, node)}))
