"""graftlint: an SLO declared without owning its budget/burn windows.

graftwatch (`obs/slo.py`) makes every objective carry its own error
budget and burn windows — `SloSpec` keyword-REQUIRES `budget`,
`fast_window_s` and `slow_window_s` precisely so no spec inherits an
invisible default that an operator never chose. Two drift modes defeat
that at a distance, and rule `slo-unbudgeted` mechanizes both:

1. A `SloSpec(...)` construction that verifiably omits any of the three
   required budget keywords. The runtime would TypeError too, but only
   on the code path that builds the spec — a config-gated or
   rarely-exercised SLO definition ships broken and fires exactly when
   someone finally needs the objective. A `**kwargs` splat in the call
   is unverifiable statically and is skipped (the runtime check owns
   it).
2. The `SLO_BURN` incident kind re-spelled as a string literal outside
   `obs/sentinel.py`. Incident sinks, eviction plumbing and dashboards
   must reference `sentinel.SLO_BURN` — a re-typed literal keeps
   working until the constant is ever renamed or namespaced, at which
   point that sink silently stops matching burn incidents (the alert
   that doesn't fire is the most expensive kind of broken).

Suppress a deliberate site (e.g. a doc snippet) with a trailing
`# graftlint: disable=slo-unbudgeted`.

The port of the JAX package's `analysis.slo_check`. Pure AST analysis,
device-free like every graftlint rule (pattern of `trace_check.py` /
`fleet_check.py`).
"""

from __future__ import annotations

import ast
from typing import List

from tensor2robot_tpu_torch.analysis import engine as engine_lib
from tensor2robot_tpu_torch.analysis.findings import (Finding, filter_findings,
                                                load_suppressions)

__all__ = ["check_python_source", "check_python_file"]

_RULE = "slo-unbudgeted"
_REQUIRED = ("budget", "fast_window_s", "slow_window_s")
# Built by concatenation so this module's own source never contains the
# literal it polices.
_SLO_BURN_LITERAL = "serving_" + "slo_burn"
# The defining module (and its tests' fixture strings) legitimately
# spell the kind out; everything else must import the constant.
_DEFINING_SUFFIX = "obs/sentinel.py"


def _is_slospec_call(node: ast.Call) -> bool:
  func = node.func
  if isinstance(func, ast.Name):
    return func.id == "SloSpec"
  if isinstance(func, ast.Attribute):
    return func.attr == "SloSpec"
  return False


def _check_call(path: str, node: ast.Call) -> List[Finding]:
  if not _is_slospec_call(node):
    return []
  keywords = {kw.arg for kw in node.keywords}
  if None in keywords:
    return []  # **kwargs splat: not statically verifiable
  missing = [name for name in _REQUIRED if name not in keywords]
  if not missing:
    return []
  return [Finding(
      path=path, line=node.lineno, rule=_RULE,
      end_line=getattr(node, "end_lineno", node.lineno) or node.lineno,
      message=("SloSpec constructed without explicit "
               f"{', '.join(missing)}: every objective must own its "
               "error budget and burn windows (no inherited defaults) "
               "— this call TypeErrors the first time its code path "
               "runs, which for a config-gated SLO is during the "
               "incident it was meant to catch."))]


def _check_literal(path: str, node: ast.Constant) -> List[Finding]:
  if node.value != _SLO_BURN_LITERAL:
    return []
  if path.replace("\\", "/").endswith(_DEFINING_SUFFIX):
    return []
  return [Finding(
      path=path, line=node.lineno, rule=_RULE,
      end_line=getattr(node, "end_lineno", node.lineno) or node.lineno,
      message=(f"incident kind {_SLO_BURN_LITERAL!r} re-spelled as a "
               "literal: reference `obs.sentinel.SLO_BURN` instead — a "
               "re-typed kind keeps matching only until the constant "
               "changes, and then this sink/filter silently stops "
               "seeing burn incidents."))]


def check_python_tree(path: str, tree: ast.Module) -> List[Finding]:
  """Raw (unfiltered) findings over an already-parsed module (the
  engine's entry point; `check_python_source` wraps it with a parse)."""
  findings: List[Finding] = []
  for node in ast.walk(tree):
    if isinstance(node, ast.Call):
      findings.extend(_check_call(path, node))
    elif isinstance(node, ast.Constant):
      findings.extend(_check_literal(path, node))
  findings.sort(key=lambda f: f.line)
  return findings


def check_python_source(path: str, source: str) -> List[Finding]:
  try:
    tree = ast.parse(source, filename=path)
  except SyntaxError:
    return []  # the engine reports unparseable files
  return check_python_tree(path, tree)


def check_python_file(path: str) -> List[Finding]:
  with open(path, encoding="utf-8", errors="replace") as f:
    source = f.read()
  return filter_findings(check_python_source(path, source),
                         load_suppressions(source))


def _visit_call(ctx: engine_lib.FileContext,
                node: ast.Call) -> List[Finding]:
  return _check_call(ctx.path, node)


def _visit_constant(ctx: engine_lib.FileContext,
                    node: ast.Constant) -> List[Finding]:
  return _check_literal(ctx.path, node)


engine_lib.register(engine_lib.Rule(
    name="slo", kind="py", scope=".py", family="slo",
    infos=(engine_lib.RuleInfo(
        id=_RULE,
        doc=("an SLO that does not own its budget: a\n"
             "SloSpec call verifiably missing budget/\n"
             "fast_window_s/slow_window_s (it TypeErrors the\n"
             "first time that code path runs), or the\n"
             "SLO_BURN incident kind re-spelled as a string\n"
             "literal outside obs/sentinel.py (a sink that\n"
             "silently stops matching if the constant ever\n"
             "changes)"),
        meaning=("a `SloSpec` call verifiably missing its required "
                 "`budget`/`fast_window_s`/`slow_window_s` keywords, or "
                 "the `SLO_BURN` incident kind re-spelled as a literal "
                 "outside `obs/sentinel.py` instead of referencing "
                 "`sentinel.SLO_BURN`")),),
    visitors={ast.Call: _visit_call,
              ast.Constant: _visit_constant}))
