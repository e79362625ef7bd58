"""graftlint: a `trace_ctx` parameter accepted then dropped.

graftrace (`obs/graftrace.py`) threads request/causality contexts
across the serving and loop layers two ways: the thread-local
(`activate`/`current`) for same-thread propagation, and an explicit
`trace_ctx` parameter at hand-off seams where the producing thread is
not the consuming one (`ReplayRecordSink.append_episode` is the
canonical carrier). The failure mode this rule mechanizes: a seam grows
a `trace_ctx` parameter, callers dutifully pass their context, and the
body never touches it — every caller's causal edge silently evaporates,
the merged timeline shows orphaned spans, and nothing errors. Exactly
the class of bug (dropped-on-the-floor telemetry plumbing) that is
invisible until someone needs the trace that isn't there.

Rule `trace-context-dropped` flags a function (sync or async) that
declares a parameter named `trace_ctx` whose body never references
`trace_ctx` — not to record it, not to forward it, not to default it
into the thread-local. A nested function closing over the name counts
as a use (forwarding through a worker closure is the normal shape).
Suppress a deliberate sink (e.g. an interface-compat stub) with a
trailing `# graftlint: disable=trace-context-dropped`.

The port of the JAX package's `analysis.trace_check`. Pure AST
analysis, device-free like every graftlint rule (pattern of
`fleet_check.py` / `thread_check.py`).
"""

from __future__ import annotations

import ast
from typing import List

from tensor2robot_tpu_torch.analysis import engine as engine_lib
from tensor2robot_tpu_torch.analysis.findings import (Finding, filter_findings,
                                                load_suppressions)

__all__ = ["check_python_source", "check_python_file"]

_RULE = "trace-context-dropped"
_PARAM = "trace_ctx"


def _declares_param(node: ast.AST) -> bool:
  args = node.args
  named = list(args.posonlyargs) + list(args.args) + list(args.kwonlyargs)
  if args.vararg is not None:
    named.append(args.vararg)
  if args.kwarg is not None:
    named.append(args.kwarg)
  return any(a.arg == _PARAM for a in named)


def _body_uses_param(node: ast.AST) -> bool:
  """Whether the function BODY references the name (the walk covers
  nested defs too — a closure forwarding the context is a use; the
  declaring function's own parameter list is not part of its body)."""
  for stmt in node.body:
    for inner in ast.walk(stmt):
      if isinstance(inner, ast.Name) and inner.id == _PARAM:
        return True
      # A nested def RE-DECLARING trace_ctx shadows the outer one; its
      # internal uses belong to the inner scope, but the engine visits
      # every FunctionDef in the shared walk anyway, so the inner
      # function is judged on its own. Over-approximating here (a
      # shadowed use counts for the outer scope too) only costs a
      # missed finding on a pathological shape, never a false positive.
  return False


def _check_function(path: str, node: ast.AST) -> List[Finding]:
  if not _declares_param(node):
    return []
  if _body_uses_param(node):
    return []
  return [Finding(
      path=path, line=node.lineno, rule=_RULE,
      end_line=getattr(node, "end_lineno", node.lineno) or node.lineno,
      message=(f"function {node.name!r} declares a `trace_ctx` "
               "parameter but its body never references it: every "
               "caller's causal edge is silently dropped (the merged "
               "timeline shows orphaned spans). Record it, forward it, "
               "or fall back to `graftrace.current()` — or suppress a "
               "deliberate interface-compat sink."))]


def check_python_tree(path: str, tree: ast.Module) -> List[Finding]:
  """Raw (unfiltered) findings over an already-parsed module (the
  engine's entry point; `check_python_source` wraps it with a parse)."""
  findings: List[Finding] = []
  for node in ast.walk(tree):
    if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
      findings.extend(_check_function(path, node))
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


def _visit_function(ctx: engine_lib.FileContext,
                    node: ast.AST) -> List[Finding]:
  return _check_function(ctx.path, node)


engine_lib.register(engine_lib.Rule(
    name="tracectx", kind="py", scope=".py", family="tracectx",
    infos=(engine_lib.RuleInfo(
        id=_RULE,
        doc=("a function declaring a `trace_ctx` parameter\n"
             "whose body never references it: callers pass\n"
             "their graftrace context and the causal edge is\n"
             "silently dropped — the merged timeline shows\n"
             "orphaned spans with nothing erroring"),
        meaning=("a function declaring a `trace_ctx` parameter whose "
                 "body never references it — callers' graftrace "
                 "causal edges are silently dropped and the merged "
                 "timeline shows orphaned spans")),),
    visitors={ast.FunctionDef: _visit_function,
              ast.AsyncFunctionDef: _visit_function}))
