"""graftlint: fleet/router owners must close (or drain) their replicas.

A `ServingFleet` (`serving/fleet.py`) owns one `MicroBatcher` /
`SessionBatcher` worker thread PER REPLICA plus every replica's engine;
its `close()` is the only path that JOINS those workers — the
join discipline the batchers themselves follow
(`thread-stage-missing-close` mechanizes it at the class level). A
construction site that builds a fleet and never arranges teardown
leaks N dispatch workers that can outlive every consumer, and a daemon
thread killed at interpreter shutdown mid device-dispatch dies inside a
CUDA call with the card's context half torn down. The port of the JAX
package's `analysis.fleet_check`.

Rule `fleet-replica-unjoined` flags a `ServingFleet(...)` construction
site (any `ServingFleet` / `serving.ServingFleet` call) unless its
owning scope visibly transfers or ends the fleet's lifetime:

* constructed as a `with` context item (the CM protocol closes it);
* the bound name later receives a `.close(...)` or `.drain(...)` call
  in the same scope;
* the bound name is `return`ed or `yield`ed (ownership moves to the
  caller, which this rule will check at ITS construction site — a
  factory is not a leak);
* the value is stored on `self` (an owning object whose own `close`
  discipline the thread rules already police).

Findings anchor on the construction line; a trailing
`# graftlint: disable=fleet-replica-unjoined` suppresses a deliberate
exception (e.g. a process-lifetime server whose fleet dies with the
process). Pure AST analysis, device-free like every graftlint rule
(pattern of `thread_check.py` / `pp_check.py`).
"""

from __future__ import annotations

import ast
from typing import List, Optional

from tensor2robot_tpu_torch.analysis import engine as engine_lib
from tensor2robot_tpu_torch.analysis.findings import (Finding, filter_findings,
                                                load_suppressions)

__all__ = ["check_python_source", "check_python_file"]

_RULE = "fleet-replica-unjoined"
_FLEET_NAMES = ("ServingFleet",)
_RELEASE_METHODS = ("close", "drain")


def _call_name(func: ast.AST) -> Optional[str]:
  if isinstance(func, ast.Name):
    return func.id
  if isinstance(func, ast.Attribute):
    return func.attr
  return None


def _is_fleet_ctor(node: ast.AST) -> bool:
  return (isinstance(node, ast.Call)
          and _call_name(node.func) in _FLEET_NAMES)


def _scope_bodies(tree: ast.Module):
  """Yields (scope_body, is_module) for the module and every function —
  the ownership units the rule reasons about. Class bodies are not
  scopes of their own (a fleet built at class-definition level is
  module-ish and lands in the module walk)."""
  yield tree.body, True
  for node in ast.walk(tree):
    if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
      yield node.body, False


def _walk_scope(node: ast.AST):
  """ast.walk that does NOT descend into nested function definitions —
  each function body is its own ownership scope (yielded separately by
  `_scope_bodies`), so a fleet built inside a nested function must be
  judged against THAT scope's releases, not its encloser's."""
  yield node
  for child in ast.iter_child_nodes(node):
    if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                          ast.Lambda)):
      continue
    yield from _walk_scope(child)


def _released_names(body) -> set:
  """Names whose fleet lifetime is visibly handled inside `body`:
  closed/drained, returned/yielded, or stored on self."""
  released: set = set()
  for stmt in body:
    for node in _walk_scope(stmt):
      if isinstance(node, ast.Call):
        func = node.func
        if (isinstance(func, ast.Attribute)
            and func.attr in _RELEASE_METHODS
            and isinstance(func.value, ast.Name)):
          released.add(func.value.id)
      elif isinstance(node, (ast.Return, ast.Yield)) and node.value:
        if isinstance(node.value, ast.Name):
          released.add(node.value.id)
        elif isinstance(node.value, (ast.Tuple, ast.List)):
          for element in node.value.elts:
            if isinstance(element, ast.Name):
              released.add(element.id)
      elif isinstance(node, ast.Assign):
        for target in node.targets:
          if (isinstance(target, ast.Attribute)
              and isinstance(target.value, ast.Name)
              and target.value.id == "self"
              and isinstance(node.value, ast.Name)):
            released.add(node.value.id)
  return released


def _with_context_calls(body) -> List[ast.Call]:
  """Fleet constructions appearing as `with ServingFleet(...) [as x]`
  context items anywhere in the scope — the CM closes them."""
  calls: List[ast.Call] = []
  for stmt in body:
    for node in _walk_scope(stmt):
      if isinstance(node, (ast.With, ast.AsyncWith)):
        for item in node.items:
          if _is_fleet_ctor(item.context_expr):
            calls.append(item.context_expr)
  return calls


def check_python_tree(path: str, tree: ast.Module) -> List[Finding]:
  """Raw (unfiltered) findings over an already-parsed module (the
  engine's entry point; `check_python_source` wraps it with a parse)."""
  findings: List[Finding] = []
  seen_ctors: set = set()
  for body, _ in _scope_bodies(tree):
    with_calls = {id(c) for c in _with_context_calls(body)}
    released = _released_names(body)
    # Parent map within this scope (function bodies excluded, so a
    # ctor is judged against exactly one scope).
    parents: dict = {}
    for stmt in body:
      for node in _walk_scope(stmt):
        for child in ast.iter_child_nodes(node):
          parents[id(child)] = node
    for stmt in body:
      for node in _walk_scope(stmt):
        if not _is_fleet_ctor(node) or id(node) in seen_ctors:
          continue
        seen_ctors.add(id(node))
        if id(node) in with_calls:
          continue
        parent = parents.get(id(node))
        handled = False
        bound: Optional[str] = None
        if isinstance(parent, ast.Assign) and parent.value is node:
          target = parent.targets[0]
          if isinstance(target, ast.Name):
            bound = target.id
          elif isinstance(target, ast.Attribute) \
              and isinstance(target.value, ast.Name) \
              and target.value.id == "self":
            handled = True  # stored on self: the owner's close discipline
        elif isinstance(parent, ast.Return):
          handled = True  # factory: ownership moves to the caller
        if handled or (bound is not None and bound in released):
          continue
        findings.append(Finding(
            path=path, line=node.lineno, rule=_RULE,
            end_line=getattr(node, "end_lineno", node.lineno)
            or node.lineno,
            message=("ServingFleet constructed but its owner never "
                     "calls close()/drain(), uses it as a context "
                     "manager, returns it, or stores it on self: the "
                     "fleet's per-replica batcher workers are never "
                     "joined (a daemon killed mid CUDA call). Close the "
                     "fleet in a finally/with, or suppress a "
                     "process-lifetime server deliberately.")))
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


engine_lib.register(engine_lib.Rule(
    name="fleet", kind="py", scope=".py", family="fleet",
    infos=(engine_lib.RuleInfo(
        id=_RULE,
        doc=("a `ServingFleet(...)` construction site whose\n"
             "owning scope never calls close()/drain() on\n"
             "it, uses it as a context manager, returns it,\n"
             "or stores it on self — the fleet's\n"
             "per-replica batcher workers are never joined\n"
             "(the join discipline the batchers\n"
             "follow, mechanized for the fleet layer)"),
        meaning=("a `ServingFleet(...)` construction site whose owning "
                 "scope never calls `close()`/`drain()` on it, uses it "
                 "as a context manager, returns it, or stores it on "
                 "`self` — the fleet's per-replica batcher workers are "
                 "never joined (the batchers' join discipline, "
                 "mechanized at the fleet layer)")),),
    check=lambda ctx: check_python_tree(ctx.path, ctx.tree)))
