"""graftlint: thread-spawning loader/stage classes must be closable.

The repo's data plane runs on background threads (the pipelined host
loader's parse pool + preprocess worker, `DevicePrefetcher`'s infeed
worker, `MicroBatcher`'s dispatch worker), and the hard-won discipline
for them is uniform: a stage thread must be STOPPABLE AND JOINABLE
through a `close()` method — a daemon thread killed at interpreter
shutdown mid device-op dies inside a CUDA call with the card's context
half torn down — and an instance that is
abandoned without close() must still be recoverable, either because
callers hold it in a `with` block (context manager) or because a
`weakref.finalize` backstop stops the worker when the instance is
collected. These rules mechanize that discipline for every NEW
thread-spawning class, the same way `device-timing` mechanized the
barrier rules:

* `thread-stage-missing-close` — a class whose body starts a
  `threading.Thread` but defines no `close()` method: its worker can
  outlive every consumer with no way to stop it.
* `thread-stage-missing-backstop` — such a class has `close()` but
  neither context-manager support (`__enter__`) nor a
  `weakref.finalize` registration: an abandoned instance leaks its
  worker until process exit.

Both findings anchor on the `Thread(...)` construction line, so one
trailing `# graftlint: disable=<rule>` there suppresses a deliberate
exception (e.g. a one-shot worker that terminates by itself and is
joined elsewhere). Plain functions that spawn-and-join inline
(`serving/loadgen.run_load`, `data/pipeline.prefetch`) are exempt by
construction — the rule is about classes, whose instances carry the
thread's lifetime past the spawning call.

The port of the JAX package's `analysis.thread_check`. Pure AST
analysis, device-free like every graftlint rule.
"""

from __future__ import annotations

import ast
from typing import List, Optional

from tensor2robot_tpu_torch.analysis import engine as engine_lib
from tensor2robot_tpu_torch.analysis.findings import (Finding, filter_findings,
                                                load_suppressions)

__all__ = ["check_python_source", "check_python_file"]

_RULE_CLOSE = "thread-stage-missing-close"
_RULE_BACKSTOP = "thread-stage-missing-backstop"


def _is_thread_ctor(func: ast.AST) -> bool:
  """`threading.Thread(...)` / `Thread(...)` construction."""
  if isinstance(func, ast.Name):
    return func.id == "Thread"
  if isinstance(func, ast.Attribute):
    return func.attr == "Thread"
  return False


def _is_finalize_call(node: ast.Call) -> bool:
  """`weakref.finalize(...)` (or any `.finalize(...)`) registration."""
  func = node.func
  if isinstance(func, ast.Attribute):
    return func.attr == "finalize"
  if isinstance(func, ast.Name):
    return func.id == "finalize"
  return False


def _scan_class(cls: ast.ClassDef):
  """(thread_calls, has_close, has_enter, has_finalize) for one class,
  not descending into nested classes (their threads are their own
  responsibility)."""
  thread_calls: List[ast.Call] = []
  has_finalize = False
  has_close = any(isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef))
                  and item.name == "close" for item in cls.body)
  has_enter = any(isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef))
                  and item.name == "__enter__" for item in cls.body)

  def _walk(node: ast.AST) -> None:
    nonlocal has_finalize
    for child in ast.iter_child_nodes(node):
      if isinstance(child, ast.ClassDef):
        continue
      if isinstance(child, ast.Call):
        if _is_thread_ctor(child.func):
          thread_calls.append(child)
        elif _is_finalize_call(child):
          has_finalize = True
      _walk(child)

  for item in cls.body:
    _walk(item)
  return thread_calls, has_close, has_enter, has_finalize


def _check_class(path: str, node: ast.ClassDef) -> List[Finding]:
  """Findings for one ClassDef (shared by the standalone parse path and
  the engine's single-walk visitor dispatch)."""
  thread_calls, has_close, has_enter, has_finalize = _scan_class(node)
  findings: List[Finding] = []
  for call in thread_calls:
    end_line = getattr(call, "end_lineno", call.lineno) or call.lineno
    if not has_close:
      findings.append(Finding(
          path=path, line=call.lineno, rule=_RULE_CLOSE,
          end_line=end_line,
          message=(f"class {node.name} starts a thread but defines no "
                   "close(): the worker cannot be stopped/joined — a "
                   "daemon thread killed at interpreter shutdown mid "
                   "device op dies inside a CUDA call. "
                   "Add close() that stops AND joins the worker "
                   "(DevicePrefetcher/OverlappedLoader discipline).")))
    elif not (has_enter or has_finalize):
      findings.append(Finding(
          path=path, line=call.lineno, rule=_RULE_BACKSTOP,
          end_line=end_line,
          message=(f"class {node.name} starts a thread and has close() "
                   "but neither __enter__ (context-manager use) nor a "
                   "weakref.finalize backstop: an instance abandoned "
                   "without close() leaks its worker until process "
                   "exit. Add the CM protocol or register a finalizer "
                   "that sets the stop event.")))
  return findings


def check_python_source(path: str, source: str) -> List[Finding]:
  try:
    tree = ast.parse(source, filename=path)
  except SyntaxError:
    return []  # the engine reports unparseable files
  findings: List[Finding] = []
  for node in ast.walk(tree):
    if isinstance(node, ast.ClassDef):
      findings.extend(_check_class(path, node))
  return findings


def check_python_file(path: str) -> List[Finding]:
  with open(path, encoding="utf-8", errors="replace") as f:
    source = f.read()
  return filter_findings(check_python_source(path, source),
                         load_suppressions(source))


engine_lib.register(engine_lib.Rule(
    name="thread", kind="py", scope=".py", family="thread",
    infos=(
        engine_lib.RuleInfo(
            id=_RULE_CLOSE,
            doc=("a class starts a threading.Thread but\n"
                 "defines no close() — its worker can never be\n"
                 "stopped/joined;\n"
                 "loader/stage classes must expose close()"),
            meaning=("a class starts a `threading.Thread` but defines "
                     "no `close()` — its worker can never be "
                     "stopped/joined")),
        engine_lib.RuleInfo(
            id=_RULE_BACKSTOP,
            doc=("such a class has close() but neither\n"
                 "__enter__ (context-manager use) nor a\n"
                 "weakref.finalize backstop — an abandoned\n"
                 "instance leaks its worker until process exit"),
            meaning=("such a class has `close()` but neither "
                     "`__enter__` nor a `weakref.finalize` backstop — "
                     "abandoned instances leak their worker")),
    ),
    visitors={ast.ClassDef: lambda ctx, node: _check_class(ctx.path,
                                                           node)}))
