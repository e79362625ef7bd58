"""graftlint: graftloop worker threads must be supervisor-registered.

The always-on loop's liveness floor is the supervisor (`loop/
supervisor.py`): every loop worker goes through `Supervisor.spawn`, so
crashes restart under the shared retry schedule, hangs are detected by
heartbeat, and escalation budgets stop a dying worker from
restart-looping forever. A worker thread constructed with a bare
`threading.Thread(...)` inside the loop package sidesteps ALL of that —
it dies silently, hangs invisibly, and its failure never reaches the
incident stream. This rule mechanizes the registration seam the
supervisor module documents, the same way `fleet-replica-unjoined`
mechanized the fleet's join discipline:

* `unsupervised-loop-worker` — a `threading.Thread(...)` construction
  in a module of the `loop` package OTHER than `supervisor.py` (whose
  monitor + worker threads ARE the supervision machinery, exempt by
  construction). Register the worker with `Supervisor.spawn(name,
  target)` instead; a deliberate unsupervised helper (e.g. a bounded
  one-shot join-elsewhere thread) suppresses with a trailing
  `# graftlint: disable=unsupervised-loop-worker`.

Scope is PATH-based (a file whose parent directory is named `loop`):
the discipline belongs to the loop subsystem — data-plane loaders and
serving batchers have their own thread rules (`thread-stage-*`), which
still apply here too. The port of the JAX package's
`analysis.loop_check`. Pure AST analysis, device-free like every
graftlint rule.
"""

from __future__ import annotations

import ast
import os
from typing import List

from tensor2robot_tpu_torch.analysis import engine as engine_lib
from tensor2robot_tpu_torch.analysis.findings import (Finding, filter_findings,
                                                load_suppressions)

__all__ = ["check_python_source", "check_python_file"]

_RULE = "unsupervised-loop-worker"
_EXEMPT_BASENAMES = frozenset({"supervisor.py"})


def _in_loop_package(path: str) -> bool:
  return os.path.basename(os.path.dirname(os.path.abspath(path))) == "loop"


def _is_thread_ctor(func: ast.AST) -> bool:
  """`threading.Thread(...)` / `Thread(...)` construction."""
  if isinstance(func, ast.Name):
    return func.id == "Thread"
  if isinstance(func, ast.Attribute):
    return func.attr == "Thread"
  return False


def _rule_applies(path: str) -> bool:
  return (_in_loop_package(path)
          and os.path.basename(path) not in _EXEMPT_BASENAMES)


def _check_call(path: str, node: ast.Call) -> List[Finding]:
  """Findings for one Call node (shared by the standalone parse path
  and the engine's single-walk visitor dispatch; the path gate is
  applied by the caller)."""
  if not _is_thread_ctor(node.func):
    return []
  end_line = getattr(node, "end_lineno", node.lineno) or node.lineno
  return [Finding(
      path=path, line=node.lineno, rule=_RULE, end_line=end_line,
      message=("bare threading.Thread in the loop package: this "
               "worker is outside the supervisor's restart/heartbeat"
               "/escalation machinery — it dies silently and hangs "
               "invisibly. Register it with Supervisor.spawn(name, "
               "target) (loop/supervisor.py) instead."))]


def check_python_source(path: str, source: str) -> List[Finding]:
  if not _rule_applies(path):
    return []
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
    name="loop", kind="py", scope=".py, the loop/ package only",
    family="loop",
    infos=(engine_lib.RuleInfo(
        id=_RULE,
        doc=("a bare threading.Thread construction in a\n"
             "loop-package module other than supervisor.py —\n"
             "the worker is outside the supervisor's restart/\n"
             "heartbeat/escalation machinery (dies silently,\n"
             "hangs invisibly); register it with\n"
             "Supervisor.spawn instead"),
        meaning=("a bare `threading.Thread` construction in a "
                 "loop-package module other than `supervisor.py` — the "
                 "worker is outside the supervisor's restart/heartbeat/"
                 "escalation machinery (dies silently, hangs "
                 "invisibly); register it with `Supervisor.spawn` "
                 "instead")),),
    path_filter=_rule_applies,
    visitors={ast.Call: lambda ctx, node: _check_call(ctx.path, node)}))
