"""graftlint: retry loops in serving//data/ hot paths must use the
shared RetryPolicy, not constant sleeps with swallowed errors.

graftguard (`utils/retry.py`) exists because every retry in the tree
used to be bespoke: a constant `time.sleep` inside a loop that also
swallows exceptions is the signature of a hand-rolled retry — no
jitter (N clients hammering a dead dependency re-synchronize into
thundering herds), no deadline budget (the loop can spin forever), no
telemetry (`retry/*` counters are how runs.jsonl shows retry
pressure), and a bare `except` that eats the error class information a
retryable-predicate needs.

Rule `bare-retry-rule` flags a `for`/`while` loop in a `serving/` or
`data/` source file (the dispatch and ingest hot paths; other trees
adopt the policy by convention, not lint force) that contains BOTH:

* a `time.sleep(<constant>)` call whose delay is a literal/constant
  expression — `sleep(policy.backoff_s(n))` or any computed delay does
  not match; and
* an exception handler that swallows broadly: a bare `except:` or
  `except Exception/BaseException:` whose body only `pass`es or
  `continue`s.

A bounded poll (`while not done: sleep(0.005)` with no exception
swallowing) and stop-aware queue waits are deliberately NOT flagged —
they pace, they don't retry. Suppress a justified exception with a
trailing `# graftlint: disable=bare-retry-rule`.

The port of the JAX package's `analysis.retry_check`. Pure AST
analysis, device-free like every graftlint rule (pattern of
`fleet_check.py` / `thread_check.py`).
"""

from __future__ import annotations

import ast
import os
from typing import List

from tensor2robot_tpu_torch.analysis import engine as engine_lib
from tensor2robot_tpu_torch.analysis.findings import (Finding, filter_findings,
                                                load_suppressions)

__all__ = ["check_python_source", "check_python_file"]

_RULE = "bare-retry-rule"
# Path components this rule polices (the dispatch and ingest hot paths).
_HOT_DIRS = frozenset({"serving", "data"})
_BROAD_EXC = frozenset({"Exception", "BaseException"})


def _is_constant_number(node: ast.AST) -> bool:
  if isinstance(node, ast.Constant):
    return isinstance(node.value, (int, float)) and not isinstance(
        node.value, bool)
  if isinstance(node, ast.UnaryOp) and isinstance(node.op,
                                                  (ast.USub, ast.UAdd)):
    return _is_constant_number(node.operand)
  if isinstance(node, ast.BinOp):
    return (_is_constant_number(node.left)
            and _is_constant_number(node.right))
  return False


def _is_constant_sleep(node: ast.AST) -> bool:
  """`time.sleep(<constant>)` (or any `*.sleep` / bare `sleep` — the
  module alias doesn't change what the loop does)."""
  if not isinstance(node, ast.Call) or not node.args:
    return False
  func = node.func
  name = (func.attr if isinstance(func, ast.Attribute)
          else func.id if isinstance(func, ast.Name) else None)
  return name == "sleep" and _is_constant_number(node.args[0])


def _swallows_broadly(handler: ast.ExceptHandler) -> bool:
  """Bare `except:` / `except (Base)Exception:` whose body is only
  pass/continue — the error vanishes and the loop goes around again."""
  exc_type = handler.type
  if exc_type is not None:
    names = []
    nodes = exc_type.elts if isinstance(exc_type, ast.Tuple) else [exc_type]
    for node in nodes:
      if isinstance(node, ast.Name):
        names.append(node.id)
      elif isinstance(node, ast.Attribute):
        names.append(node.attr)
    if not any(name in _BROAD_EXC for name in names):
      return False
  return all(isinstance(stmt, (ast.Pass, ast.Continue))
             for stmt in handler.body)


def _walk_no_nested_defs(node: ast.AST):
  """Walks a loop body without descending into nested function
  definitions — a sleep inside a nested def is not this loop's
  pacing."""
  yield node
  for child in ast.iter_child_nodes(node):
    if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                          ast.Lambda)):
      continue
    yield from _walk_no_nested_defs(child)


_PACKAGE_DIR = "tensor2robot_tpu_torch"


def _in_hot_path(path: str) -> bool:
  """Hot iff a `serving`/`data` DIRECTORY component lies below the repo
  package when the path contains one. Matching the absolute path would
  tie the rule's scope to the checkout location — a repo cloned under
  e.g. ~/data/ would police every file in the tree."""
  parts = os.path.normpath(path).split(os.sep)[:-1]  # dirs only
  for i in range(len(parts) - 1, -1, -1):
    if parts[i] == _PACKAGE_DIR:
      parts = parts[i + 1:]
      break
  return bool(_HOT_DIRS.intersection(parts))


def _check_loop(path: str, node: ast.AST) -> List[Finding]:
  """Findings for one For/While/AsyncFor node (shared by the standalone
  parse path and the engine's single-walk visitor dispatch; the
  hot-path gate is applied by the caller)."""
  has_sleep = False
  swallow_line = None
  for inner in _walk_no_nested_defs(node):
    if inner is node:
      continue
    if _is_constant_sleep(inner):
      has_sleep = True
    elif isinstance(inner, ast.ExceptHandler) and _swallows_broadly(inner):
      swallow_line = inner.lineno
  if not has_sleep or swallow_line is None:
    return []
  return [Finding(
      path=path, line=node.lineno, rule=_RULE,
      end_line=getattr(node, "end_lineno", node.lineno) or node.lineno,
      message=(
          "retry loop with a constant time.sleep and a broad "
          f"except-swallow (line {swallow_line}) in a serving/data "
          "hot path — use utils.retry.RetryPolicy (jittered "
          "backoff, deadline budget, retry/* telemetry) or "
          "suppress with justification"))]


def check_python_source(path: str, source: str) -> List[Finding]:
  if not _in_hot_path(path):
    return []
  try:
    tree = ast.parse(source, filename=path)
  except SyntaxError:
    return []  # the engine owns parse errors
  findings: List[Finding] = []
  for node in ast.walk(tree):
    if isinstance(node, (ast.For, ast.While, ast.AsyncFor)):
      findings.extend(_check_loop(path, node))
  suppressions = load_suppressions(source)
  return filter_findings(findings, suppressions)


def check_python_file(path: str) -> List[Finding]:
  try:
    with open(path, encoding="utf-8", errors="replace") as f:
      source = f.read()
  except OSError as e:
    return [Finding(path=path, line=0, rule=_RULE,
                    message=f"cannot read file: {e}")]
  return check_python_source(path, source)


def _visit(ctx, node):
  return _check_loop(ctx.path, node)


engine_lib.register(engine_lib.Rule(
    name="retry", kind="py", scope=".py, serving//data/ hot paths only",
    family="retry",
    infos=(engine_lib.RuleInfo(
        id=_RULE,
        doc=("a for/while loop containing BOTH a constant\n"
             "`time.sleep(<literal>)` AND a broad\n"
             "except-swallow (bare `except:` or\n"
             "`except (Base)Exception:` with a pass/continue\n"
             "body) — a hand-rolled retry with no jitter,\n"
             "deadline budget, or telemetry; migrate to\n"
             "`utils.retry.RetryPolicy` or suppress with\n"
             "justification"),
        meaning=("a `for`/`while` loop in a `serving/`/`data/` hot path "
                 "containing BOTH a constant `time.sleep(<literal>)` "
                 "AND a broad except-swallow (bare `except:` / `except "
                 "(Base)Exception:` with a pass/continue body) — a "
                 "hand-rolled retry with no jitter, deadline budget, or "
                 "`retry/*` telemetry; migrate to "
                 "`utils.retry.RetryPolicy` (`analysis/retry_check.py`; "
                 "computed delays like `sleep(policy.backoff_s(n))` and "
                 "pure poll loops are not flagged)")),),
    path_filter=_in_hot_path,
    visitors={ast.For: _visit, ast.While: _visit, ast.AsyncFor: _visit}))
