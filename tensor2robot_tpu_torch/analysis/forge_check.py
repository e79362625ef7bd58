"""graftlint: forgeable warmup surfaces (graftforge, obs/forge.py).

graftforge warms a deployment's executables from its research config
and specs ALONE — before any process starts, with no traffic to learn
from. That only works when every engine's bucket ladder is derivable
statically: a `BucketedEngine`/`SessionEngine` construction whose
`buckets=` is computed at runtime (a traffic-derived
`traffic_bucket_ladder(...)`, an attribute read, arbitrary arithmetic)
describes rungs the compile farm cannot enumerate — and a rung forge
can't enumerate is a rung the farm can't warm: its first live request
pays the cold compile the farm exists to kill (the sequence train
step's took 30.2-58.0 s on the card, PERF.md). The port of the JAX
package's `analysis.forge_check`.

* `warmup-unforgeable` — an engine construction site whose `buckets=`
  value is not spec-derivable. Accepted as derivable: no `buckets=` at
  all (the default doubling ladder from `max_batch_size`), a literal
  `None`, a literal list/tuple of ints, a module-level constant bound
  to such a literal, a direct `bucket_ladder(...)` call (the canonical
  derivation), and `**splat` call sites (not statically analyzable).
  Everything else is a finding. Runtime-derived ladders are sometimes
  the point (the fleet bench's `traffic_bucket_ladder` A/B) — those
  sites carry a justified suppression and, in production, route ladder
  changes through `ServingFleet.rollout(ladder=...)`, which pre-forges
  the new rungs inside the drained window instead of in front of
  traffic.

Pure AST analysis, device-free like every graftlint rule. Suppress
with a trailing `# graftlint: disable=warmup-unforgeable`.
"""

from __future__ import annotations

import ast
from typing import Dict, List

from tensor2robot_tpu_torch.analysis import engine as engine_lib
from tensor2robot_tpu_torch.analysis.findings import (Finding, filter_findings,
                                                load_suppressions)

__all__ = ["check_python_source", "check_python_file"]

_RULE = "warmup-unforgeable"
_ENGINE_NAMES = ("BucketedEngine", "SessionEngine")


def _callee_name(func: ast.AST) -> str:
  if isinstance(func, ast.Name):
    return func.id
  if isinstance(func, ast.Attribute):
    return func.attr
  return ""


def _is_int_literal_sequence(node: ast.AST) -> bool:
  if not isinstance(node, (ast.List, ast.Tuple)):
    return False
  return all(isinstance(e, ast.Constant) and isinstance(e.value, int)
             for e in node.elts)


def _module_literal_names(tree: ast.Module) -> Dict[str, bool]:
  """Module-level `NAME = [1, 2, 4]`-style constants (the one
  indirection worth resolving: bench.py's SESSION_BUCKETS pattern)."""
  out: Dict[str, bool] = {}
  for node in tree.body:
    if isinstance(node, ast.Assign) and len(node.targets) == 1 \
        and isinstance(node.targets[0], ast.Name):
      out[node.targets[0].id] = _is_int_literal_sequence(node.value)
  return out


def _buckets_derivable(value: ast.AST,
                       literals: Dict[str, bool]) -> bool:
  if isinstance(value, ast.Constant) and value.value is None:
    return True
  if _is_int_literal_sequence(value):
    return True
  if isinstance(value, ast.Name):
    return literals.get(value.id, False)
  if isinstance(value, ast.Call) \
      and _callee_name(value.func) == "bucket_ladder":
    return True
  return False


def _check_call(path: str, node: ast.Call,
                literals: Dict[str, bool]) -> List[Finding]:
  """Findings for one Call node (shared by the standalone parse path
  and the engine's single-walk visitor dispatch; `literals` is the
  once-per-file module-literal table)."""
  if _callee_name(node.func) not in _ENGINE_NAMES:
    return []
  if any(kw.arg is None for kw in node.keywords):
    return []  # **splat: not statically analyzable, accepted
  findings: List[Finding] = []
  for kw in node.keywords:
    if kw.arg == "buckets" and not _buckets_derivable(kw.value,
                                                      literals):
      findings.append(Finding(
          path=path, line=node.lineno, rule=_RULE,
          end_line=getattr(node, "end_lineno", node.lineno),
          message=(f"{_callee_name(node.func)} built with a runtime-"
                   "derived bucket ladder: graftforge cannot "
                   "enumerate these rungs from specs, so the compile "
                   "farm cannot warm them — pass a literal ladder / "
                   "bucket_ladder(...), or route the ladder change "
                   "through ServingFleet.rollout(ladder=...) and "
                   "suppress with justification")))
  return findings


def check_python_source(path: str, source: str) -> List[Finding]:
  try:
    tree = ast.parse(source, filename=path)
  except SyntaxError:
    return []  # the engine reports unparseable files
  literals = _module_literal_names(tree)
  findings: List[Finding] = []
  for node in ast.walk(tree):
    if isinstance(node, ast.Call):
      findings.extend(_check_call(path, node, literals))
  return findings


def check_python_file(path: str) -> List[Finding]:
  try:
    with open(path, encoding="utf-8") as f:
      source = f.read()
  except (OSError, UnicodeDecodeError):
    return []
  return filter_findings(check_python_source(path, source),
                         load_suppressions(source))


def _visit(ctx, node):
  literals = ctx.memo("forge:literals",
                      lambda: _module_literal_names(ctx.tree))
  return _check_call(ctx.path, node, literals)


engine_lib.register(engine_lib.Rule(
    name="forge", kind="py", scope=".py", family="forge",
    infos=(engine_lib.RuleInfo(
        id=_RULE,
        doc=("a BucketedEngine/SessionEngine construction\n"
             "whose `buckets=` is computed at runtime —\n"
             "graftforge cannot enumerate those rungs from\n"
             "the config/specs, so the compile farm cannot\n"
             "warm them and their first live request pays\n"
             "the cold compile; literal ladders,\n"
             "bucket_ladder(...), module-level literal\n"
             "constants, and `**splat` sites are accepted\n"
             "(route live ladder changes through\n"
             "ServingFleet.rollout(ladder=...))"),
        meaning=("a `BucketedEngine`/`SessionEngine` construction whose "
                 "`buckets=` is computed at runtime — graftforge cannot "
                 "enumerate those rungs from the config/specs, so the "
                 "compile farm cannot warm them and their first live "
                 "request pays the cold compile (literal "
                 "ladders, `bucket_ladder(...)`, module-level literal "
                 "constants, and `**splat` sites accepted; route live "
                 "ladder changes through `ServingFleet.rollout("
                 "ladder=...)`, which pre-forges inside the drained "
                 "window)")),),
    visitors={ast.Call: _visit}))
