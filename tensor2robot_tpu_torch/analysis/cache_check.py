"""graftlint: executable-cache key completeness.

A persistent cache of compiled steps is only as safe as its key: an
entry keyed without the device loads one card's artifacts on another;
without the args' dtypes it serves a bf16 graph to f32 traffic; without
the versions it replays artifacts across a torch, CUDA or Triton
upgrade; without the kernels' fingerprint it keeps a graph whose kernel
source changed. `obs.excache.cache_key` therefore takes
every component as a mandatory keyword, and this rule makes omission a
STATIC finding rather than a runtime TypeError in whatever process
first takes the path:

* `cache-key-missing-component` — a `cache_key(...)` /
  `excache.cache_key(...)` call site that does not pass every required
  component keyword (`args`, `model`, `donation`, `device`, `mesh`,
  `versions`, `kernels`). A literal `**kwargs` splat at the call site
  is accepted (not statically analyzable); the idiomatic
  `**excache.key_components(...)` splat is exactly that.

The port of the JAX package's `analysis.cache_check`, over the port's
key components. Pure AST analysis, device-free like every graftlint
rule. Suppress
with a trailing `# graftlint: disable=cache-key-missing-component`.
"""

from __future__ import annotations

import ast
from typing import List

from tensor2robot_tpu_torch.analysis import engine as engine_lib
from tensor2robot_tpu_torch.analysis.findings import (Finding, filter_findings,
                                                load_suppressions)

__all__ = ["REQUIRED_COMPONENTS", "check_python_source",
           "check_python_file"]

# Mirrors the mandatory keywords of obs.excache.cache_key — the
# components without which a persisted compile can be loaded onto the
# wrong device/dtype/compiler/kernel (tests/test_torch_lint_rules.py
# pins the two lists against each other so they cannot drift).
REQUIRED_COMPONENTS = ("args", "model", "donation", "device", "mesh",
                       "versions", "kernels")

_RULE = "cache-key-missing-component"


def _is_cache_key_call(func: ast.AST) -> bool:
  if isinstance(func, ast.Name):
    return func.id == "cache_key"
  if isinstance(func, ast.Attribute):
    return func.attr == "cache_key"
  return False


def _check_call(path: str, node: ast.Call) -> List[Finding]:
  """Findings for one Call node (shared by the standalone parse path
  and the engine's single-walk visitor dispatch)."""
  if not _is_cache_key_call(node.func):
    return []
  if any(kw.arg is None for kw in node.keywords):
    return []  # **splat: components arrive as a dict, not analyzable
  passed = {kw.arg for kw in node.keywords}
  missing = [c for c in REQUIRED_COMPONENTS if c not in passed]
  if not missing:
    return []
  return [Finding(
      path=path, line=node.lineno, rule=_RULE,
      end_line=getattr(node, "end_lineno", node.lineno) or node.lineno,
      message=(f"cache_key call omits key component(s) "
               f"{', '.join(missing)} — an under-keyed cache can serve "
               "mismatched compile artifacts (wrong device/dtype/"
               "compiler/kernel); pass every component, e.g. "
               "**excache.key_components(args, ...)"))]


def check_python_source(path: str, source: str) -> List[Finding]:
  try:
    tree = ast.parse(source, filename=path)
  except SyntaxError:
    return []  # the engine (née tracer_check) reports unparseable files
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
    name="cache", kind="py", scope=".py", family="cache",
    infos=(engine_lib.RuleInfo(
        id=_RULE,
        doc=("a `cache_key(...)` call site omits one\n"
             "of the mandatory graftcache key components\n"
             "(args' shapes/dtypes, model, donation layout,\n"
             "device, mesh, torch/CUDA/Triton versions,\n"
             "kernel sources) — an under-keyed cache can\n"
             "serve mismatched compile artifacts;\n"
             "a `**splat` call site is accepted"),
        meaning=("a `cache_key(...)` call site omits a mandatory key "
                 "component (`**splat` accepted)")),),
    visitors={ast.Call: lambda ctx, node: _check_call(ctx.path, node)}))
