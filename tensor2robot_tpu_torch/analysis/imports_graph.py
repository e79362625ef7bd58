"""Static (AST-level) import closure over the repo's own packages.

The config checker must answer "does this .gin file's `import` lines —
plus the trainer/actor entry binaries — make configurable X importable in
a fresh process?" WITHOUT relying on what happens to be in `sys.modules`
of the analyzing process (a previously-analyzed config may have imported
the module, which would mask a missing import line). So the import graph
is computed statically: parse each module's AST for import statements and
take the transitive closure, following only modules that live inside the
repo (torch/numpy terminate the walk). The port of the JAX package's
`analysis.imports_graph`.
"""

from __future__ import annotations

import ast
import functools
import os
from typing import Iterable, List, Optional, Set, Tuple

__all__ = ["module_file", "static_import_closure", "module_imports"]


def _repo_root() -> str:
  # analysis/ sits directly under the package; repo root is two up.
  return os.path.dirname(os.path.dirname(os.path.dirname(
      os.path.abspath(__file__))))


def module_file(module: str, repo_root: Optional[str] = None
                ) -> Optional[str]:
  """Path of `module` if it is a repo-local python module/package."""
  root = repo_root or _repo_root()
  rel = module.replace(".", os.sep)
  for candidate in (os.path.join(root, rel + ".py"),
                    os.path.join(root, rel, "__init__.py")):
    if os.path.isfile(candidate):
      return candidate
  return None


def _ancestors(module: str) -> List[str]:
  parts = module.split(".")
  return [".".join(parts[:i]) for i in range(1, len(parts))]


@functools.lru_cache(maxsize=None)
def module_imports(module: str, repo_root: Optional[str] = None
                   ) -> Tuple[str, ...]:
  """Direct imports of `module` (absolute names), from its AST only."""
  path = module_file(module, repo_root)
  if path is None:
    return ()
  try:
    tree = ast.parse(open(path).read(), filename=path)
  except SyntaxError:
    return ()
  package = module if path.endswith("__init__.py") else \
      module.rsplit(".", 1)[0] if "." in module else ""
  out: List[str] = []
  for node in ast.walk(tree):
    if isinstance(node, ast.Import):
      out.extend(alias.name for alias in node.names)
    elif isinstance(node, ast.ImportFrom):
      if node.level:  # relative import
        base_parts = package.split(".") if package else []
        # level=1 is the current package; each extra level pops one.
        base_parts = base_parts[:len(base_parts) - (node.level - 1)]
        base = ".".join(p for p in base_parts if p)
      else:
        base = node.module or ""
      if node.level and node.module:
        base = f"{base}.{node.module}" if base else node.module
      if base:
        out.append(base)
        # `from pkg import sub` may name a submodule: include it when it
        # resolves to a repo file (importing it executes sub's module).
        for alias in node.names:
          child = f"{base}.{alias.name}"
          if module_file(child, repo_root) is not None:
            out.append(child)
  return tuple(out)


def static_import_closure(modules: Iterable[str],
                          repo_root: Optional[str] = None) -> Set[str]:
  """Transitive closure of repo-local modules reachable from `modules`.

  Importing `a.b.c` also executes `a` and `a.b` package __init__s, so
  ancestors enter the closure (and their own imports are followed).
  """
  root = repo_root or _repo_root()
  seen: Set[str] = set()
  stack = list(modules)
  while stack:
    mod = stack.pop()
    if mod in seen:
      continue
    seen.add(mod)
    for anc in _ancestors(mod):
      if anc not in seen and module_file(anc, root) is not None:
        stack.append(anc)
    if module_file(mod, root) is None:
      continue  # external module: keep the name, don't walk into it
    for imp in module_imports(mod, root):
      if imp not in seen:
        stack.append(imp)
  return seen
