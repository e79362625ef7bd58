"""Spec/sharding checker: TensorSpec sharding axes vs declared mesh axes.

`TensorSpec.sharding` names mesh axes positionally over the spec's own
shape (specs.py); the mesh axis vocabulary is declared by configs
(`train_eval_model.mesh_axis_names` / `create_mesh.axis_names`) on top of
`parallel.mesh.DEFAULT_AXES`. A sharding annotation naming an axis no
mesh declares runs fine on a 1-axis test mesh and then fails (or silently
replicates) on the real topology — exactly the class of bug that should
be caught before any device is touched. The port of the JAX package's
`analysis.spec_check`, over the port's `specs.TensorSpec` sharding and
the mesh axis names in the port's configs (on top of
`parallel.mesh.DEFAULT_AXES`).

Two faces:

* static — AST scan of `TensorSpec(...)` call sites with literal
  `sharding=` tuples (the CLI path; no imports, no execution);
* structural — `check_spec_structures(feature_spec, label_spec, ...)`
  over live SpecStructs via `specs.sharding_axes` (used by tests and by
  model authors at build time).

Rules:

* `unknown-mesh-axis`       — sharding names an axis no mesh declares;
* `duplicate-sharding-axis` — the same axis twice in one annotation
                              (rejected by a PartitionSpec);
* `sharding-rank-mismatch`  — more sharding entries than the spec has
                              dims;
* `sharding-conflict`       — the same flat key carries different
                              shardings in feature vs label specs.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Sequence, Set, Tuple

from tensor2robot_tpu_torch.analysis import engine as engine_lib
from tensor2robot_tpu_torch.analysis.findings import (Finding, filter_findings,
                                                load_suppressions)

__all__ = ["known_mesh_axes", "check_python_source", "check_python_file",
           "check_spec_structures"]


def known_mesh_axes(config_paths: Sequence[str] = ()) -> Set[str]:
  """DEFAULT_AXES plus every axis name declared by the given configs."""
  from tensor2robot_tpu_torch.analysis import config_check
  from tensor2robot_tpu_torch.parallel import mesh

  axes = set(mesh.DEFAULT_AXES)
  axes.update(config_check.collect_mesh_axis_names(config_paths))
  return axes


def _literal(node: ast.AST):
  try:
    return ast.literal_eval(node)
  except (ValueError, SyntaxError):
    return None


def _is_tensorspec_call(node: ast.Call) -> bool:
  func = node.func
  if isinstance(func, ast.Name):
    return func.id == "TensorSpec"
  if isinstance(func, ast.Attribute):
    return func.attr == "TensorSpec"
  return False


def _check_axes(axes: Tuple, rank: Optional[int], mesh_axes: Set[str],
                path: str, line: int, where: str,
                end_line: int = 0) -> List[Finding]:
  findings: List[Finding] = []
  named = [a for a in axes if a is not None]
  for axis in named:
    if not isinstance(axis, str):
      findings.append(Finding(
          path, line, "unknown-mesh-axis",
          f"{where}: sharding entry {axis!r} is not a mesh axis name "
          "(expected str or None)", end_line=end_line))
    elif axis not in mesh_axes:
      findings.append(Finding(
          path, line, "unknown-mesh-axis",
          f"{where}: sharding axis {axis!r} names no declared mesh "
          f"dimension (known axes: {sorted(mesh_axes)})",
          end_line=end_line))
  dupes = {a for a in named if named.count(a) > 1}
  for axis in sorted(str(d) for d in dupes):
    findings.append(Finding(
        path, line, "duplicate-sharding-axis",
        f"{where}: axis {axis!r} appears more than once in one sharding "
        "annotation (PartitionSpec forbids reuse)", end_line=end_line))
  if rank is not None and len(axes) > rank:
    findings.append(Finding(
        path, line, "sharding-rank-mismatch",
        f"{where}: sharding has {len(axes)} entries for a rank-{rank} "
        "spec (sharding is positional over the spec's own shape)",
        end_line=end_line))
  return findings


def _check_tensorspec_call(path: str, node: ast.Call,
                           mesh_axes: Set[str]) -> List[Finding]:
  """Findings for one TensorSpec(...) Call node (shared by the
  standalone parse path and the engine's single-walk dispatch)."""
  if not _is_tensorspec_call(node):
    return []
  sharding_node = shape_node = None
  for kw in node.keywords:
    if kw.arg == "sharding":
      sharding_node = kw.value
    elif kw.arg == "shape":
      shape_node = kw.value
  if shape_node is None and node.args:
    shape_node = node.args[0]
  if sharding_node is None:
    return []
  sharding = _literal(sharding_node)
  if not isinstance(sharding, (list, tuple)):
    return []  # computed sharding: out of static reach
  shape = _literal(shape_node) if shape_node is not None else None
  rank = len(shape) if isinstance(shape, (list, tuple)) else None
  return _check_axes(
      tuple(sharding), rank, mesh_axes, path, node.lineno, "TensorSpec",
      end_line=getattr(node, "end_lineno", 0) or 0)


def check_python_source(text: str, path: str,
                        mesh_axes: Optional[Set[str]] = None
                        ) -> List[Finding]:
  """Statically audits literal `TensorSpec(..., sharding=...)` calls."""
  mesh_axes = mesh_axes if mesh_axes is not None else known_mesh_axes()
  try:
    tree = ast.parse(text, filename=path)
  except SyntaxError:
    return []  # the engine owns the parse-error finding
  findings: List[Finding] = []
  for node in ast.walk(tree):
    if isinstance(node, ast.Call):
      findings.extend(_check_tensorspec_call(path, node, mesh_axes))
  return sorted(filter_findings(findings, load_suppressions(text)),
                key=lambda f: (f.line, f.rule))


def check_python_file(path: str,
                      mesh_axes: Optional[Set[str]] = None
                      ) -> List[Finding]:
  with open(path) as f:
    return check_python_source(f.read(), path, mesh_axes)


def check_spec_structures(feature_spec,
                          label_spec=None,
                          mesh_axes: Optional[Set[str]] = None,
                          origin: str = "<specs>") -> List[Finding]:
  """Audits live spec structures (model feature/label specs).

  Reports unknown/duplicate axes per leaf plus `sharding-conflict`: a
  flat key annotated differently in the feature and label structures —
  the two would commit contradictory layouts for what the data layer
  treats as one logical stream.
  """
  from tensor2robot_tpu_torch import specs as specs_lib

  mesh_axes = mesh_axes if mesh_axes is not None else known_mesh_axes()
  findings: List[Finding] = []
  by_key: Dict[str, Tuple] = {}
  for struct_name, struct in (("feature_spec", feature_spec),
                              ("label_spec", label_spec)):
    if struct is None:
      continue
    axes_map = specs_lib.sharding_axes(struct)
    specs_flat = specs_lib.flatten_spec_structure(struct)
    for key, sharding in axes_map.items():
      rank = len(specs_flat[key].shape)
      findings.extend(_check_axes(sharding, rank, mesh_axes, origin, 0,
                                  f"{struct_name}[{key!r}]"))
      if key in by_key and by_key[key] != sharding:
        findings.append(Finding(
            origin, 0, "sharding-conflict",
            f"key {key!r} is sharded {by_key[key]!r} in feature_spec "
            f"but {sharding!r} in label_spec"))
      by_key.setdefault(key, sharding)
  return findings


engine_lib.register(engine_lib.Rule(
    name="spec", kind="py", scope=".py", family="spec",
    infos=(
        engine_lib.RuleInfo(
            id="unknown-mesh-axis",
            doc="TensorSpec.sharding names an undeclared axis",
            meaning=("`TensorSpec.sharding` names an axis no mesh "
                     "declares")),
        engine_lib.RuleInfo(
            id="duplicate-sharding-axis",
            doc="same axis twice in one annotation",
            meaning=("same axis twice in one annotation (PartitionSpec "
                     "forbids)")),
        engine_lib.RuleInfo(
            id="sharding-rank-mismatch",
            doc="more sharding entries than spec dims",
            meaning="more sharding entries than spec dims"),
        engine_lib.RuleInfo(
            id="sharding-conflict",
            doc=("feature vs label sharding disagreement\n"
                 "(structure-level API only)"),
            meaning=("feature vs label sharding disagreement "
                     "(structure-level API)")),
    ),
    visitors={ast.Call: lambda ctx, node: _check_tensorspec_call(
        ctx.path, node, ctx.mesh_axes)}))
