"""Static checker for `.gin` experiment configs.

A per-binding static check of every config: every `Name.param` binding and `@Name` reference
in every config must resolve against the configurable registry *and* be
covered by the config's own `import` lines (plus what the entry binaries
import), so a config can never depend on test-process import pollution.

Rules (rule ids):

* `broken-import`        — an `import a.b.c` line that does not import;
* `unknown-configurable` — a `Name.param` binding or `@Name` reference
                           whose Name is not a registered configurable;
* `missing-import`       — Name resolves, but no import line (nor the
                           entry binaries) pulls in its defining module
                           in a fresh process (static import closure);
* `unknown-parameter`    — Name has no parameter `param`
                           (inspect.signature, honoring **kwargs);
* `duplicate-binding`    — the same (scope, Name, param) bound twice in
                           one config (the later silently shadows);
* `undefined-macro`      — `%MACRO` referenced but never defined;
* `type-mismatch`        — a literal value whose type contradicts the
                           parameter's annotation (or default's type);
* `parse-error`          — the file does not parse at all.

Resolution imports the modules named by the config (registering their
configurables, against the port's own registry `utils.config`) but NEVER
creates a CUDA context — module import-time purity is itself enforced
by `tracer_check`'s `import-time-backend`. The port of the JAX package's
`analysis.config_check`, over `tensor2robot_tpu_torch/configs/*.gin`.
"""

from __future__ import annotations

import collections.abc
import functools
import importlib
import inspect
import os
import typing
from typing import Any, Dict, List, Optional, Sequence, Set, Tuple

from tensor2robot_tpu_torch.analysis import imports_graph
from tensor2robot_tpu_torch.analysis.findings import (Finding, filter_findings,
                                                load_suppressions)
from tensor2robot_tpu_torch.utils import config

__all__ = ["check_config_file", "ENTRY_MODULES", "collect_mesh_axis_names"]

# What a fresh trainer/actor process imports before parsing any config:
# these modules' static import closures are always "covered" (the
# fresh-process smoke test launches exactly these binaries).
ENTRY_MODULES = (
    "tensor2robot_tpu_torch.bin.run_t2r_trainer",
    "tensor2robot_tpu_torch.bin.run_collect_eval",
    "tensor2robot_tpu_torch.bin.run_meta_collect_eval",
)

# Runtime twins of ENTRY_MODULES for registry population (the JAX
# package's layout: import what the entry binaries import).
_ENTRY_RUNTIME_IMPORTS = (
    "tensor2robot_tpu_torch.train_eval",
    "tensor2robot_tpu_torch.envs.run_env",
    "tensor2robot_tpu_torch.envs.run_meta_env",
)


_entry_runtime_imported = False


def _import_entry_runtime() -> None:
  global _entry_runtime_imported
  if _entry_runtime_imported:
    return
  _entry_runtime_imported = True
  for mod in _ENTRY_RUNTIME_IMPORTS:
    try:
      importlib.import_module(mod)
    except ImportError:
      pass  # reported per-config via the registry checks if it matters


@functools.lru_cache(maxsize=None)
def _entry_closure(repo_root: Optional[str]) -> frozenset:
  return frozenset(imports_graph.static_import_closure(
      ENTRY_MODULES, repo_root=repo_root))


def _collect_statements(path: str,
                        seen: Optional[Set[str]] = None,
                        texts: Optional[Dict[str, str]] = None
                        ) -> Tuple[List[config.ConfigStatement],
                                   List[Finding], Dict[str, str]]:
  """All statements of `path` with includes followed (cycle-safe).

  Also returns each visited file's text (path -> source) so callers can
  apply suppressions without re-reading from disk.
  """
  seen = seen if seen is not None else set()
  texts = texts if texts is not None else {}
  real = os.path.realpath(path)
  if real in seen:
    return [], [], texts
  seen.add(real)
  findings: List[Finding] = []
  statements: List[config.ConfigStatement] = []
  try:
    with open(path) as f:
      text = f.read()
  except OSError as e:
    return [], [Finding(path, 0, "parse-error", str(e))], texts
  texts[path] = text
  try:
    parsed = list(config.iter_config_statements(text, path=path))
  except config.ConfigError as e:
    return [], [Finding(path, 0, "parse-error", str(e))], texts
  for st in parsed:
    if st.kind == "include":
      if not os.path.isfile(st.include_target):
        findings.append(Finding(path, st.line, "broken-import",
                                f"include target {st.include_target!r} "
                                "does not exist", end_line=st.end_line))
        continue
      sub_statements, sub_findings, _ = _collect_statements(
          st.include_target, seen, texts)
      statements.extend(sub_statements)
      findings.extend(sub_findings)
    else:
      statements.append(st)
  return statements, findings, texts


def _walk_placeholders(value: Any):
  """Yields every _ConfigurableReference / _MacroReference inside value."""
  if isinstance(value, (config._ConfigurableReference,
                        config._MacroReference)):
    yield value
  elif isinstance(value, (list, tuple)):
    for v in value:
      yield from _walk_placeholders(v)
  elif isinstance(value, dict):
    for k, v in value.items():
      yield from _walk_placeholders(k)
      yield from _walk_placeholders(v)


def _resolve_configurable(name: str):
  """Registry lookup with gin's scope / trailing-path conventions."""
  if "/" in name:
    name = name.rsplit("/", 1)[-1]
  return config.get_configurable(name)


def _defining_module(fn) -> Optional[str]:
  target = fn if inspect.isclass(fn) else getattr(fn, "__wrapped__", fn)
  return getattr(target, "__module__", None)


def _signature_of(fn) -> Optional[inspect.Signature]:
  target = fn.__init__ if inspect.isclass(fn) else fn
  try:
    return inspect.signature(target)
  except (TypeError, ValueError):
    return None


_SIMPLE_TYPES: Dict[Any, Tuple[type, ...]] = {
    bool: (bool,),
    int: (int,),
    float: (int, float),
    str: (str,),
}


def _types_from_annotation(annotation) -> Optional[Tuple[type, ...]]:
  """Acceptable literal types for an annotation; None = don't check."""
  if annotation in _SIMPLE_TYPES:
    return _SIMPLE_TYPES[annotation]
  origin = typing.get_origin(annotation)
  if origin is typing.Union:
    out: Tuple[type, ...] = ()
    for arg in typing.get_args(annotation):
      if arg is type(None):
        out += (type(None),)
        continue
      sub = _types_from_annotation(arg)
      if sub is None:
        return None  # a member we can't check -> don't check the union
      out += sub
    return out
  if origin in (list, tuple, collections.abc.Sequence):
    return (list, tuple)
  if origin in (dict, collections.abc.Mapping,
                collections.abc.MutableMapping):
    return (dict,)
  return None


def _types_from_default(default) -> Optional[Tuple[type, ...]]:
  if default is inspect.Parameter.empty or default is None:
    return None
  if isinstance(default, config._Required):
    return None
  for py_type, accepted in _SIMPLE_TYPES.items():
    if type(default) is py_type:
      return accepted
  if isinstance(default, (list, tuple)):
    return (list, tuple)
  if isinstance(default, dict):
    return (dict,)
  return None


def _type_mismatch(fn, param: str, value: Any) -> Optional[str]:
  """Message if `value`'s literal type contradicts the parameter, else
  None. Conservative: only flags when both sides are confidently known."""
  for _ in _walk_placeholders(value):
    return None  # @refs / %macros resolve to arbitrary types
  sig = _signature_of(fn)
  if sig is None or param not in sig.parameters:
    return None
  parameter = sig.parameters[param]
  expected: Optional[Tuple[type, ...]] = None
  annotation = parameter.annotation
  if annotation is not inspect.Parameter.empty:
    if isinstance(annotation, str):
      # `from __future__ import annotations` modules: resolve lazily.
      target = fn.__init__ if inspect.isclass(fn) else \
          getattr(fn, "__wrapped__", fn)
      try:
        hints = typing.get_type_hints(target)
        annotation = hints.get(param, inspect.Parameter.empty)
      except Exception:
        annotation = inspect.Parameter.empty
    if annotation is not inspect.Parameter.empty:
      expected = _types_from_annotation(annotation)
  if expected is None:
    expected = _types_from_default(parameter.default)
  if expected is None:
    return None
  if value is None:
    # None is conventional "unset" for configs; only annotations that
    # explicitly include NoneType were checked above.
    if type(None) in expected or parameter.default is None:
      return None
    return (f"literal None but parameter expects "
            f"{'/'.join(t.__name__ for t in expected)}")
  if bool not in expected and isinstance(value, bool):
    return (f"literal bool {value!r} but parameter expects "
            f"{'/'.join(t.__name__ for t in expected)}")
  if isinstance(value, expected):
    return None
  return (f"literal {type(value).__name__} {value!r} but parameter "
          f"expects {'/'.join(t.__name__ for t in expected)}")


def check_config_file(path: str,
                      repo_root: Optional[str] = None) -> List[Finding]:
  """Statically checks one config file; returns (suppression-filtered)
  findings."""
  _import_entry_runtime()
  statements, findings, texts = _collect_statements(path)

  import_lines = [st for st in statements if st.kind == "import"]
  for st in import_lines:
    try:
      importlib.import_module(st.module)
    except Exception as e:  # noqa: BLE001 - any import failure is the finding
      findings.append(Finding(st.path or path, st.line, "broken-import",
                              f"cannot import {st.module!r}: "
                              f"{type(e).__name__}: {e}",
                              end_line=st.end_line))

  covered = imports_graph.static_import_closure(
      [st.module for st in import_lines], repo_root=repo_root)
  covered |= _entry_closure(repo_root)
  defined_macros = {st.name for st in statements if st.kind == "macro"}

  def _check_reference(st: config.ConfigStatement, name: str,
                       what: str) -> Optional[Any]:
    """Shared resolve + import-coverage check; returns the configurable."""
    try:
      fn = _resolve_configurable(name)
    except config.ConfigError:
      findings.append(Finding(
          st.path or path, st.line, "unknown-configurable",
          f"{what} {name!r} does not resolve to a registered "
          "configurable (is its module imported by this config?)",
          end_line=st.end_line))
      return None
    module = _defining_module(fn)
    if (module and module not in covered
        and imports_graph.module_file(module, repo_root) is not None):
      findings.append(Finding(
          st.path or path, st.line, "missing-import",
          f"{what} {name!r} is defined in {module} which no `import` "
          "line of this config (nor the entry binaries) pulls in — a "
          "fresh process would fail to resolve it",
          end_line=st.end_line))
    return fn

  def _check_value_placeholders(st: config.ConfigStatement) -> None:
    """@refs / %macros are checked wherever they appear — binding RHS
    AND macro definition values (a bad reference hidden behind a macro
    fails at resolve time all the same)."""
    for placeholder in _walk_placeholders(st.value):
      if isinstance(placeholder, config._MacroReference):
        if placeholder.name not in defined_macros:
          findings.append(Finding(
              st.path or path, st.line, "undefined-macro",
              f"%{placeholder.name} is never defined in this config",
              end_line=st.end_line))
      else:
        _check_reference(st, placeholder.name,
                         f"reference @{placeholder.name}")

  seen_bindings: Dict[Tuple[str, str, str], config.ConfigStatement] = {}
  for st in statements:
    if st.kind == "macro":
      key = ("%", st.name, "")
      if key in seen_bindings and seen_bindings[key].path == st.path:
        first = seen_bindings[key]
        findings.append(Finding(
            st.path or path, st.line, "duplicate-binding",
            f"macro {st.name!r} already defined at "
            f"{first.location} (this one shadows it)",
            end_line=st.end_line))
      seen_bindings[key] = st
      _check_value_placeholders(st)
    if st.kind != "binding":
      continue
    key = (st.scope, st.name, st.param)
    if key in seen_bindings:
      first = seen_bindings[key]
      # Same-file rebinds only: overriding an included file's binding is
      # gin's standard include-then-override idiom (later bind wins by
      # design); rebinding within one file is a genuine mistake.
      if first.path == st.path:
        scope_str = f"{st.scope}/" if st.scope else ""
        findings.append(Finding(
            st.path or path, st.line, "duplicate-binding",
            f"{scope_str}{st.name}.{st.param} already bound at "
            f"{first.location} (this one shadows it)",
            end_line=st.end_line))
    seen_bindings[key] = st

    fn = _check_reference(st, st.name, "binding target")
    if fn is not None:
      sig = _signature_of(fn)
      if sig is not None:
        params = set(sig.parameters) - {"self"}
        has_var_kw = any(p.kind == inspect.Parameter.VAR_KEYWORD
                         for p in sig.parameters.values())
        if not has_var_kw and st.param not in params:
          findings.append(Finding(
              st.path or path, st.line, "unknown-parameter",
              f"{st.name!r} has no parameter {st.param!r} "
              f"(parameters: {sorted(params)})", end_line=st.end_line))
        else:
          mismatch = _type_mismatch(fn, st.param, st.value)
          if mismatch:
            findings.append(Finding(st.path or path, st.line,
                                    "type-mismatch",
                                    f"{st.name}.{st.param}: {mismatch}",
                                    end_line=st.end_line))

    _check_value_placeholders(st)

  # Suppressions are per-file: group findings by path and filter each
  # against that file's own `# graftlint: disable=` comments (using the
  # source text already read by _collect_statements).
  out: List[Finding] = []
  by_path: Dict[str, List[Finding]] = {}
  for f in findings:
    by_path.setdefault(f.path, []).append(f)
  for file_path, file_findings in by_path.items():
    text = texts.get(file_path)
    if text is None:
      out.extend(file_findings)
      continue
    out.extend(filter_findings(file_findings, load_suppressions(text)))
  return sorted(out, key=lambda f: (f.path, f.line, f.rule))


def collect_mesh_axis_names(config_paths: Sequence[str]) -> Set[str]:
  """Mesh axis names declared across configs (`mesh_axis_names` /
  `axis_names` tuple bindings) — the vocabulary the spec checker
  validates TensorSpec.sharding annotations against."""
  axes: Set[str] = set()
  for path in config_paths:
    # Unparseable configs contribute no statements (_collect_statements
    # returns the failure as a parse-error finding, never raises).
    statements, _, _ = _collect_statements(path)
    for st in statements:
      if st.kind != "binding":
        continue
      if st.param not in ("mesh_axis_names", "axis_names"):
        continue
      if isinstance(st.value, (list, tuple)):
        axes.update(v for v in st.value if isinstance(v, str))
  return axes


from tensor2robot_tpu_torch.analysis import engine as engine_lib

engine_lib.register(engine_lib.Rule(
    name="config", kind="gin", scope=".gin", family="config",
    infos=(
        engine_lib.RuleInfo(
            id="parse-error",
            doc="file does not parse",
            meaning="file does not parse"),
        engine_lib.RuleInfo(
            id="broken-import",
            doc="an `import a.b.c` line fails to import",
            meaning="an `import a.b.c` line fails to import"),
        engine_lib.RuleInfo(
            id="unknown-configurable",
            doc="Name.param / @Name resolves to no configurable",
            meaning=("`Name.param` / `@Name` resolves to no "
                     "configurable")),
        engine_lib.RuleInfo(
            id="missing-import",
            doc=("Name resolves, but only via import pollution —\n"
                 "no import line (nor entry binary) covers its\n"
                 "defining module in a fresh process"),
            meaning=("resolves only via import pollution; a fresh "
                     "process would fail")),
        engine_lib.RuleInfo(
            id="unknown-parameter",
            doc="Name has no parameter `param`",
            meaning=("`Name` has no parameter `param` (honors "
                     "`**kwargs`)")),
        engine_lib.RuleInfo(
            id="duplicate-binding",
            doc=("same (scope, Name, param) bound twice in one\n"
                 "file (include-then-override is idiomatic)"),
            meaning=("same (scope, Name, param) bound twice in one "
                     "file; later shadows (include-then-override across "
                     "files is idiomatic and not flagged)")),
        engine_lib.RuleInfo(
            id="undefined-macro",
            doc="%MACRO referenced but never defined",
            meaning="`%MACRO` referenced but never defined"),
        engine_lib.RuleInfo(
            id="type-mismatch",
            doc="literal value contradicts annotation/default",
            meaning=("literal value contradicts the parameter's "
                     "annotation/default")),
    ),
    # Self-filtered (config_check applies each file's own suppressions,
    # including across includes — the engine adds nothing on top).
    check=lambda ctx: check_config_file(ctx.path)))
