"""Gin-style dependency-injection configuration (the port's own copy).

The same engine as `tensor2robot_tpu.utils.config`, kept as a separate
copy so that the PyTorch port never imports the JAX package. It
provides the subset of gin the framework needs:

* `@configurable` decorator and `external_configurable` for third-party
  callables;
* config files / binding strings with `Name.param = value`,
  `scope/Name.param = value`, `@Name` / `@Name()` configurable references,
  `%MACRO` macros, `include 'other.gin'`, and `import a.b.c`;
* scoping via `with config_scope('train'): ...`;
* an operative-config dump recording every parameter actually used.

Bindings are resolved eagerly at call time: a configurable is an ordinary
Python callable once invoked.

The registry is this module's own, so port configs (`configs/*.gin`)
import port modules and bind port classes.
"""

from __future__ import annotations

import ast
import contextlib
import dataclasses
import functools
import importlib
import inspect
import os
import re
import threading
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

__all__ = [
    "configurable",
    "external_configurable",
    "bind",
    "parse_config",
    "parse_config_files_and_bindings",
    "config_scope",
    "clear_config",
    "operative_config_str",
    "query_parameter",
    "get_configurable",
    "REQUIRED",
    "ConfigError",
    "ConfigStatement",
    "iter_config_statements",
]


class ConfigError(Exception):
  pass


class _Required:
  """Sentinel for parameters that must be provided via config (gin.REQUIRED)."""

  def __repr__(self):
    return "REQUIRED"


REQUIRED = _Required()


class _ConfigurableReference:
  """`@Name` (pass the callable) or `@Name()` (call it at injection time).

  `location` ("path:line" of the config text that produced the reference)
  rides along so resolution errors point at the config file, not at the
  distant call site where injection happens.
  """

  def __init__(self, name: str, evaluate: bool,
               location: Optional[str] = None):
    self.name = name
    self.evaluate = evaluate
    self.location = location

  def resolve(self) -> Any:
    scope = ""
    name = self.name
    if "/" in name:
      scope, name = name.rsplit("/", 1)
    try:
      fn = get_configurable(name)
    except ConfigError as e:
      if self.location:
        raise ConfigError(f"{self.location}: {e}") from e
      raise
    if self.evaluate:
      with config_scope(scope):
        return fn()
    if scope:
      @functools.wraps(fn)
      def scoped(*args, **kwargs):
        with config_scope(scope):
          return fn(*args, **kwargs)

      return scoped
    return fn

  def __repr__(self):
    return f"@{self.name}" + ("()" if self.evaluate else "")

  def __eq__(self, other):
    return (isinstance(other, _ConfigurableReference)
            and (self.name, self.evaluate) == (other.name, other.evaluate))


class _MacroReference:
  def __init__(self, name: str, location: Optional[str] = None):
    self.name = name
    self.location = location

  def __repr__(self):
    return f"%{self.name}"

  def __eq__(self, other):
    return isinstance(other, _MacroReference) and self.name == other.name


class _Registry:
  def __init__(self):
    self.configurables: Dict[str, Callable] = {}
    # (scope, configurable_name, param) -> raw value
    self.bindings: Dict[Tuple[str, str, str], Any] = {}
    self.macros: Dict[str, Any] = {}
    self.operative: Dict[Tuple[str, str], Any] = {}
    self.imports: List[str] = []
    # (scope, configurable_name, param) -> "path:line" of the binding,
    # so call-time errors can point back at the config file.
    self.locations: Dict[Tuple[str, str, str], str] = {}


_REGISTRY = _Registry()
_SCOPE = threading.local()


def _scope_stack() -> List[str]:
  if not hasattr(_SCOPE, "stack"):
    _SCOPE.stack = []
  return _SCOPE.stack


@contextlib.contextmanager
def config_scope(name: str):
  """Activates a gin-style scope: bindings `name/Conf.param` take priority."""
  if not name:
    yield
    return
  _scope_stack().append(name)
  try:
    yield
  finally:
    _scope_stack().pop()


def clear_config() -> None:
  _REGISTRY.bindings.clear()
  _REGISTRY.macros.clear()
  _REGISTRY.operative.clear()
  _REGISTRY.locations.clear()
  _SCOPE.stack = []


def _binding_location(name: str, param: str) -> str:
  """' (bound at path:line)' suffix for error messages, if known.

  Prefers the binding that is actually active: innermost active scope
  first, then the unscoped binding, then any scope as a last resort (so
  a scoped config file is never blamed for another scope's binding).
  """
  candidates = [(scope, name, param)
                for scope in reversed(_scope_stack())]
  candidates.append(("", name, param))
  for key in candidates:
    location = _REGISTRY.locations.get(key)
    if location:
      return f" (bound at {location})"
  for (_, conf, p), location in _REGISTRY.locations.items():
    if conf == name and p == param and location:
      return f" (bound at {location})"
  return ""


def _register(name: str, wrapped: Callable, allow_override: bool = False):
  if name in _REGISTRY.configurables and not allow_override:
    existing = _REGISTRY.configurables[name]
    if getattr(existing, "__wrapped__", existing) is not getattr(
        wrapped, "__wrapped__", wrapped):
      raise ConfigError(f"Configurable {name!r} already registered.")
  _REGISTRY.configurables[name] = wrapped


def get_configurable(name: str) -> Callable:
  """Looks up a registered configurable, also matching by trailing path."""
  if name in _REGISTRY.configurables:
    return _REGISTRY.configurables[name]
  # Allow module-qualified lookups: 'pkg.mod.Name' matches registered 'Name'
  # and vice versa.
  short = name.rsplit(".", 1)[-1]
  if short in _REGISTRY.configurables:
    return _REGISTRY.configurables[short]
  matches = [k for k in _REGISTRY.configurables if k.rsplit(".", 1)[-1] == name]
  if len(matches) == 1:
    return _REGISTRY.configurables[matches[0]]
  raise ConfigError(
      f"No configurable named {name!r}. Registered: "
      f"{sorted(_REGISTRY.configurables)}")


def _resolve_value(value: Any) -> Any:
  if isinstance(value, _ConfigurableReference):
    return value.resolve()
  if isinstance(value, _MacroReference):
    if value.name not in _REGISTRY.macros:
      where = f"{value.location}: " if value.location else ""
      raise ConfigError(f"{where}Undefined macro %{value.name}")
    return _resolve_value(_REGISTRY.macros[value.name])
  if isinstance(value, list):
    return [_resolve_value(v) for v in value]
  if isinstance(value, tuple):
    return tuple(_resolve_value(v) for v in value)
  if isinstance(value, dict):
    return {k: _resolve_value(v) for k, v in value.items()}
  return value


def _lookup_bindings(name: str) -> Dict[str, Any]:
  """Collects bindings for `name` honoring the active scope stack.

  Unscoped bindings apply everywhere; scoped bindings apply when their scope
  is in the active stack, innermost scope winning.
  """
  out: Dict[str, Any] = {}
  for (scope, conf, param), value in _REGISTRY.bindings.items():
    if conf != name:
      continue
    if scope == "":
      out.setdefault(param, value)
  stack = _scope_stack()
  for active in stack:  # outermost → innermost so innermost wins
    for (scope, conf, param), value in _REGISTRY.bindings.items():
      if conf == name and scope == active:
        out[param] = value
  return out


def configurable(fn_or_name=None, *, name: Optional[str] = None,
                 denylist: Sequence[str] = ()):
  """Registers a function/class; config bindings are injected at call time."""

  def decorate(fn: Callable) -> Callable:
    if inspect.isclass(fn):
      return _decorate_class(fn, name or fn.__name__, denylist)
    reg_name = name or fn.__name__
    try:
      sig = inspect.signature(fn)
      has_var_kw = any(p.kind == inspect.Parameter.VAR_KEYWORD
                       for p in sig.parameters.values())
      param_names = set(sig.parameters)
    except (TypeError, ValueError):
      sig, has_var_kw, param_names = None, True, set()

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
      bindings = _lookup_bindings(reg_name)
      bound_positional = set()
      if sig is not None and args:
        for arg_name, _ in zip(sig.parameters, args):
          bound_positional.add(arg_name)
      injected = {}
      for param, raw in bindings.items():
        if param in denylist:
          raise ConfigError(
              f"Parameter {param!r} of {reg_name!r} may not be configured.")
        if not has_var_kw and param not in param_names:
          raise ConfigError(
              f"Configurable {reg_name!r} has no parameter {param!r}."
              f"{_binding_location(reg_name, param)}")
        if param in kwargs or param in bound_positional:
          continue  # explicit call-site args win over config
        injected[param] = _resolve_value(raw)
      merged = {**injected, **kwargs}
      for param, value in merged.items():
        if isinstance(value, _Required):
          raise ConfigError(
              f"Required parameter {reg_name}.{param} was not configured.")
      if sig is not None:
        try:
          bound = sig.bind(*args, **merged)
        except TypeError:
          bound = None
        if bound is not None:
          bound.apply_defaults()
          for param, value in bound.arguments.items():
            if isinstance(value, _Required):
              raise ConfigError(
                  f"Required parameter {reg_name}.{param} was not configured.")
      for param, value in merged.items():
        _REGISTRY.operative[(reg_name, param)] = value
      return fn(*args, **merged)

    wrapper.__wrapped__ = fn
    wrapper._configurable_name = reg_name
    _register(reg_name, wrapper)
    return wrapper

  if fn_or_name is None:
    return decorate
  if isinstance(fn_or_name, str):
    name = fn_or_name
    return decorate
  return decorate(fn_or_name)


def _decorate_class(cls: type, reg_name: str,
                    denylist: Sequence[str]) -> type:
  """Registers a class by wrapping its __init__ (classes stay classes so
  inheritance and isinstance keep working, as with gin)."""
  original_init = cls.__init__
  sig = inspect.signature(original_init)
  param_names = set(sig.parameters) - {"self"}
  has_var_kw = any(p.kind == inspect.Parameter.VAR_KEYWORD
                   for p in sig.parameters.values())

  @functools.wraps(original_init)
  def init_wrapper(self, *args, **kwargs):
    # Only inject when constructing exactly this class: a configurable
    # subclass handles its own injection and forwards via super().
    if type(self) is cls or not getattr(
        type(self), "_configurable_name", None):
      bindings = _lookup_bindings(reg_name)
      bound_positional = set()
      if args:
        non_self = [p for p in sig.parameters if p != "self"]
        for arg_name, _ in zip(non_self, args):
          bound_positional.add(arg_name)
      for param, raw in bindings.items():
        if param in denylist:
          raise ConfigError(
              f"Parameter {param!r} of {reg_name!r} may not be configured.")
        if not has_var_kw and param not in param_names:
          raise ConfigError(
              f"Configurable {reg_name!r} has no parameter {param!r}."
              f"{_binding_location(reg_name, param)}")
        if param in kwargs or param in bound_positional:
          continue
        kwargs[param] = _resolve_value(raw)
      for param, value in kwargs.items():
        if isinstance(value, _Required):
          raise ConfigError(
              f"Required parameter {reg_name}.{param} was not configured.")
        _REGISTRY.operative[(reg_name, param)] = value
    return original_init(self, *args, **kwargs)

  cls.__init__ = init_wrapper
  cls._configurable_name = reg_name
  _register(reg_name, cls)
  return cls


def external_configurable(fn: Callable, name: Optional[str] = None) -> Callable:
  """Registers a third-party callable (gin's `external_configurable`)."""
  return configurable(name=name or fn.__name__)(fn)


def bind(configurable_name: str, param: str, value: Any,
         scope: str = "", location: Optional[str] = None) -> None:
  key = (scope, configurable_name, param)
  _REGISTRY.bindings[key] = value
  if location:
    _REGISTRY.locations[key] = location


def macro(name: str, value: Any) -> None:
  _REGISTRY.macros[name] = value


def query_parameter(dotted: str) -> Any:
  """`query_parameter('Conf.param')` → currently bound (resolved) value."""
  scope, name, param = _parse_lhs(dotted)
  key = (scope, name, param)
  if key in _REGISTRY.bindings:
    return _resolve_value(_REGISTRY.bindings[key])
  raise ConfigError(f"No binding for {dotted!r}")


def query_parameter_or(dotted: str, default: Any = None) -> Any:
  """`query_parameter` that returns `default` instead of raising when
  the parameter is unbound — the graftforge enumeration reads a parsed
  research config this way (a config that does not bind a knob means
  the deployment uses the code default, not that enumeration fails).
  Returns the binding UNRESOLVED when resolution needs a registry the
  caller has not imported (a dangling @ref is still 'bound')."""
  try:
    return query_parameter(dotted)
  except ConfigError:
    pass
  scope, name, param = _parse_lhs(dotted)
  if (scope, name, param) in _REGISTRY.bindings:
    return _REGISTRY.bindings[(scope, name, param)]
  return default


def bound_configurables() -> set:
  """Names of every configurable with at least one active binding (any
  scope) — how graftforge decides which executable families a parsed
  research config deploys, without building anything."""
  return {conf for (_, conf, _) in _REGISTRY.bindings}


def raw_binding(dotted: str, default: Any = None) -> Any:
  """The UNRESOLVED binding for `Conf.param` (default when unbound).

  `@Name()` evaluated references resolve to a constructed INSTANCE —
  graftforge's enumeration must read the reference's name without
  building a model at plan time, so it reads the raw binding
  (`_ConfigurableReference.name`) instead of `query_parameter`."""
  scope, name, param = _parse_lhs(dotted)
  return _REGISTRY.bindings.get((scope, name, param), default)


# ---------------------------------------------------------------------------
# Parser
# ---------------------------------------------------------------------------

_LHS_RE = re.compile(
    r"^(?:(?P<scope>[\w./]+)/)?(?P<name>[\w.]+)\.(?P<param>\w+)$")


def _parse_lhs(lhs: str) -> Tuple[str, str, str]:
  m = _LHS_RE.match(lhs.strip())
  if not m:
    raise ConfigError(f"Cannot parse binding target {lhs!r}")
  return m.group("scope") or "", m.group("name"), m.group("param")


class _ValueTransformer(ast.NodeTransformer):
  """Rewrites @ref / %macro placeholders back out of a parsed literal."""


def _parse_value(text: str, location: Optional[str] = None) -> Any:
  """Parses a gin RHS: python literal with @references and %macros."""
  text = text.strip()
  # Tokenize @references and %macros into placeholder strings, parse the
  # literal, then substitute back.
  placeholders: Dict[str, Any] = {}

  def _sub_ref(m: re.Match) -> str:
    key = f"__t2r_ref_{len(placeholders)}__"
    name = m.group("name")
    evaluate = m.group("call") is not None
    placeholders[key] = _ConfigurableReference(name, evaluate,
                                               location=location)
    return repr(key)

  def _sub_macro(m: re.Match) -> str:
    key = f"__t2r_macro_{len(placeholders)}__"
    placeholders[key] = _MacroReference(m.group("name"), location=location)
    return repr(key)

  substituted = re.sub(
      r"@(?P<name>[\w./]+)(?P<call>\(\))?", _sub_ref, text)
  substituted = re.sub(r"%(?P<name>[\w.]+)", _sub_macro, substituted)
  try:
    value = ast.literal_eval(substituted)
  except (ValueError, SyntaxError) as e:
    raise ConfigError(f"Cannot parse config value {text!r}: {e}") from e

  def _restore(obj: Any) -> Any:
    if isinstance(obj, str) and obj in placeholders:
      return placeholders[obj]
    if isinstance(obj, list):
      return [_restore(v) for v in obj]
    if isinstance(obj, tuple):
      return tuple(_restore(v) for v in obj)
    if isinstance(obj, dict):
      return {_restore(k): _restore(v) for k, v in obj.items()}
    return obj

  return _restore(value)


def _strip_comment(line: str) -> Tuple[str, str]:
  """(line with any unquoted `#`-comment removed, same with string
  contents masked to spaces). `#` and brackets inside quoted strings are
  data, not syntax — the mask lets callers count brackets safely."""
  out = []
  masked = []
  quote = None
  i = 0
  while i < len(line):
    ch = line[i]
    if quote:
      if ch == "\\" and i + 1 < len(line):
        out.append(line[i:i + 2])
        masked.append("  ")
        i += 2
        continue
      out.append(ch)
      if ch == quote:
        masked.append(ch)
        quote = None
      else:
        masked.append(" ")
    elif ch in "'\"":
      quote = ch
      out.append(ch)
      masked.append(ch)
    elif ch == "#":
      break
    else:
      out.append(ch)
      masked.append(ch)
    i += 1
  return "".join(out), "".join(masked)


def _logical_lines(text: str):
  """Yields (start_lineno, end_lineno, logical_line), joining bracket
  continuations. Comment stripping and bracket counting are
  quote-aware: `#`, `(`, `[` … inside string values are data."""
  buffer = ""
  masked_buffer = ""
  depth = 0
  start = end = 0
  for lineno, raw_line in enumerate(text.splitlines(), start=1):
    line, masked = _strip_comment(raw_line)
    line, masked = line.rstrip(), masked.rstrip()
    if not line.strip() and depth == 0:
      continue
    if not buffer:
      start = lineno
    end = lineno
    buffer = (buffer + " " + line.strip()) if buffer else line.strip()
    masked_buffer = ((masked_buffer + " " + masked.strip())
                     if masked_buffer else masked.strip())
    depth = (masked_buffer.count("(") - masked_buffer.count(")")
             + masked_buffer.count("[") - masked_buffer.count("]")
             + masked_buffer.count("{") - masked_buffer.count("}"))
    if depth <= 0 and buffer and not masked_buffer.endswith(("=", ",")):
      yield start, end, buffer
      buffer = ""
      masked_buffer = ""
      depth = 0
  if buffer.strip():
    yield start, end, buffer


@dataclasses.dataclass
class ConfigStatement:
  """One parsed logical config line, nothing executed.

  The no-execute face of the parser: `iter_config_statements` yields these
  without importing modules, following includes, or touching the registry —
  the hook a static analyzer builds on.
  `kind` is one of 'import' | 'include' | 'binding' | 'macro'; for bindings
  `value` still holds unresolved `_ConfigurableReference`/`_MacroReference`
  placeholders.
  """

  kind: str
  line: int
  path: Optional[str] = None
  end_line: int = 0         # last physical line (continuations); 0 = line
  module: str = ""          # kind == 'import'
  include_target: str = ""  # kind == 'include' (base_dir-resolved path)
  scope: str = ""           # kind == 'binding'
  name: str = ""            # binding configurable name / macro name
  param: str = ""           # kind == 'binding'
  value: Any = None         # kind in ('binding', 'macro')

  def __post_init__(self):
    if not self.end_line:
      self.end_line = self.line

  @property
  def location(self) -> str:
    return f"{self.path or '<config string>'}:{self.line}"


def iter_config_statements(text: str,
                           path: Optional[str] = None,
                           base_dir: Optional[str] = None):
  """Parses config text into `ConfigStatement`s WITHOUT executing anything.

  No module imports, no include recursion (the include target path is
  resolved against `base_dir` but not opened), no registry mutation. Parse
  errors raise ConfigError prefixed with `path:line`.
  """
  if base_dir is None and path is not None:
    base_dir = os.path.dirname(path)
  for lineno, end_line, line in _logical_lines(text):
    location = f"{path or '<config string>'}:{lineno}"
    if line.startswith("import "):
      yield ConfigStatement(kind="import", line=lineno, end_line=end_line,
                            path=path,
                            module=line[len("import "):].strip())
      continue
    if line.startswith("include "):
      target = line[len("include "):].strip().strip("'\"")
      resolved = target
      if base_dir and not os.path.isabs(target):
        resolved = os.path.join(base_dir, target)
      yield ConfigStatement(kind="include", line=lineno, end_line=end_line,
                            path=path, include_target=resolved)
      continue
    if "=" not in line:
      raise ConfigError(f"{location}: Cannot parse config line: {line!r}")
    lhs, rhs = line.split("=", 1)
    lhs = lhs.strip()
    try:
      value = _parse_value(rhs, location=location)
    except ConfigError as e:
      raise ConfigError(f"{location}: {e}") from e
    if re.match(r"^[A-Z_][A-Z0-9_]*$", lhs) or "." not in lhs:
      # MACRO = value (gin allows lowercase macros too)
      yield ConfigStatement(kind="macro", line=lineno, end_line=end_line,
                            path=path, name=lhs, value=value)
      continue
    try:
      scope, name, param = _parse_lhs(lhs)
    except ConfigError as e:
      raise ConfigError(f"{location}: {e}") from e
    yield ConfigStatement(kind="binding", line=lineno, end_line=end_line,
                          path=path, scope=scope, name=name, param=param,
                          value=value)


def parse_config(text: str, base_dir: Optional[str] = None,
                 path: Optional[str] = None) -> None:
  """Parses config text: bindings, macros, imports, includes."""
  for st in iter_config_statements(text, path=path, base_dir=base_dir):
    if st.kind == "import":
      _REGISTRY.imports.append(st.module)
      try:
        importlib.import_module(st.module)
      except Exception as e:
        # Any import-time failure (ImportError, a module's own
        # RuntimeError, ...) gets the config location — these are the
        # errors most likely on a fresh machine.
        raise ConfigError(
            f"{st.location}: cannot import {st.module!r}: "
            f"{type(e).__name__}: {e}") from e
    elif st.kind == "include":
      parse_config_file(st.include_target)
    elif st.kind == "macro":
      macro(st.name, st.value)
    else:
      bind(st.name, st.param, st.value, scope=st.scope,
           location=st.location if path else None)


def parse_config_file(path: str) -> None:
  with open(path) as f:
    parse_config(f.read(), base_dir=os.path.dirname(path), path=path)


def parse_config_files_and_bindings(
    config_files: Optional[Sequence[str]] = None,
    bindings: Optional[Sequence[str]] = None) -> None:
  """The CLI entry used by trainer binaries (reference
  bin/run_t2r_trainer.py:29)."""
  for path in config_files or []:
    parse_config_file(path)
  for binding in bindings or []:
    parse_config(binding)


def operative_config_str() -> str:
  """Every parameter value actually used by invoked configurables, as
  re-parseable config text (reference operative-config persistence).
  Values with no config syntax (live objects) are emitted as comments, as
  gin does, so the file always re-parses."""
  lines = []
  # A copy (one C-level call) so an export worker reading it never races
  # a configurable called on another thread.
  for (name, param), value in sorted(_REGISTRY.operative.copy().items()):
    if _is_representable(value):
      lines.append(f"{name}.{param} = {_format_value(value)}")
    else:
      lines.append(f"# {name}.{param} = {value!r}  (not representable)")
  return "\n".join(lines) + ("\n" if lines else "")


def _is_representable(value: Any) -> bool:
  if isinstance(value, (_ConfigurableReference, _MacroReference, str, int,
                        float, bool, type(None))):
    return True
  if callable(value) and hasattr(value, "_configurable_name"):
    return True
  if isinstance(value, (list, tuple)):
    return all(_is_representable(v) for v in value)
  if isinstance(value, dict):
    return all(_is_representable(k) and _is_representable(v)
               for k, v in value.items())
  return False


def _format_value(value: Any) -> str:
  if isinstance(value, (_ConfigurableReference, _MacroReference)):
    return repr(value)
  if callable(value) and hasattr(value, "_configurable_name"):
    return f"@{value._configurable_name}"
  if isinstance(value, (list, tuple)):
    inner = ", ".join(_format_value(v) for v in value)
    if isinstance(value, list):
      return f"[{inner}]"
    # 1-tuples need the trailing comma or they re-parse as a bare value.
    return f"({inner},)" if len(value) == 1 else f"({inner})"
  if isinstance(value, dict):
    inner = ", ".join(f"{_format_value(k)}: {_format_value(v)}"
                      for k, v in value.items())
    return "{" + inner + "}"
  return repr(value)
