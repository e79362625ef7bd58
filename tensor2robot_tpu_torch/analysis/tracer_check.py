"""AST lint for CUDA-context and compile-tracing hazards in Python sources.

The port of the JAX package's `analysis.tracer_check`, with each rule's
torch subject:

* `import-time-backend` — a call at module import level that creates a
  CUDA context: `torch.cuda.current_device` / `set_device` /
  `synchronize` / `get_device_properties` / `get_device_name` /
  `get_device_capability` / `mem_get_info` / `init` / `current_stream` /
  `default_stream` / `Stream`, a tensor factory (any call) given a
  CUDA `device=`, or `.to(<cuda>)` / `.cuda()`. Importing such a module
  creates the context as a side effect of `import`, and the port forks
  workers from processes that import it (the forge's and the audit's
  workers, the mesh's ranks): a context made before a fork is unusable
  in the child. Module/class-level statements, function default
  arguments and decorator expressions count; `if __name__ == "__main__"`
  blocks do not. `torch.cuda.is_available()` and `device_count()` make
  no context and are not flagged.
* `host-sync-in-jit`    — `.item()`, `.tolist()`, `.cpu()` or
  `.numpy()`, or `float()`/`int()`/`bool()`/`np.asarray()`/`np.array()`
  applied to a traced argument, inside a compiled function: a host sync
  that breaks the graph (a failed `fullgraph` compile) or freezes a
  value into it.
* `impure-in-jit`       — `time.time`-family calls or stateful global
  `np.random.*` inside a compiled function: evaluated once when Dynamo
  traces it, frozen into the graph.
* `device-timing`       — a `time.time()`/`time.perf_counter()` clock
  pair (``t0 = time.perf_counter()`` … ``time.perf_counter() - t0``)
  whose window contains a call that dispatches CUDA work (a `torch.*`
  op, `torch.nn.functional.*`, `torch.ops.*`, `torch.linalg.*`, …) but
  no barrier (`torch.cuda.synchronize`, an event's or stream's
  `.synchronize()`, `utils.backend.sync` / `state_barrier`, `.item()`,
  `.cpu()`, `.tolist()`, `.numpy()`, `float()`, `np.asarray`): CUDA
  launches are asynchronous, so the window measures the launch, not the
  work. `obs/` and `utils/backend.py` are exempt — they own the clocks
  around device code (the barrier discipline lives there).

A function is "compiled" when decorated with `torch.compile` (directly,
as `torch.compile(...)`, or via `functools.partial`), passed by
name/lambda to a `torch.compile(...)` call, or handed as the step to
`obs.xray.XrayedFunction(name, fn, ...)` / `analyze_jit(name, fn, ...)`
in an enclosing scope. Nested defs inherit it.

The JAX rule `block-until-ready` has no torch subject (package
docstring): `torch.cuda.synchronize` is a real barrier.

Suppress with a trailing `# graftlint: disable=<rule>` comment.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set

from tensor2robot_tpu_torch.analysis import engine as engine_lib
from tensor2robot_tpu_torch.analysis.findings import (Finding,
                                                      filter_findings,
                                                      load_suppressions)

__all__ = ["check_python_source", "check_python_file"]

_COMPILE_NAMES = {"torch.compile"}
_PARTIAL_NAMES = {"functools.partial", "partial"}
# Factories that compile the function they are handed as their second
# positional argument (`XrayedFunction(name, fn)`, `analyze_jit(name, fn,
# *args)`).
_STEP_FACTORIES = {"XrayedFunction", "analyze_jit"}

# torch.cuda calls that create (or need) a CUDA context.
_CONTEXT_CALLS = {
    "torch.cuda.current_device", "torch.cuda.set_device",
    "torch.cuda.synchronize", "torch.cuda.get_device_properties",
    "torch.cuda.get_device_name", "torch.cuda.get_device_capability",
    "torch.cuda.mem_get_info", "torch.cuda.init",
    "torch.cuda.current_stream", "torch.cuda.default_stream",
    "torch.cuda.Stream",
}

_TIME_CALLS = {
    "time.time", "time.perf_counter", "time.monotonic",
    "time.process_time", "time.time_ns", "time.perf_counter_ns",
}
# numpy.random entry points that are NOT the stateful global RNG.
_NP_RANDOM_SAFE = {
    "RandomState", "Generator", "default_rng", "SeedSequence", "PCG64",
    "MT19937", "Philox", "SFC64", "BitGenerator",
}
_HOST_CONVERTERS = {"float", "int", "bool"}
_NP_HOST_CONVERTERS = {"numpy.asarray", "numpy.array", "numpy.asanyarray"}
# Tensor methods that copy to the host (and so wait for the device).
_HOST_METHODS = {"item", "tolist", "cpu", "numpy"}

# device-timing vocabulary. Dispatch: torch ops. `torch.<name>` counts
# unless <name> is a class (capitalized) or one of the host-side calls
# below; the submodules listed dispatch too.
_DISPATCH_PREFIXES = ("torch.nn.functional.", "torch.ops.", "torch.linalg.",
                      "torch.fft.", "torch.special.")
_HOST_TORCH = {
    "device", "dtype", "no_grad", "enable_grad", "inference_mode",
    "set_grad_enabled", "is_grad_enabled", "manual_seed", "seed",
    "initial_seed", "get_rng_state", "set_rng_state", "is_tensor",
    "is_storage", "is_floating_point", "is_complex", "numel",
    "get_default_dtype", "set_default_dtype", "set_default_device",
    "get_num_threads", "set_num_threads", "get_num_interop_threads",
    "set_num_interop_threads", "set_float32_matmul_precision",
    "get_float32_matmul_precision", "use_deterministic_algorithms",
    "are_deterministic_algorithms_enabled", "compile", "load", "save",
    "from_numpy", "finfo", "iinfo", "typename", "promote_types",
    "result_type", "can_cast", "broadcast_shapes", "set_printoptions",
    "autocast",
}
_BARRIER_CALLS = _NP_HOST_CONVERTERS | {"float", "int",
                                        "torch.cuda.synchronize"}
# Method/attribute names that barrier regardless of the object they hang
# off (backend.sync, backend_lib.state_barrier, an event's or stream's
# synchronize, tensor.item(), and the backend timing helpers, which
# barrier internally).
_BARRIER_ATTRS = {"sync", "state_barrier", "synchronize", "time_op",
                  "time_train_steps", "time_train_steps_halves"} \
    | _HOST_METHODS


def _import_aliases(tree: ast.AST) -> Dict[str, str]:
  """name -> dotted module/attr path, from every import in the file."""
  aliases: Dict[str, str] = {}
  for node in ast.walk(tree):
    if isinstance(node, ast.Import):
      for alias in node.names:
        aliases[alias.asname or alias.name.split(".", 1)[0]] = (
            alias.name if alias.asname else alias.name.split(".", 1)[0])
    elif isinstance(node, ast.ImportFrom) and not node.level:
      for alias in node.names:
        if node.module:
          aliases[alias.asname or alias.name] = (
              f"{node.module}.{alias.name}")
  return aliases


def _qualified(node: ast.AST, aliases: Dict[str, str]) -> Optional[str]:
  """Dotted name of an expression like `F.relu` ->
  'torch.nn.functional.relu'."""
  parts: List[str] = []
  while isinstance(node, ast.Attribute):
    parts.append(node.attr)
    node = node.value
  if not isinstance(node, ast.Name):
    return None
  root = aliases.get(node.id, node.id)
  return ".".join([root] + list(reversed(parts)))


def _root_name(node: ast.AST) -> Optional[str]:
  """Base variable of `x`, `x.attr`, `x[i]`, `x.attr[i]` chains."""
  while isinstance(node, (ast.Attribute, ast.Subscript)):
    node = node.value
  return node.id if isinstance(node, ast.Name) else None


def _is_compile_expr(node: ast.AST, aliases: Dict[str, str]) -> bool:
  """True for `torch.compile`, `torch.compile(...)` (decorator factory)
  and `functools.partial(torch.compile, ...)`."""
  if _qualified(node, aliases) in _COMPILE_NAMES:
    return True
  if isinstance(node, ast.Call):
    fq = _qualified(node.func, aliases)
    if fq in _COMPILE_NAMES:
      return True
    if fq in _PARTIAL_NAMES and node.args and _is_compile_expr(
        node.args[0], aliases):
      return True
  return False


def _step_factory_target(node: ast.Call) -> Optional[ast.AST]:
  """The function handed to `XrayedFunction(name, fn)` /
  `analyze_jit(name, fn, ...)`, or None."""
  func = node.func
  name = (func.attr if isinstance(func, ast.Attribute)
          else func.id if isinstance(func, ast.Name) else None)
  if name in _STEP_FACTORIES and len(node.args) >= 2:
    return node.args[1]
  return None


class _TracedCollector(ast.NodeVisitor):
  """Finds function nodes whose bodies run under compile tracing."""

  def __init__(self, aliases: Dict[str, str]):
    self.aliases = aliases
    self.traced: List[ast.AST] = []
    # Stack of {local def name -> node} scopes for resolving compile(f).
    self._scopes: List[Dict[str, ast.AST]] = [{}]

  def _handle_def(self, node):
    self._scopes[-1][node.name] = node
    if any(_is_compile_expr(d, self.aliases) for d in node.decorator_list):
      self.traced.append(node)
    self._scopes.append({})
    self.generic_visit(node)
    self._scopes.pop()

  visit_FunctionDef = _handle_def
  visit_AsyncFunctionDef = _handle_def

  def visit_ClassDef(self, node):
    self._scopes.append({})
    self.generic_visit(node)
    self._scopes.pop()

  def visit_Call(self, node):
    target = None
    if _is_compile_expr(node.func, self.aliases) and node.args:
      target = node.args[0]
    else:
      target = _step_factory_target(node)
    if isinstance(target, ast.Lambda):
      self.traced.append(target)
    elif isinstance(target, ast.Name):
      for scope in reversed(self._scopes):
        if target.id in scope:
          self.traced.append(scope[target.id])
          break
    self.generic_visit(node)


def _walk_traced(node: ast.AST, aliases: Dict[str, str], path: str,
                 findings: List[Finding]) -> None:
  """Applies the in-compile rules over one traced function's subtree."""
  params: Set[str] = set()

  def _add_params(fn_node) -> None:
    if isinstance(fn_node, (ast.FunctionDef, ast.AsyncFunctionDef,
                            ast.Lambda)):
      a = fn_node.args
      for arg in (list(a.posonlyargs) + list(a.args) + list(a.kwonlyargs)
                  + ([a.vararg] if a.vararg else [])
                  + ([a.kwarg] if a.kwarg else [])):
        params.add(arg.arg)

  _add_params(node)

  def _visit(n: ast.AST) -> None:
    if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
      _add_params(n)  # nested defs trace too; their args are traced
    if isinstance(n, ast.Call):
      q = _qualified(n.func, aliases)
      if (isinstance(n.func, ast.Attribute) and n.func.attr in _HOST_METHODS
          and not n.args and not n.keywords):
        findings.append(Finding(
            path, n.lineno, "host-sync-in-jit",
            f".{n.func.attr}() inside a compiled function is a host sync "
            "— it breaks the graph (a failed fullgraph compile) or "
            "freezes the value; return the tensor and convert outside the "
            "compiled region",
            end_line=getattr(n, "end_lineno", 0) or 0))
      elif (q in _HOST_CONVERTERS or q in _NP_HOST_CONVERTERS) and n.args:
        root = _root_name(n.args[0])
        if root is not None and root in params:
          findings.append(Finding(
              path, n.lineno, "host-sync-in-jit",
              f"{q}() on traced argument {root!r} inside a compiled "
              "function forces a host sync (or freezes the value into "
              "the graph) — use torch ops or move it outside the "
              "compiled region",
              end_line=getattr(n, "end_lineno", 0) or 0))
      elif q in _TIME_CALLS:
        findings.append(Finding(
            path, n.lineno, "impure-in-jit",
            f"{q}() inside a compiled function is evaluated once when "
            "Dynamo traces it and frozen into the graph",
            end_line=getattr(n, "end_lineno", 0) or 0))
      elif (q is not None and q.startswith("numpy.random.")
            and q.split(".")[-1] not in _NP_RANDOM_SAFE):
        findings.append(Finding(
            path, n.lineno, "impure-in-jit",
            f"stateful {q}() inside a compiled function is drawn once "
            "when Dynamo traces it and frozen — draw with a "
            "torch.Generator passed in, or outside the compiled region",
            end_line=getattr(n, "end_lineno", 0) or 0))
    for child in ast.iter_child_nodes(n):
      _visit(child)

  for child in ast.iter_child_nodes(node):
    _visit(child)


def _is_cuda_device(node: ast.AST, aliases: Dict[str, str]) -> bool:
  """A literal CUDA device: "cuda", "cuda:0", or torch.device("cuda...")."""
  if isinstance(node, ast.Constant) and isinstance(node.value, str):
    return node.value.startswith("cuda")
  if isinstance(node, ast.Call) and _qualified(node.func,
                                               aliases) == "torch.device":
    return bool(node.args) and _is_cuda_device(node.args[0], aliases)
  return False


def _makes_context(n: ast.Call, aliases: Dict[str, str]) -> Optional[str]:
  """What of this call creates a CUDA context, or None."""
  q = _qualified(n.func, aliases)
  if q in _CONTEXT_CALLS:
    return f"{q}()"
  if any(kw.arg == "device" and _is_cuda_device(kw.value, aliases)
         for kw in n.keywords):
    return f"{q or 'a call'}(device=<cuda>)"
  if isinstance(n.func, ast.Attribute):
    if n.func.attr == "cuda":
      return ".cuda()"
    if n.func.attr == "to" and (
        any(_is_cuda_device(a, aliases) for a in n.args[:1])):
      return ".to(<cuda>)"
  return None


def _check_import_time(tree: ast.Module, aliases: Dict[str, str],
                       path: str, findings: List[Finding]) -> None:
  """Flags CUDA-context-creating calls executed as a side effect of
  import."""

  def _is_main_guard(node: ast.AST) -> bool:
    return (isinstance(node, ast.If)
            and isinstance(node.test, ast.Compare)
            and isinstance(node.test.left, ast.Name)
            and node.test.left.id == "__name__")

  def _flag_calls(n: ast.AST) -> None:
    if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
      # Body runs later — but default arguments AND decorator
      # expressions evaluate at import time.
      defaults = list(n.args.defaults) + [d for d in n.args.kw_defaults
                                          if d is not None]
      if not isinstance(n, ast.Lambda):
        defaults.extend(n.decorator_list)
      for d in defaults:
        _flag_calls_expr(d)
      return
    if _is_main_guard(n):
      return
    if isinstance(n, ast.Call):
      _flag_call(n)
    for child in ast.iter_child_nodes(n):
      _flag_calls(child)

  def _flag_calls_expr(n: ast.AST) -> None:
    for sub in ast.walk(n):
      if isinstance(sub, ast.Call):
        _flag_call(sub)

  def _flag_call(n: ast.Call) -> None:
    what = _makes_context(n, aliases)
    if what is not None:
      findings.append(Finding(
          path, n.lineno, "import-time-backend",
          f"{what} at module import level creates a CUDA context as an "
          "import side effect — every process that imports the module "
          "starts one, and a context made before a fork is unusable in "
          "the forked worker; build the value lazily",
          end_line=getattr(n, "end_lineno", 0) or 0))

  for stmt in tree.body:
    _flag_calls(stmt)


def _is_dispatch(q: Optional[str]) -> bool:
  if q is None or not q.startswith("torch."):
    return False
  if q.startswith(_DISPATCH_PREFIXES):
    return True
  name = q[len("torch."):]
  return "." not in name and not name[:1].isupper() \
      and name not in _HOST_TORCH


def _check_device_timing(tree: ast.Module, aliases: Dict[str, str],
                         path: str, findings: List[Finding]) -> None:
  """Flags host-clock windows around un-barriered CUDA dispatches.

  Pattern: ``t0 = time.perf_counter()`` … ``time.perf_counter() - t0``
  within one scope, with a dispatching call between the two clock reads
  and no barrier. Each function is its own scope (nested defs do not
  execute inside the enclosing window)."""

  def _is_clock_call(node: ast.AST) -> bool:
    return (isinstance(node, ast.Call)
            and _qualified(node.func, aliases) in _TIME_CALLS)

  def _scope_statements(scope: ast.AST):
    """Yields every node in the scope, skipping nested function bodies."""
    stack = list(ast.iter_child_nodes(scope))
    while stack:
      node = stack.pop()
      yield node
      if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                               ast.Lambda)):
        stack.extend(ast.iter_child_nodes(node))

  def _check_scope(scope: ast.AST) -> None:
    clock_assigns: Dict[str, List[int]] = {}
    closes: List[tuple] = []  # (varname, line, end_line)
    calls: List[tuple] = []  # (line, qualified, attr_name)
    for node in _scope_statements(scope):
      if (isinstance(node, ast.Assign) and _is_clock_call(node.value)
          and len(node.targets) == 1
          and isinstance(node.targets[0], ast.Name)):
        clock_assigns.setdefault(node.targets[0].id, []).append(node.lineno)
      elif (isinstance(node, ast.BinOp) and isinstance(node.op, ast.Sub)
            and isinstance(node.right, ast.Name)
            and (_is_clock_call(node.left)
                 or isinstance(node.left, ast.Name))):
        closes.append((node.right.id, node.lineno,
                       getattr(node, "end_lineno", 0) or node.lineno))
      if isinstance(node, ast.Call):
        attr = (node.func.attr
                if isinstance(node.func, ast.Attribute) else None)
        calls.append((node.lineno, _qualified(node.func, aliases), attr))
    for var, line, end_line in closes:
      starts = [s for s in clock_assigns.get(var, []) if s < line]
      if not starts:
        continue
      start = max(starts)
      window = [(q, attr) for (call_line, q, attr) in calls
                if start < call_line <= end_line]
      dispatches = [q for q, _ in window if _is_dispatch(q)]
      barriered = any((q in _BARRIER_CALLS if q is not None else False)
                      or attr in _BARRIER_ATTRS for q, attr in window)
      if dispatches and not barriered:
        findings.append(Finding(
            path, line, "device-timing",
            f"host-clock window (since line {start}) times "
            f"{dispatches[0]}() without a barrier — CUDA launches are "
            "asynchronous, so this measures the launch, not the work; "
            "use tensor2robot_tpu_torch.utils.backend.time_op / "
            "time_train_steps, CUDA events, or end the window with "
            "torch.cuda.synchronize() / backend.sync", end_line=end_line))

  _check_scope(tree)
  for node in ast.walk(tree):
    if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
      _check_scope(node)


def check_python_tree(tree: ast.Module, path: str,
                      allow_device_timing: bool = False) -> List[Finding]:
  """Raw (unfiltered, unsorted) findings over an already-parsed module
  — the engine's entry point; `check_python_source` wraps it with the
  parse/filter/sort tail."""
  aliases = _import_aliases(tree)
  findings: List[Finding] = []

  if not allow_device_timing:
    _check_device_timing(tree, aliases, path, findings)

  _check_import_time(tree, aliases, path, findings)

  collector = _TracedCollector(aliases)
  collector.visit(tree)
  seen_traced: Set[int] = set()
  for node in collector.traced:
    if id(node) in seen_traced:
      continue
    seen_traced.add(id(node))
    _walk_traced(node, aliases, path, findings)

  return findings


def check_python_source(text: str, path: str,
                        allow_device_timing: bool = False
                        ) -> List[Finding]:
  """Lints one Python source; returns (suppression-filtered) findings."""
  try:
    tree = ast.parse(text, filename=path)
  except SyntaxError as e:
    return [Finding(path, e.lineno or 0, "parse-error",
                    f"syntax error: {e.msg}")]
  findings = check_python_tree(tree, path,
                               allow_device_timing=allow_device_timing)
  return sorted(filter_findings(findings, load_suppressions(text)),
                key=lambda f: (f.line, f.rule))


def path_exemptions(path: str) -> bool:
  """allow_device_timing for one path — shared by `check_python_file`
  and the engine registration, so the exemption map cannot drift
  between the two call paths. obs/ owns the instrumentation clocks (its
  windows end in barriers by design); utils/backend.py owns the shared
  timing recipes."""
  norm = path.replace("\\", "/")
  return (norm.endswith("utils/backend.py") or "/obs/" in norm
          or norm.startswith("obs/"))


def check_python_file(path: str) -> List[Finding]:
  with open(path) as f:
    return check_python_source(f.read(), path,
                               allow_device_timing=path_exemptions(path))


def _engine_check(ctx) -> List[Finding]:
  return check_python_tree(ctx.tree, ctx.path,
                           allow_device_timing=path_exemptions(ctx.path))


engine_lib.register(engine_lib.Rule(
    name="tracer", kind="py", scope=".py", family="tracer",
    infos=(
        engine_lib.RuleInfo(
            id="import-time-backend",
            doc=("CUDA-context-creating call at module import\n"
                 "level"),
            meaning=("CUDA-context-creating call (`torch.cuda."
                     "current_device`/`set_device`/`synchronize`/..., a "
                     "tensor made on a CUDA device, `.to(<cuda>)`/"
                     "`.cuda()`, fn default args, decorators) at module "
                     "import level")),
        engine_lib.RuleInfo(
            id="host-sync-in-jit",
            doc=(".item() / .cpu() / float() / np.asarray() on\n"
                 "traced values inside a compiled function"),
            meaning=("`.item()` / `.tolist()` / `.cpu()` / `.numpy()` / "
                     "`float()` / `np.asarray()` on traced values inside "
                     "a compiled function")),
        engine_lib.RuleInfo(
            id="impure-in-jit",
            doc=("time.time / stateful np.random inside a compiled\n"
                 "function"),
            meaning=("`time.time` family / stateful global `np.random` "
                     "inside a compiled function")),
        engine_lib.RuleInfo(
            id="device-timing",
            doc=("time.time/perf_counter window around a CUDA\n"
                 "dispatch without a barrier (measures the\n"
                 "launch, not the work); obs/ and\n"
                 "utils/backend.py are exempt"),
            meaning=("`time.time`/`perf_counter` window around a CUDA "
                     "dispatch without a barrier (`torch.cuda."
                     "synchronize`, an event's `synchronize()`, "
                     "`backend.sync`) — measures the launch, not the "
                     "work; `obs/` and `utils/backend.py` (the clock "
                     "owners) are exempt")),
    ),
    check=_engine_check))
