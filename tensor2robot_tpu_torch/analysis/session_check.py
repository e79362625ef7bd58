"""graftlint: session decode state must stay device-resident and bound.

The whole point of stateful serving sessions (`serving/session.py`) is that per-session decode state NEVER leaves the
device and is ALWAYS re-bound after every tick — the two ways a call
site silently gives the O(1) win back:

* dropping the returned state: the decode seam is a pure
  `(state, session_state, features) -> (new_session_state, outputs)`;
  a call site that discards the first element keeps ticking on the OLD
  cache, which "works" (same shapes, plausible numbers) while every
  tick replays position 0 — the bug class that is invisible in shape
  tests and fatal in episodes;
* fetching session state to host: an `np.asarray` or a `.cpu()` /
  `.numpy()` / `.tolist()` over a session-state/arena value pays a full
  state transfer per tick (KV caches are the BIG tensors — the arena of
  the long-context session config is 2 x 545 MB — quietly rebuilding
  the stateless cost profile), and each fetch is a device sync.

Rule `session-state-leak` flags, at decode call sites
(`decode_step`/`decode_fn`/`decode_dispatch` call names):

* a bare-expression call (the returned state tuple is discarded);
* a tuple assignment whose STATE slot (first target) is an underscore
  name (`_`, `_state`, ...) — an explicit drop spelled as binding;

and, anywhere:

* `np.asarray` / `np.array` / `device_get` applied to, or a `.cpu()` /
  `.numpy()` / `.tolist()` called on, a name or attribute whose dotted
  path mentions `session_state` or `arena` — host-fetching the state
  (the method forms are the torch subject the port adds).

The port of the JAX package's `analysis.session_check`. Pure AST
analysis, device-free like every graftlint rule (pattern of
`pp_check.py`). Suppress a deliberate exception with a trailing
`# graftlint: disable=session-state-leak`.
"""

from __future__ import annotations

import ast
from typing import List, Optional

from tensor2robot_tpu_torch.analysis import engine as engine_lib
from tensor2robot_tpu_torch.analysis.findings import (Finding, filter_findings,
                                                load_suppressions)

__all__ = ["check_python_source", "check_python_file"]

_RULE = "session-state-leak"
_DECODE_NAMES = ("decode_step", "decode_fn", "decode_dispatch")
_FETCH_NAMES = ("asarray", "array", "device_get")
# Tensor methods that copy to the host (`arena.cpu()`).
_FETCH_METHODS = ("cpu", "numpy", "tolist")
_STATE_MARKERS = ("session_state", "arena")


def _call_name(func: ast.AST) -> Optional[str]:
  if isinstance(func, ast.Name):
    return func.id
  if isinstance(func, ast.Attribute):
    return func.attr
  return None


def _dotted(node: ast.AST) -> str:
  """Best-effort dotted path of a Name/Attribute chain ('' otherwise)."""
  parts: List[str] = []
  while isinstance(node, ast.Attribute):
    parts.append(node.attr)
    node = node.value
  if isinstance(node, ast.Name):
    parts.append(node.id)
  return ".".join(reversed(parts))


def _unsubscripted(node: ast.AST) -> ast.AST:
  """`x.arena` for `x.arena['k'][0]` (a leaf of the state)."""
  while isinstance(node, ast.Subscript):
    node = node.value
  return node


def _mentions_state(node: ast.AST) -> bool:
  dotted = _dotted(node).lower()
  return any(marker in dotted for marker in _STATE_MARKERS)


def _is_underscore(target: ast.AST) -> bool:
  return isinstance(target, ast.Name) and target.id.startswith("_")


def _finding(path: str, node: ast.AST, message: str) -> Finding:
  return Finding(
      path=path, line=node.lineno, rule=_RULE,
      end_line=getattr(node, "end_lineno", node.lineno) or node.lineno,
      message=message)


def _check_node(path: str, node: ast.AST) -> List[Finding]:
  """Findings for one Expr/Assign/Call node (shared by the standalone
  parse path and the engine's single-walk visitor dispatch)."""
  findings: List[Finding] = []
  # Dropped decode state: `decode_step(...)` as a bare statement.
  if (isinstance(node, ast.Expr) and isinstance(node.value, ast.Call)
      and _call_name(node.value.func) in _DECODE_NAMES):
    findings.append(_finding(
        path, node,
        "decode-step result discarded — the returned session state is "
        "never re-bound, so every later tick replays the stale cache; "
        "bind it (`state, outputs = decode_step(...)`) or suppress a "
        "deliberate throwaway"))
    return findings
  # Dropped decode state spelled as `_ , out = decode_step(...)`.
  if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call) \
      and _call_name(node.value.func) in _DECODE_NAMES:
    for target in node.targets:
      if isinstance(target, (ast.Tuple, ast.List)) and target.elts \
          and _is_underscore(target.elts[0]):
        findings.append(_finding(
            path, node,
            "decode-step state bound to an underscore name — the new "
            "session state is dropped and later ticks replay the "
            "stale cache; re-bind the state or suppress a deliberate "
            "single-tick probe"))
        break
  # Host fetch of session state: np.asarray(...session_state/arena...),
  # or session_state/arena....cpu().
  if isinstance(node, ast.Call) and (
      (_call_name(node.func) in _FETCH_NAMES
       and any(_mentions_state(arg) for arg in node.args[:1]))
      or (isinstance(node.func, ast.Attribute)
          and node.func.attr in _FETCH_METHODS
          and _mentions_state(_unsubscripted(node.func.value)))):
    findings.append(_finding(
        path, node,
        "session state fetched to host — per-session decode caches "
        "must stay device-resident between ticks (a KV-cache fetch "
        "per tick re-buys the stateless cost, and each fetch is a "
        "device sync); fetch OUTPUTS only, or suppress a deliberate "
        "debug dump"))
  return findings


def check_python_source(path: str, source: str) -> List[Finding]:
  try:
    tree = ast.parse(source, filename=path)
  except SyntaxError:
    return []  # the engine reports unparseable files
  findings: List[Finding] = []
  for node in ast.walk(tree):
    findings.extend(_check_node(path, node))
  return findings


def check_python_file(path: str) -> List[Finding]:
  with open(path, encoding="utf-8", errors="replace") as f:
    source = f.read()
  return filter_findings(check_python_source(path, source),
                         load_suppressions(source))


def _visit(ctx, node):
  return _check_node(ctx.path, node)


engine_lib.register(engine_lib.Rule(
    name="session", kind="py", scope=".py", family="session",
    infos=(engine_lib.RuleInfo(
        id=_RULE,
        doc=("a decode-step call site that discards the\n"
             "returned session state (bare expression, or\n"
             "the state slot bound to an underscore name) —\n"
             "later ticks replay the stale cache — or an\n"
             "np.asarray / .cpu() host fetch of a\n"
             "session_state/arena value, which re-buys the\n"
             "stateless per-tick cost (and syncs the device\n"
             "on every tick)"),
        meaning=("a decode-step call site drops the returned session "
                 "state (bare expression / state bound to an underscore "
                 "name) so later ticks replay the stale cache, or "
                 "host-fetches a session_state/arena value "
                 "(`np.asarray`/`device_get`/`.cpu()`), re-buying the "
                 "stateless "
                 "per-tick cost")),),
    visitors={ast.Expr: _visit, ast.Assign: _visit, ast.Call: _visit}))
