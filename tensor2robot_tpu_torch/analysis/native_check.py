"""graftlint: native export ↔ ctypes binding coverage.

The native layer is a ctypes seam: every `extern "C"` `t2r_*` function a
`.cc` source exports must be referenced by `native/__init__.py` (an
argtypes/restype declaration, an `hasattr` feature probe, or a call
site), and every `t2r_*` name the wrapper mentions must exist in some
source. Without this check the drift is silent in BOTH directions — a
new C++ export without a binding just never runs, and a typoed
`lib.t2r_...` attribute only explodes at call time in whatever process
first takes that path.

The port of the JAX package's `analysis.native_check`, over the port's
`native/*.cc` and `native/__init__.py`. One adaptation: the port builds
its library itself, as `_build/t2r_native-<hash>.so`, so a `t2r_` token
followed by `-` is that file's stem, not a symbol reference.

Pure text analysis (regex over the sources): no compile, no ctypes
load, device-free like every graftlint rule.
"""

from __future__ import annotations

import os
import re
from typing import List, Set, Tuple

from tensor2robot_tpu_torch.analysis import engine as engine_lib
from tensor2robot_tpu_torch.analysis.findings import (Finding, filter_findings,
                                                load_suppressions)

__all__ = ["exported_symbols", "bound_symbols", "check_native_bindings"]

# A C/C++ function DEFINITION or extern declaration at statement start:
# optional `extern "C"`/`const`, a return type (word, optionally
# pointered), then the t2r_ name and its parameter list opener.
# Call sites inside function bodies are fenced out by the keyword guard
# (`return t2r_...(...)`) and by requiring the type token shape
# (`if (t2r_...` has no preceding type word).
_EXPORT_RE = re.compile(
    r'^\s*(?:extern\s+"C"\s+)?(?:const\s+)?'
    r"(?P<type>\w+)(?:\s*\*)*\s+\*?(?P<name>t2r_\w+)\s*\(",
    re.MULTILINE)
_CC_KEYWORDS = {"return", "if", "while", "switch", "case", "else", "do"}
# \b keeps filenames like `libt2r_native.so` from matching mid-word;
# tokens ending in `_` are wildcard prose mentions (`t2r_stager_*`),
# not symbol references; a token followed by `-` is a file stem (the
# built library's `t2r_native-<hash>.so`).
_TOKEN_RE = re.compile(r"\bt2r_\w*[A-Za-z0-9](?![\w*-])")


def exported_symbols(cc_path: str) -> Set[str]:
  """`t2r_*` functions defined (or extern-declared) in one .cc file."""
  with open(cc_path, encoding="utf-8") as f:
    text = f.read()
  return {m.group("name") for m in _EXPORT_RE.finditer(text)
          if m.group("type") not in _CC_KEYWORDS}


def bound_symbols(init_path: str) -> Tuple[Set[str], List[Tuple[int, str]]]:
  """(all t2r_ tokens in the wrapper, [(line, token), ...] occurrences).

  Token-level on purpose: `lib.t2r_x` attribute bindings, `hasattr(lib,
  "t2r_x")` probes and docstring references all count as coverage — the
  check is for symbols NOBODY mentions, not for a particular binding
  style.
  """
  with open(init_path, encoding="utf-8") as f:
    return _bound_symbols_in_text(f.read())


def _bound_symbols_in_text(text: str) -> Tuple[Set[str],
                                               List[Tuple[int, str]]]:
  tokens: Set[str] = set()
  occurrences: List[Tuple[int, str]] = []
  for lineno, line in enumerate(text.splitlines(), start=1):
    for m in _TOKEN_RE.finditer(line):
      tokens.add(m.group(0))
      occurrences.append((lineno, m.group(0)))
  return tokens, occurrences


def check_native_bindings(native_dir: str) -> List[Finding]:
  """Findings for export/binding drift under one native package dir.

  native-binding-missing  a .cc exports `t2r_x` but `__init__.py` never
                          mentions it (the symbol is dead weight at best,
                          an unshipped feature at worst)
  native-binding-unknown  `__init__.py` mentions `t2r_x` but no .cc
                          defines it (typo or a binding for deleted C++)
  """
  init_path = os.path.join(native_dir, "__init__.py")
  if not os.path.isfile(init_path):
    return []
  cc_paths = sorted(
      os.path.join(native_dir, name) for name in os.listdir(native_dir)
      if name.endswith(".cc"))
  exported: Set[str] = set()
  for cc_path in cc_paths:
    exported |= exported_symbols(cc_path)
  if not cc_paths:
    return []
  with open(init_path, encoding="utf-8") as f:
    init_text = f.read()
  bound, occurrences = _bound_symbols_in_text(init_text)
  findings: List[Finding] = []
  for name in sorted(exported - bound):
    findings.append(Finding(
        path=init_path, line=1, rule="native-binding-missing",
        message=f"native sources export {name!r} but the ctypes wrapper "
                "never references it (add a binding or drop the export)"))
  for lineno, token in occurrences:
    if token not in exported:
      findings.append(Finding(
          path=init_path, line=lineno, rule="native-binding-unknown",
          message=f"{token!r} is referenced here but no .cc source "
                  "defines it (typo, or the C++ side was removed)"))
  return filter_findings(findings, load_suppressions(init_text))


def _is_native_wrapper(path: str) -> bool:
  """A native-package wrapper pulls in the export/binding coverage
  check for its whole directory (.cc sources aren't walked directly —
  the wrapper is the unit whose drift matters)."""
  return (os.path.basename(path) == "__init__.py"
          and os.path.basename(os.path.dirname(path)) == "native")


engine_lib.register(engine_lib.Rule(
    name="native", kind="native",
    scope="native/__init__.py ↔ native/*.cc", family="native",
    infos=(
        engine_lib.RuleInfo(
            id="native-binding-missing",
            doc=("a .cc source exports a `t2r_*` symbol the\n"
                 "ctypes wrapper never references"),
            meaning=("a `.cc` source exports a `t2r_*` symbol the "
                     "ctypes wrapper never references")),
        engine_lib.RuleInfo(
            id="native-binding-unknown",
            doc=("the wrapper references a `t2r_*` name no .cc\n"
                 "source defines"),
            meaning=("the wrapper references a `t2r_*` name no `.cc` "
                     "source defines")),
    ),
    path_filter=_is_native_wrapper,
    # Self-filtered against __init__.py's own suppressions (the engine's
    # central pass re-applies the same suppressions — a no-op).
    check=lambda ctx: check_native_bindings(os.path.dirname(ctx.path))))
