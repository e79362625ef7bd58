"""Structured lint findings + `# graftlint: disable=` suppressions.

Finding format mirrors the `path:line:` prefix ConfigError grew for
runtime errors (utils/config.py), so a static finding and the runtime
failure it predicts read the same way.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, Iterable, List, Optional, Set

__all__ = ["Finding", "Suppressions", "load_suppressions", "filter_findings"]

_DISABLE_RE = re.compile(
    r"#\s*graftlint:\s*disable(?:=(?P<rules>[\w,\- ]+))?")


@dataclasses.dataclass(frozen=True)
class Finding:
  """One rule violation: where, which rule, what's wrong.

  `end_line` is the last physical line of the flagged statement (0 means
  same as `line`) so a `# graftlint: disable=` comment anywhere on a
  multi-line statement suppresses it.
  """

  path: str
  line: int
  rule: str
  message: str
  end_line: int = 0

  def __str__(self) -> str:
    return f"{self.path}:{self.line}: [{self.rule}] {self.message}"


class Suppressions:
  """Per-file map of line -> suppressed rule ids (empty set = all rules).

  A trailing `# graftlint: disable=rule-a,rule-b` suppresses those rules
  on its statement (any physical line of it); bare `# graftlint: disable`
  suppresses every rule. Works for .py and .gin alike (both use `#`
  comments).
  """

  def __init__(self, by_line: Optional[Dict[int, Set[str]]] = None):
    self._by_line: Dict[int, Set[str]] = by_line or {}

  def is_suppressed(self, line: int, rule: str,
                    end_line: int = 0) -> bool:
    return self.match(line, rule, end_line) is not None

  def match(self, line: int, rule: str,
            end_line: int = 0) -> Optional[int]:
    """The physical line whose `# graftlint: disable` comment suppresses
    (line, rule), or None — the suppression-provenance seam the engine's
    JSON output reports (`suppressed_by`)."""
    for candidate in range(line, max(end_line, line) + 1):
      if candidate in self._by_line:
        rules = self._by_line[candidate]
        if not rules or rule in rules:
          return candidate
    return None

  def __bool__(self) -> bool:
    return bool(self._by_line)


def load_suppressions(text: str) -> Suppressions:
  by_line: Dict[int, Set[str]] = {}
  for lineno, raw in enumerate(text.splitlines(), start=1):
    m = _DISABLE_RE.search(raw)
    if not m:
      continue
    rules = m.group("rules")
    by_line[lineno] = ({r.strip() for r in rules.split(",") if r.strip()}
                       if rules else set())
  return Suppressions(by_line)


def filter_findings(findings: Iterable[Finding],
                    suppressions: Suppressions) -> List[Finding]:
  return [f for f in findings
          if not suppressions.is_suppressed(f.line, f.rule, f.end_line)]
