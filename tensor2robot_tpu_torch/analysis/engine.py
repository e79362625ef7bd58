"""graftlint rule engine: one parse per file, one suppression model.

The port of the JAX package's `analysis.engine`. Checkers REGISTER rules
here (a `Rule` carries its catalog metadata plus either a whole-tree
`check` callback or a node-type `visitors` dispatch table), and the
engine walks each file ONCE: one read, one `ast.parse`, one shared
`ast.walk` node list for every visitor rule, one central suppression
pass with provenance (which `# graftlint: disable` line swallowed which
finding).

The registry is the single source of truth for the rule catalog:
`catalog_text()` renders `--list-rules` and `catalog_markdown()` renders
the rule table of README.md's port section (a test pins the README
against it), so a new rule cannot ship undocumented.

Finding order is the JAX engine's: each rule emits raw findings in its
own traversal order (the shared walk list IS `ast.walk`'s BFS order),
`filter_findings` preserves order, Python's sort is stable, and the
final global sort key is (path, line, rule). The port's execution order
(`CHECK_ORDER`) is the JAX package's without `pallas`, whose rule has no
torch subject (package docstring).

Also home to the incremental mode: `--cache-file` keys each `.py`
file's findings on a content hash (plus the mesh-axis vocabulary and
the registered rule list, which both change findings without changing
the file), and `--changed-only` reports only files whose hash moved.
`.gin` results additionally depend on the importable module registry,
so config files are only served from cache in `--changed-only` mode (a
full cached run re-checks every config).

Nothing here imports torch; `config_check` imports the modules a config
names (which import torch) and never touches a CUDA context.
"""

from __future__ import annotations

import ast
import dataclasses
import hashlib
import json
import os
import re
import time
from typing import (Any, Callable, Dict, Iterable, List, Mapping, Optional,
                    Sequence, Set, Tuple, Type)

from tensor2robot_tpu_torch.analysis.findings import Finding, load_suppressions

__all__ = [
    "RuleInfo", "Rule", "FileContext", "EngineResult", "register",
    "registered_rules", "rule_infos", "severity_of", "load_builtin_rules",
    "catalog_text", "catalog_markdown", "discover", "run_engine",
    "finding_fingerprint", "load_baseline", "write_baseline",
]

SEVERITIES = ("error", "warning")

# Checker execution order per file — the exact order lint.run has always
# applied (tie-order inside one (path, line, rule) sort key depends on
# it, so it is part of the byte-parity contract, not a style choice).
CHECK_ORDER = ("tracer", "spec", "cache", "pp", "session", "fleet",
               "forge", "retry", "thread", "loop", "native", "tracectx",
               "slo")

# Catalog presentation order — the JAX package's family order (config
# first, spec last, the graph audit after it) without `pallas`.
CATALOG_ORDER = ("config", "tracer", "tracectx", "cache", "pp",
                 "session", "retry", "fleet", "forge", "loop", "thread",
                 "native", "slo", "spec", "audit")

_SKIP_DIRS = {"__pycache__", ".git", "node_modules", ".ipynb_checkpoints"}

_CATALOG_FOOTER = ("Suppress a finding with a trailing "
                   "`# graftlint: disable=<rule>`.")

# `parse-error` is shared: config_check reports unparseable .gin files
# and the engine itself reports unparseable .py files (the role
# tracer_check's parse owned before the single-parse refactor).
_PARSE_ERROR_RULE = "parse-error"


@dataclasses.dataclass(frozen=True)
class RuleInfo:
  """Catalog metadata for one rule id.

  `doc` is the pre-wrapped plain-text block `--list-rules` prints
  (first line + continuation lines, no indentation — the renderer owns
  layout); `meaning` is the one-line markdown cell of README.md's
  rule table. Both live next to the checker that
  owns the rule, so catalog and implementation cannot drift.
  """

  id: str
  doc: str
  meaning: str
  severity: str = "error"

  def __post_init__(self):
    if self.severity not in SEVERITIES:
      raise ValueError(f"Unknown severity {self.severity!r} for rule "
                       f"{self.id!r} (want one of {SEVERITIES})")


# A whole-tree callback: ctx -> raw (unfiltered, emission-order)
# findings. A visitor callback: (ctx, node) -> iterable of findings for
# one matching node of the shared walk.
CheckFn = Callable[["FileContext"], List[Finding]]
VisitFn = Callable[["FileContext", ast.AST], Iterable[Finding]]


@dataclasses.dataclass(frozen=True)
class Rule:
  """One registered checker: catalog entries + how to run it.

  kind:
    "py"     — runs over parsed Python files (check or visitors);
    "gin"    — runs over config files (check; self-filtered);
    "native" — runs over the native wrapper (check; self-filtered);
    "graph"  — catalog/severity only; executed by `graftscope audit`
               over traced FX graphs, not by the file walk.

  `path_filter` (path -> bool) scopes path-gated rules (retry's hot
  paths, the loop package, the native wrapper) without the rule body
  re-deriving it per node.
  """

  name: str
  kind: str
  scope: str
  family: str
  infos: Tuple[RuleInfo, ...]
  check: Optional[CheckFn] = None
  visitors: Optional[Mapping[Type[ast.AST], VisitFn]] = None
  path_filter: Optional[Callable[[str], bool]] = None

  def applies_to(self, path: str) -> bool:
    return self.path_filter is None or self.path_filter(path)


_REGISTRY: Dict[str, Rule] = {}
_BUILTINS_LOADED = False


def register(rule: Rule) -> Rule:
  """Adds a rule to the registry (idempotent re-registration allowed so
  module reloads in tests don't explode; a DIFFERENT rule under an
  existing name is a programming error)."""
  existing = _REGISTRY.get(rule.name)
  if existing is not None and {i.id for i in existing.infos} != {
      i.id for i in rule.infos}:
    raise ValueError(f"rule {rule.name!r} already registered with "
                     "different rule ids")
  _REGISTRY[rule.name] = rule
  return rule


def load_builtin_rules() -> None:
  """Imports every checker module once; each registers itself at import
  bottom (the engine never imports checkers at module level, so there
  is no import cycle — checkers import `engine` freely)."""
  global _BUILTINS_LOADED
  if _BUILTINS_LOADED:
    return
  # Import order is irrelevant: execution order is CHECK_ORDER and
  # catalog order is CATALOG_ORDER, both keyed by rule name.
  from tensor2robot_tpu_torch.analysis import (  # noqa: F401
      cache_check, config_check, fleet_check, forge_check, graph_audit,
      loop_check, native_check, pp_check, retry_check, session_check,
      slo_check, spec_check, thread_check, trace_check, tracer_check)
  _BUILTINS_LOADED = True


def registered_rules() -> Dict[str, Rule]:
  load_builtin_rules()
  return dict(_REGISTRY)


def rule_infos() -> List[RuleInfo]:
  """Every RuleInfo in catalog order."""
  rules = registered_rules()
  infos: List[RuleInfo] = []
  for name in CATALOG_ORDER:
    if name in rules:
      infos.extend(rules[name].infos)
  for name in sorted(set(rules) - set(CATALOG_ORDER)):
    infos.extend(rules[name].infos)
  return infos


def severity_of(rule_id: str) -> str:
  for info in rule_infos():
    if info.id == rule_id:
      return info.severity
  return "error"


# --------------------------------------------------------------------
# Catalog rendering — the single source of truth behind --list-rules
# AND README.md's rule table.

_DOC_ID_WIDTH = 21   # two-space indent + 21-char id field + two spaces
_DOC_INDENT = " " * 25


def catalog_text() -> str:
  """The --list-rules catalog (layout byte-compatible with the old
  hand-maintained `_RULE_CATALOG` string)."""
  rules = registered_rules()
  blocks: List[str] = []
  for name in CATALOG_ORDER:
    rule = rules.get(name)
    if rule is None:
      continue
    lines = [f"{rule.family} rules ({rule.scope}):"]
    for info in rule.infos:
      doc_lines = info.doc.splitlines() or [""]
      lines.append(f"  {info.id.ljust(_DOC_ID_WIDTH)}  {doc_lines[0]}")
      lines.extend(f"{_DOC_INDENT}{rest}" for rest in doc_lines[1:])
    blocks.append("\n".join(lines))
  return "\n\n".join(blocks) + f"\n\n{_CATALOG_FOOTER}\n"


def catalog_markdown() -> str:
  """README.md's rule table (regenerated, never edited by hand — a test
  pins the README section against this output)."""
  lines = ["| Rule | Family | Severity | Meaning |", "|---|---|---|---|"]
  rules = registered_rules()
  for name in CATALOG_ORDER:
    rule = rules.get(name)
    if rule is None:
      continue
    for info in rule.infos:
      lines.append(f"| `{info.id}` | {rule.family} | {info.severity} "
                   f"| {info.meaning} |")
  return "\n".join(lines) + "\n"


# --------------------------------------------------------------------
# File discovery (moved here from lint.py; lint re-exports it).

def discover(paths: Sequence[str]) -> Tuple[List[str], List[str]]:
  """(.py files, .gin files) under the given files/directories."""
  py_files: List[str] = []
  gin_files: List[str] = []
  for path in paths:
    if os.path.isfile(path):
      (py_files if path.endswith(".py") else
       gin_files if path.endswith(".gin") else []).append(path)
      continue
    for dirpath, dirnames, filenames in os.walk(path):
      dirnames[:] = sorted(d for d in dirnames if d not in _SKIP_DIRS)
      for name in sorted(filenames):
        if name.endswith(".py"):
          py_files.append(os.path.join(dirpath, name))
        elif name.endswith(".gin"):
          gin_files.append(os.path.join(dirpath, name))
  return py_files, gin_files


# --------------------------------------------------------------------
# Per-file context shared by every rule.

class FileContext:
  """One parsed file, shared across all rules: the source, the tree,
  ONE cached `ast.walk` node list for visitor dispatch, and a per-rule
  memo for derived structures (e.g. forge's module-literal table) so a
  rule computes them once per file, not once per node."""

  def __init__(self, path: str, source: str, tree: Optional[ast.Module],
               mesh_axes: Set[str]):
    self.path = path
    self.source = source
    self.tree = tree
    self.mesh_axes = mesh_axes
    self._nodes: Optional[List[ast.AST]] = None
    self._memo: Dict[str, Any] = {}

  @property
  def nodes(self) -> List[ast.AST]:
    if self._nodes is None:
      self._nodes = list(ast.walk(self.tree)) if self.tree else []
    return self._nodes

  def memo(self, key: str, factory: Callable[[], Any]) -> Any:
    if key not in self._memo:
      self._memo[key] = factory()
    return self._memo[key]


@dataclasses.dataclass
class EngineResult:
  findings: List[Finding]
  # (finding, line of the `# graftlint: disable` comment that ate it) —
  # the provenance the enriched --json output reports. Only rules the
  # engine filters centrally appear here (config/native self-filter).
  suppressed: List[Tuple[Finding, int]]
  stats: Dict[str, Any]


def _run_py_rules(ctx: FileContext,
                  rules: Sequence[Rule]) -> List[Finding]:
  """Raw findings of every applicable py rule, in CHECK_ORDER. Visitor
  rules share ONE pass over the cached walk list; per-rule buckets keep
  each rule's emissions in its own traversal order (== what its
  standalone `ast.walk` produced)."""
  applicable = [r for r in rules if r.applies_to(ctx.path)]
  buckets: Dict[str, List[Finding]] = {r.name: [] for r in applicable}
  visitor_rules = [r for r in applicable if r.visitors is not None]
  if visitor_rules:
    for node in ctx.nodes:
      node_type = type(node)
      for rule in visitor_rules:
        handler = rule.visitors.get(node_type)
        if handler is not None:
          buckets[rule.name].extend(handler(ctx, node))
  raw: List[Finding] = []
  for rule in applicable:
    if rule.check is not None:
      buckets[rule.name].extend(rule.check(ctx))
    raw.extend(buckets[rule.name])
  return raw


# --------------------------------------------------------------------
# Incremental cache.

CACHE_SCHEMA = "graftlint-cache-v1"
# Bump when rule logic changes in a way that invalidates cached
# findings without changing file contents.
ENGINE_CACHE_VERSION = 1

_GIN_INCLUDE_RE = re.compile(r"^\s*include\s+['\"](?P<path>[^'\"]+)['\"]",
                             re.MULTILINE)


def _sha256(text: str) -> str:
  return hashlib.sha256(text.encode("utf-8", "surrogatepass")).hexdigest()


def _gin_digest(path: str, _seen: Optional[Set[str]] = None) -> str:
  """Content hash over a config file AND its include closure (an edit
  to an included base config changes the includer's findings)."""
  seen = _seen if _seen is not None else set()
  real = os.path.realpath(path)
  if real in seen:
    return ""
  seen.add(real)
  try:
    with open(path, encoding="utf-8", errors="replace") as f:
      text = f.read()
  except OSError:
    return "unreadable"
  parts = [_sha256(text)]
  for m in _GIN_INCLUDE_RE.finditer(text):
    inc = m.group("path")
    if not os.path.isabs(inc):
      inc = os.path.join(os.path.dirname(path), inc)
    parts.append(_gin_digest(inc, seen))
  return _sha256("\n".join(parts))


def _finding_to_json(f: Finding) -> Dict[str, Any]:
  return {"path": f.path, "line": f.line, "rule": f.rule,
          "message": f.message, "end_line": f.end_line}


def _finding_from_json(d: Dict[str, Any]) -> Finding:
  return Finding(path=d["path"], line=int(d["line"]), rule=d["rule"],
                 message=d["message"], end_line=int(d.get("end_line", 0)))


class _Cache:
  """Content-hash-keyed findings cache (one JSON file).

  Validity is global over (schema, engine version, registered rule ids,
  mesh-axis vocabulary): any of those changing can change findings with
  no file edit, so a mismatch drops the whole cache rather than serving
  stale results file by file.
  """

  def __init__(self, path: str, rule_ids: Sequence[str],
               vocab_digest: str):
    self.path = path
    self._stamp = {
        "schema": CACHE_SCHEMA,
        "version": ENGINE_CACHE_VERSION,
        "rules": sorted(rule_ids),
        "vocab": vocab_digest,
    }
    self._files: Dict[str, Dict[str, Any]] = {}
    self.hits = 0
    try:
      with open(path, encoding="utf-8") as f:
        data = json.load(f)
      if all(data.get(k) == v for k, v in self._stamp.items()):
        self._files = data.get("files", {})
    except (OSError, ValueError):
      pass

  def lookup(self, path: str, digest: str
             ) -> Optional[Tuple[List[Finding], List[Tuple[Finding, int]]]]:
    entry = self._files.get(path)
    if not entry or entry.get("digest") != digest:
      return None
    self.hits += 1
    findings = [_finding_from_json(d) for d in entry["findings"]]
    suppressed = [(_finding_from_json(d), int(line))
                  for d, line in entry["suppressed"]]
    return findings, suppressed

  def store(self, path: str, digest: str, findings: Sequence[Finding],
            suppressed: Sequence[Tuple[Finding, int]]) -> None:
    self._files[path] = {
        "digest": digest,
        "findings": [_finding_to_json(f) for f in findings],
        "suppressed": [[_finding_to_json(f), line]
                       for f, line in suppressed],
    }

  def save(self) -> None:
    data = dict(self._stamp)
    data["files"] = self._files
    tmp = f"{self.path}.tmp.{os.getpid()}"
    os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
    with open(tmp, "w", encoding="utf-8") as f:
      json.dump(data, f)
    os.replace(tmp, self.path)


# --------------------------------------------------------------------
# Baseline files: accept today's findings, gate only NEW ones.

BASELINE_SCHEMA = "graftlint-baseline-v1"


def finding_fingerprint(f: Finding) -> str:
  """Line-number-independent identity of a finding (path + rule +
  message), so edits above a known finding don't churn the baseline."""
  return _sha256(f"{f.path}\0{f.rule}\0{f.message}")[:16]


def load_baseline(path: str) -> Set[str]:
  with open(path, encoding="utf-8") as f:
    data = json.load(f)
  if data.get("schema") != BASELINE_SCHEMA:
    raise ValueError(f"{path}: not a {BASELINE_SCHEMA} file")
  return set(data.get("fingerprints", []))


def write_baseline(path: str, findings: Sequence[Finding]) -> None:
  data = {"schema": BASELINE_SCHEMA,
          "fingerprints": sorted({finding_fingerprint(f)
                                  for f in findings})}
  with open(path, "w", encoding="utf-8") as f:
    json.dump(data, f, indent=1, sort_keys=True)
    f.write("\n")


# --------------------------------------------------------------------
# The engine proper.

def _known_mesh_axes(gin_files: Sequence[str]) -> Set[str]:
  """Axis vocabulary: DEFAULT_AXES + every discovered config + the
  repo's own shipped configs (linting one .py file must still know the
  axes configs elsewhere declare — lint.run's long-standing rule)."""
  from tensor2robot_tpu_torch.analysis import spec_check
  package_dir = os.path.dirname(os.path.abspath(__file__))
  _, repo_gin = discover([os.path.dirname(package_dir)])
  return spec_check.known_mesh_axes(sorted(set(gin_files) | set(repo_gin)))


def run_engine(paths: Sequence[str],
               cache_path: Optional[str] = None,
               changed_only: bool = False) -> EngineResult:
  """Runs every registered file rule over `paths`.

  `cache_path` enables the incremental mode; `changed_only`
  additionally restricts the report to files whose content hash moved
  (and allows .gin cache reuse — see the module docstring caveat).
  """
  load_builtin_rules()
  wall_start = time.perf_counter()
  py_files, gin_files = discover(list(paths))
  mesh_axes = _known_mesh_axes(gin_files)
  rules = _REGISTRY
  py_rules = [rules[name] for name in CHECK_ORDER
              if name in rules and rules[name].kind in ("py", "native")]
  gin_rules = [r for r in rules.values() if r.kind == "gin"]

  cache: Optional[_Cache] = None
  if cache_path:
    rule_ids = [info.id for info in rule_infos()]
    cache = _Cache(cache_path, rule_ids,
                   vocab_digest=_sha256(",".join(sorted(mesh_axes))))

  findings: List[Finding] = []
  suppressed: List[Tuple[Finding, int]] = []
  changed_files: Set[str] = set()
  parse_ms = 0.0
  rules_ms = 0.0
  parses = 0
  cache_hits = 0

  def _record(path: str, kept: List[Finding],
              supp: List[Tuple[Finding, int]], fresh: bool,
              digest: Optional[str]) -> None:
    nonlocal cache_hits
    if fresh:
      changed_files.add(path)
      if cache is not None and digest is not None:
        cache.store(path, digest, kept, supp)
    else:
      cache_hits += 1
    # Inclusion is decided per CHECKED file (a config finding may point
    # at an included path — it still belongs to the includer's report).
    if fresh or not changed_only:
      findings.extend(kept)
      suppressed.extend(supp)

  for path in gin_files:
    digest = _gin_digest(path) if cache is not None else None
    # Config findings depend on the importable module registry, not
    # just the file — cached .gin results are only trusted on the
    # explicit --changed-only fast path.
    if cache is not None and changed_only and digest is not None:
      hit = cache.lookup(path, digest)
      if hit is not None:
        _record(path, hit[0], hit[1], fresh=False, digest=digest)
        continue
    t0 = time.perf_counter()
    gin_findings: List[Finding] = []
    for rule in gin_rules:
      if rule.applies_to(path):
        gin_findings.extend(rule.check(  # self-filtered by config_check
            FileContext(path, "", None, mesh_axes)))
    rules_ms += (time.perf_counter() - t0) * 1e3
    _record(path, gin_findings, [], fresh=True, digest=digest)

  for path in py_files:
    with open(path) as f:
      source = f.read()
    digest = _sha256(source) if cache is not None else None
    if cache is not None and digest is not None:
      hit = cache.lookup(path, digest)
      if hit is not None:
        _record(path, hit[0], hit[1], fresh=False, digest=digest)
        continue
    t0 = time.perf_counter()
    try:
      tree = ast.parse(source, filename=path)
    except SyntaxError as e:
      parse_ms += (time.perf_counter() - t0) * 1e3
      parses += 1
      # The one finding that is never suppressible: an unparseable file
      # has no trustworthy comment lines (tracer_check's old contract).
      _record(path,
              [Finding(path, e.lineno or 0, _PARSE_ERROR_RULE,
                       f"syntax error: {e.msg}")],
              [], fresh=True, digest=digest)
      continue
    parse_ms += (time.perf_counter() - t0) * 1e3
    parses += 1
    ctx = FileContext(path, source, tree, mesh_axes)
    t0 = time.perf_counter()
    raw = _run_py_rules(ctx, py_rules)
    supps = load_suppressions(source)
    kept: List[Finding] = []
    supp: List[Tuple[Finding, int]] = []
    for f_ in raw:
      at = supps.match(f_.line, f_.rule, f_.end_line)
      if at is None:
        kept.append(f_)
      else:
        supp.append((f_, at))
    rules_ms += (time.perf_counter() - t0) * 1e3
    _record(path, kept, supp, fresh=True, digest=digest)

  if cache is not None:
    cache.save()

  key = lambda f: (f.path, f.line, f.rule)  # noqa: E731
  result = EngineResult(
      findings=sorted(findings, key=key),
      suppressed=sorted(suppressed, key=lambda pair: key(pair[0])),
      stats={
          "files": len(py_files) + len(gin_files),
          "py_files": len(py_files),
          "gin_files": len(gin_files),
          "parses": parses,
          "parse_ms": round(parse_ms, 3),
          "rules_ms": round(rules_ms, 3),
          "wall_ms": round((time.perf_counter() - wall_start) * 1e3, 3),
          "cache_hits": cache_hits,
      })
  return result
