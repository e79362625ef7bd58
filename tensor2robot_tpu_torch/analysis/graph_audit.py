"""graftaudit: graph-level semantic auditing of a config's compiled steps
— ahead of time, trace-only, on fake tensors.

The port of the JAX package's `analysis.jaxpr_audit`. graftlint reads
source text; the expensive mistakes this module looks for exist only in
the traced program:

* `audit-baked-constant`        a large tensor the graph holds as a
                                constant, not as a parameter, buffer or
                                input: a tensor the step closes over, or
                                one it makes from host data (a numpy
                                table converted inside the step). The
                                compiled graph carries it in every
                                graftcache entry and no donation reaches
                                it;
* `audit-undonated-state`       a state-sized input whose shape/dtype
                                reappears in the outputs, neither in the
                                target's `donate_argnums` nor written in
                                place by the graph: two copies live
                                across every call;
* `audit-host-callback-in-loop` a host op (`aten._local_scalar_dense`,
                                what `.item()` records; `nonzero`) inside
                                a `while_loop` body: one device-to-host
                                sync PER ITERATION;
* `audit-unhashable-static`     a non-tensor argument that Dynamo guards
                                by identity: every fresh instance
                                recompiles the step.

Each rule's torch subject, and what has none:

* Tracing is `make_fx` under fake tensors (`tracing_mode="fake"`), the
  tracer AOTAutograd itself uses: no kernel runs and nothing compiles
  (no Inductor, no graftcache entry, no compile wall). A target whose
  inputs require grad (the train step's compiled region) is traced with
  `torch.autograd.grad` of its loss inside the trace, so the graph holds
  the backward too (`t2r.flash_bwd` beside `t2r.flash_fwd`): the joint
  graph AOTAutograd splits. Strict `torch.export` reads the same
  forward graph through Dynamo, at Dynamo's cost, and gives no backward.
* A closed-over tensor — on the CPU or on the card — is a constant of
  the graph in both tracers: `make_fx` installs it as a `get_attr`
  attribute, and Dynamo (strict `torch.export`) lifts it as a tensor
  constant (`graph_signature.inputs_to_lifted_tensor_constants`), as it
  does a tensor made from a numpy table inside the region; a compile
  bakes it the same way. Tensors that share storage with the target
  model's parameters or buffers are not counted.
* Mutation is read from the operators' schemas: an argument annotated
  as written (`Tensor(a!)`: an in-place aten op, or `t2r::decode_tick`'s
  arenas, registered `mutates_args`) that is an input, or a view of one,
  is mutated in place and is not "undonated".
* `torch.export` and `make_fx` trace a `while_loop` whose body calls
  `.item()` (the body graph holds `aten._local_scalar_dense`); a `scan`
  whose body does is refused by the trace (`UncapturedHigherOrderOpError`
  under export), so `scan` bodies with host ops never reach this rule.
* `jax.jit` raises on an unhashable static argument; `torch.compile`
  guards a list or dict argument by value and does not. That half of
  `audit-unhashable-static` has no torch subject. Its identity half
  does: Dynamo guards an argument by identity where the step reads its
  identity (`id(arg)`, a fresh class), and `audit_callable(...,
  static_args=...)` probes it by compiling the function with an eager
  backend and calling it with two instances (this probe RUNS the
  function, twice).

Split exactly like `obs/forge.py`, whose enumeration it reuses: the
PARENT (`audit_config`) touches no device — it enumerates the config's
compiled steps through `forge.plan_from_config`, then hands every
traceable target to ONE fresh worker subprocess (`--worker`), which
builds exactly what the deployment builds, on the spec's device (the
card unless `--device cpu`): `forge.build_rung_engine(..., cache=False)`
+ `rung_traces()` for serving and decode ladders (the arena is built,
no tick runs), `forge.build_train_step(...)` + the step's `region()` for
the trainer. A train step on a mesh of more than one rank is reported
`skipped` (its step needs one process per rank). The worker reports, per
target, the kernel launches counted while it traced (0 when nothing
ran) and per graph its node count, the `t2r.*` operators in it and the
inputs it writes in place.

Findings surface through the graftlint engine: the four rules are
registered in `analysis/engine.py`'s catalog (kind "graph" — catalog/
severity only, the file walk never runs them), anchored on the audited
config file spanning its full length, so one trailing
`# graftlint: disable=<rule>` comment anywhere in the config suppresses
deliberately accepted hits. CLI: `python -m
tensor2robot_tpu_torch.bin.graftscope audit <config.gin>` (exit 0
clean, 1 findings/errors, 2 usage).

`audit_callable(name, fn, args, ...)` is the fixture-test seam: it
audits ONE callable the same way the worker audits a config target.
"""

from __future__ import annotations

import copy
import functools
import json
import os
import subprocess
import sys
import tempfile
import time
import types
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

from tensor2robot_tpu_torch.analysis import engine as engine_lib
from tensor2robot_tpu_torch.analysis.findings import Finding, load_suppressions

__all__ = ["audit_config", "run_targets", "audit_callable", "trace_graph",
           "audit_graph", "graph_stats", "report_findings", "format_report",
           "AUDIT_CONST_BYTES", "AUDIT_STATE_BYTES"]

# A constant this large is a deployment bug, not a scalar epsilon: 1 MiB
# is far above any legitimate baked table in this repo and far below any
# real weight tensor.
AUDIT_CONST_BYTES = 1 << 20
# Inputs at least this large with an output shape twin are "state" for
# the donation rule (parameters, decode arenas — not batch scalars).
AUDIT_STATE_BYTES = 64 << 10

_LOOP_OPS = frozenset({"while_loop", "scan"})
# Host ops: a device-to-host read of a value (what `.item()` and a
# data-dependent shape record).
_HOST_OPS = frozenset({"_local_scalar_dense", "item", "nonzero"})


def _entry(executable: str, rule: str, message: str) -> Dict[str, str]:
  return {"executable": executable, "rule": rule, "message": message}


# ---------------------------------------------------------------------------
# Tracing.
# ---------------------------------------------------------------------------


def _is_tensor(x) -> bool:
  import torch

  return isinstance(x, torch.Tensor)


def _flatten(tree, path: str, out: List[Tuple[str, Any]]):
  """Tensor leaves of nested mappings, lists, tuples and dataclasses,
  with their paths; returns a rebuild function of the leaves' values."""
  if _is_tensor(tree):
    index = len(out)
    out.append((path, tree))
    return lambda values: values[index]
  if hasattr(tree, "__dataclass_fields__"):
    fields = {f: _flatten(getattr(tree, f), f"{path}.{f}", out)
              for f in tree.__dataclass_fields__}
    return lambda values: type(tree)(**{f: r(values)
                                        for f, r in fields.items()})
  if isinstance(tree, Mapping):
    items = [(k, _flatten(v, f"{path}/{k}", out)) for k, v in tree.items()]

    def rebuild_mapping(values):
      new = type(tree)() if hasattr(type(tree), "__setitem__") else {}
      for key, r in items:
        new[key] = r(values)
      return new

    return rebuild_mapping
  if isinstance(tree, (list, tuple)):
    items = [_flatten(v, f"{path}[{i}]", out) for i, v in enumerate(tree)]
    return lambda values: type(tree)(r(values) for r in items)
  return lambda values: tree


def trace_graph(fn, args: Sequence[Any]) -> Dict[str, Any]:
  """Traces `fn(*args)` with `make_fx` on fake tensors (module
  docstring). Returns {"graph": the GraphModule, "inputs": [(arg index,
  path, tensor)] in placeholder order, "outputs": [(shape, dtype)] of
  the forward outputs, "joint": whether the backward was traced}.
  Raises what the trace raises."""
  import torch
  from torch.fx.experimental.proxy_tensor import make_fx

  leaves: List[Tuple[str, Any]] = []
  rebuilders, inputs = [], []
  for i, arg in enumerate(args):
    start = len(leaves)
    rebuilders.append(_flatten(arg, f"arg{i}", leaves))
    inputs.extend((i, path, leaf) for path, leaf in leaves[start:])
  diff = [i for i, (_, leaf) in enumerate(leaves) if leaf.requires_grad]
  joint = bool(diff) and torch.is_grad_enabled()
  forward: List[Tuple[Tuple[int, ...], Any]] = []

  def traced(*values):
    outputs = fn(*[r(values) for r in rebuilders])
    out_leaves: List[Tuple[str, Any]] = []
    _flatten(outputs, "out", out_leaves)
    forward.clear()
    forward.extend((tuple(t.shape), t.dtype) for _, t in out_leaves)
    if not joint:
      return outputs
    loss = out_leaves[0][1]
    grads = torch.autograd.grad(loss, [values[i] for i in diff],
                                allow_unused=True)
    return outputs, tuple(g for g in grads if g is not None)

  graph = make_fx(traced, tracing_mode="fake",
                  _allow_non_fake_inputs=True)(*[leaf for _, leaf in leaves])
  return {"graph": graph, "inputs": inputs, "outputs": list(forward),
          "joint": joint}


def _nbytes(shape, dtype) -> int:
  size = 1
  for dim in shape:
    size *= int(dim)
  return size * dtype.itemsize


def _op_name(target) -> str:
  """`t2r.flash_fwd` for `torch.ops.t2r.flash_fwd.default`; a
  higher-order op's name; else str(target)."""
  packet = getattr(target, "overloadpacket", None)
  if packet is not None:
    return str(packet).replace("torch.ops.", "").replace("::", ".")
  return getattr(target, "__name__", str(target))


def _subgraphs(gm, node):
  """The GraphModules a higher-order op node calls (loop bodies, cond
  branches)."""
  import torch

  for arg in list(node.args) + list(node.kwargs.values()):
    if isinstance(arg, torch.fx.Node) and arg.op == "get_attr":
      value = getattr(gm, arg.target, None)
      if isinstance(value, torch.fx.GraphModule):
        yield value


def _walk(gm, loop: Optional[str], visit) -> None:
  """`visit(gm, node, enclosing loop)` over every call node of `gm` and
  of the graphs its higher-order ops call."""
  for node in gm.graph.nodes:
    if node.op != "call_function":
      continue
    visit(gm, node, loop)
    name = _op_name(node.target)
    for sub in _subgraphs(gm, node):
      _walk(sub, name if name in _LOOP_OPS else loop, visit)


def _constants(gm) -> List[Any]:
  """Tensors the graph (or a graph it calls) holds as attributes."""
  import torch

  out, seen = [], set()

  def visit(module):
    for node in module.graph.nodes:
      if node.op != "get_attr":
        continue
      value = getattr(module, node.target, None)
      if isinstance(value, torch.fx.GraphModule):
        visit(value)
      elif isinstance(value, torch.Tensor) and id(value) not in seen:
        seen.add(id(value))
        out.append(value)

  visit(gm)
  return out


def _mutated_inputs(gm) -> List[int]:
  """Placeholder indices the graph writes in place (directly or through
  a view), read from the operators' schemas."""
  import torch

  placeholders = [n for n in gm.graph.nodes if n.op == "placeholder"]
  index = {n: i for i, n in enumerate(placeholders)}

  def base(node):
    while (isinstance(node, torch.fx.Node) and node.op == "call_function"
           and isinstance(node.target, torch._ops.OpOverload)
           and node.target._schema.returns
           and node.target._schema.returns[0].alias_info is not None
           and not node.target._schema.returns[0].alias_info.is_write
           and node.args):
      node = node.args[0]
    return node

  mutated = set()
  for node in gm.graph.nodes:
    if node.op != "call_function" or not isinstance(
        node.target, torch._ops.OpOverload):
      continue
    for i, arg in enumerate(node.target._schema.arguments):
      if arg.alias_info is None or not arg.alias_info.is_write:
        continue
      value = (node.args[i] if i < len(node.args)
               else node.kwargs.get(arg.name))
      for item in (value if isinstance(value, (list, tuple)) else [value]):
        root = base(item)
        if root in index:
          mutated.add(index[root])
  return sorted(mutated)


def graph_stats(traced: Dict[str, Any]) -> Dict[str, Any]:
  """Node count, `t2r.*` operator counts and the inputs written in place
  of one traced graph (what the chip smoke and the report print)."""
  counts: Dict[str, int] = {}
  nodes = [0]

  def visit(gm, node, loop):
    del gm, loop
    nodes[0] += 1
    name = _op_name(node.target)
    if name.startswith("t2r."):
      counts[name] = counts.get(name, 0) + 1

  _walk(traced["graph"], None, visit)
  return {"nodes": nodes[0], "ops": counts, "joint": traced["joint"],
          "mutated": [traced["inputs"][i][1]
                      for i in _mutated_inputs(traced["graph"])]}


def audit_graph(name: str, traced: Dict[str, Any],
                donate_argnums: Sequence[int] = (),
                exclude: Sequence[Any] = (),
                const_bytes: int = AUDIT_CONST_BYTES,
                state_bytes: int = AUDIT_STATE_BYTES
                ) -> List[Dict[str, str]]:
  """Audits one `trace_graph` result. `exclude`: tensors (the target
  model's parameters and buffers) a constant may share storage with
  without being baked. Returns raw entry dicts — the parent converts
  them to engine Findings."""
  gm = traced["graph"]
  entries: List[Dict[str, str]] = []

  # -- audit-baked-constant ------------------------------------------------
  owned = {(str(t.device), t.untyped_storage().data_ptr()) for t in exclude}
  for const in _constants(gm):
    nbytes = _nbytes(const.shape, const.dtype)
    if nbytes < const_bytes or (
        str(const.device),
        const.untyped_storage().data_ptr()) in owned:
      continue
    entries.append(_entry(
        name, "audit-baked-constant",
        f"a {tuple(const.shape)} {const.dtype} constant "
        f"({nbytes / 2**20:.1f} MiB) is baked into the graph (a tensor "
        "the step closes over or makes from host data: the compiled graph "
        "carries it in every cache entry and no donation reaches it — "
        "pass it as an argument or hold it as a module buffer)"))

  # -- audit-undonated-state -----------------------------------------------
  out_sigs = set(traced["outputs"])
  mutated = set(_mutated_inputs(gm))
  donated = set(int(i) for i in donate_argnums)
  undonated = 0
  undonated_bytes = 0
  for i, (arg_index, _, leaf) in enumerate(traced["inputs"]):
    nbytes = _nbytes(leaf.shape, leaf.dtype)
    if (nbytes >= state_bytes and arg_index not in donated
        and i not in mutated
        and (tuple(leaf.shape), leaf.dtype) in out_sigs):
      undonated += 1
      undonated_bytes += nbytes
  if undonated:
    entries.append(_entry(
        name, "audit-undonated-state",
        f"{undonated} undonated input leaf(ves) totalling "
        f"{undonated_bytes / 2**20:.1f} MiB whose shape/dtype reappears "
        "in the outputs and that the graph does not write in place — "
        "state carried through the step without donate_argnums keeps "
        "BOTH copies live across every call"))

  # -- audit-host-callback-in-loop -----------------------------------------
  hits: List[Tuple[str, str]] = []

  def visit(sub, node, loop):
    del sub
    op = _op_name(node.target).split(".")[-1]
    if loop is not None and op in _HOST_OPS:
      hits.append((op, loop))

  _walk(gm, None, visit)
  for op, loop in hits:
    entries.append(_entry(
        name, "audit-host-callback-in-loop",
        f"host op {op!r} inside a {loop!r} body: one device-to-host "
        "sync PER ITERATION, serialized against the stream — hoist it "
        "out of the loop or keep the value on the device"))
  return entries


def _identity_probe(fn, key: str):
  """`(*args, value) -> fn(*args, **{key: value})` with a code object of
  its own: Dynamo caches compiled frames per code object, so a probe
  never reuses another probe's graphs."""

  def probe(*args):
    return fn(*args[:-1], **{key: args[-1]})

  return types.FunctionType(probe.__code__.replace(), probe.__globals__,
                            "probe", probe.__defaults__, probe.__closure__)


def _audit_static_args(name: str, fn, args: Sequence[Any],
                       static_args: Mapping[str, Any]
                       ) -> List[Dict[str, str]]:
  """The identity half of `audit-unhashable-static` (module docstring):
  per static keyword argument, `fn(*args, **{key: value})` compiled with
  an eager backend is called with `value` and with a copy of it; a
  second graph means Dynamo guards the argument by identity."""
  import torch

  entries: List[Dict[str, str]] = []
  for arg_name in sorted(static_args):
    value = static_args[arg_name]
    try:
      twin = copy.copy(value)
    except Exception:  # noqa: BLE001 - an uncopyable value is not probed
      continue
    graphs = [0]

    def backend(gm, example_inputs):
      del example_inputs
      graphs[0] += 1
      return gm

    compiled = torch.compile(_identity_probe(fn, arg_name), backend=backend,
                             dynamic=False)
    for instance in (value, twin):
      compiled(*args, instance)
    if graphs[0] > 1:
      entries.append(_entry(
          name, "audit-unhashable-static",
          f"static arg {arg_name!r} ({type(value).__name__}) is guarded "
          f"by object identity — a fresh instance recompiled the step "
          f"({graphs[0]} graphs for 2 instances), a silent recompile per "
          "construction; let the step read its value, not its identity"))
  return entries


def audit_callable(name: str, fn, args: Sequence[Any],
                   donate_argnums: Sequence[int] = (),
                   static_args: Optional[Mapping[str, Any]] = None,
                   exclude: Sequence[Any] = ()) -> List[Dict[str, str]]:
  """Audits ONE callable exactly as the worker audits a config target
  (the fixture-test seam). `static_args` is a name->value mapping of
  keyword arguments, bound for the trace and audited for identity
  guards (the probe runs `fn`; module docstring)."""
  static_args = dict(static_args or {})
  entries = _audit_static_args(name, fn, args, static_args)
  traced = trace_graph(functools.partial(fn, **static_args), args)
  entries.extend(audit_graph(name, traced,
                             donate_argnums=donate_argnums, exclude=exclude))
  return entries


# ---------------------------------------------------------------------------
# Worker side (fresh subprocess; the only half that touches a device —
# the obs/forge.py split).
# ---------------------------------------------------------------------------


def _launch_count() -> int:
  """Kernel launches counted by the port's kernel wrappers so far."""
  from tensor2robot_tpu_torch.ops import attention
  from tensor2robot_tpu_torch.ops import batch_norm
  from tensor2robot_tpu_torch.ops import decode_kernels

  return (attention.flash_forward.launches
          + attention.flash_backward.launches_dq
          + attention.flash_backward.launches_dkv
          + attention.flash_backward.launches_split
          + decode_kernels.fused_decode_attention.launches
          + batch_norm.batch_norm_train.launches)


def _model_tensors(model) -> List[Any]:
  module = getattr(model, "module", None)
  if module is None or not hasattr(module, "parameters"):
    return []
  return list(module.parameters()) + list(module.buffers())


def _audit_one(exe: str, fn, args, donate_argnums=(), exclude=()
               ) -> Tuple[List[Dict[str, str]], Dict[str, Any]]:
  traced = trace_graph(fn, args)
  return (audit_graph(exe, traced, donate_argnums=donate_argnums,
                      exclude=exclude),
          dict(graph_stats(traced), executable=exe))


def _audit_target(spec: Dict[str, Any],
                  target: Dict[str, Any]) -> Dict[str, Any]:
  import torch

  from tensor2robot_tpu_torch.obs import forge
  from tensor2robot_tpu_torch.serving import session as session_lib

  findings: List[Dict[str, str]] = []
  graphs: List[Dict[str, Any]] = []
  start, launches = time.perf_counter(), _launch_count()
  base = {"name": target["name"], "family": target["family"]}
  try:
    if target["family"] in ("serve", "session"):
      engine = forge.build_rung_engine(spec, target, cache=False)
      exclude = _model_tensors(getattr(engine._predictor, "model", None))
      for rung, fn, args in engine.rung_traces():
        if target["family"] == "session":
          exe = (f"{target['name']}/reset_slot" if rung == "reset"
                 else f"{target['name']}/decode{rung}")
          donate = session_lib._ARENA_ARGNUMS[rung == "reset"]
        else:
          exe, donate = f"{target['name']}/bucket{rung}", ()
        with torch.no_grad():  # as the engines run (and compile) rungs
          entries, stats = _audit_one(exe, fn, args, donate, exclude)
        findings.extend(entries)
        graphs.append(stats)
    elif target["family"] == "train":
      if target.get("mesh_shape"):
        return dict(base, status="skipped",
                    reason="a train step on a mesh of more than one rank "
                           "runs one process per rank; the audit traces "
                           "one device's step")
      model, step, args = forge.build_train_step(spec, target)
      fn, region_args = step.region(*args)
      entries, stats = _audit_one(target["name"], fn, region_args,
                                  exclude=_model_tensors(model))
      findings.extend(entries)
      graphs.append(stats)
    else:
      return dict(base, status="skipped",
                  reason="no trace recipe for this family")
  except Exception as e:  # noqa: BLE001 - one bad target != a dead audit
    return dict(base, status="error", error=f"{type(e).__name__}: {e}")
  return dict(base, status="ok", findings=findings, graphs=graphs,
              launches=_launch_count() - launches,
              wall_s=round(time.perf_counter() - start, 3))


def _worker_main(spec_path: str, result_path: str) -> int:
  with open(spec_path) as f:
    spec = json.load(f)
  from tensor2robot_tpu_torch.utils import config

  config.clear_config()
  config.parse_config_files_and_bindings(list(spec["config_files"]),
                                         list(spec["bindings"]))
  results = [_audit_target(spec, target) for target in spec["targets"]]
  with open(result_path, "w") as f:
    json.dump(results, f)
  return 0 if all(r["status"] != "error" for r in results) else 1


# ---------------------------------------------------------------------------
# Parent side (no device).
# ---------------------------------------------------------------------------


def run_targets(plan: Dict[str, Any], targets: List[Dict[str, Any]],
                device: str = "cuda", device_count: Optional[int] = None,
                timeout_s: float = 600.0) -> List[Dict[str, Any]]:
  """Audits `targets` of `plan` in one worker subprocess on `device`;
  returns the per-target results (an error result per target when the
  worker dies without one)."""
  from tensor2robot_tpu_torch.obs import forge

  if not targets:
    return []
  env = forge._worker_env()
  if device_count and "CUDA_VISIBLE_DEVICES" not in env:
    env["CUDA_VISIBLE_DEVICES"] = ",".join(str(i)
                                           for i in range(device_count))
  with tempfile.TemporaryDirectory(prefix="graftaudit-") as tmp:
    spec = {
        "config_files": plan["config_files"],
        "bindings": plan["bindings"],
        "model": plan.get("model"),
        "model_dir": plan.get("model_dir"),
        "device": device,
        "targets": targets,
    }
    spec_path = os.path.join(tmp, "spec.json")
    result_path = os.path.join(tmp, "result.json")
    with open(spec_path, "w") as f:
      json.dump(spec, f)
    proc = subprocess.Popen(
        [sys.executable, "-m", "tensor2robot_tpu_torch.analysis.graph_audit",
         "--worker", spec_path, result_path], env=env)
    try:
      proc.wait(timeout=timeout_s)
    except subprocess.TimeoutExpired:
      proc.terminate()
      try:
        proc.wait(timeout=30)
      except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
    if os.path.isfile(result_path):
      try:
        with open(result_path) as f:
          return json.load(f)
      except (OSError, ValueError):
        pass
    return [{"name": t["name"], "family": t["family"], "status": "error",
             "error": f"audit worker exited {proc.returncode} without "
                      "a result"} for t in targets]


def report_findings(plan: Dict[str, Any],
                    results: Sequence[Dict[str, Any]]) -> List[Finding]:
  """Worker entries -> engine-catalogued Findings, anchored on the
  first audited config file and spanning its full length — so a
  trailing `# graftlint: disable=<rule>` comment on ANY line of the
  config suppresses a deliberately accepted hit (file-level
  suppression, the same `findings.Suppressions` model every graftlint
  rule uses)."""
  anchor = (plan.get("config_files") or ["<config>"])[0]
  try:
    with open(anchor, encoding="utf-8", errors="replace") as f:
      text = f.read()
  except OSError:
    text = ""
  end_line = max(1, text.count("\n") + 1)
  raw = [Finding(path=anchor, line=1, rule=entry["rule"],
                 message=f"{entry['executable']}: {entry['message']}",
                 end_line=end_line)
         for result in results
         for entry in (result.get("findings") or [])]
  supps = load_suppressions(text)
  kept = [f for f in raw if supps.match(f.line, f.rule, f.end_line) is None]
  return sorted(kept, key=lambda f: (f.path, f.rule, f.message))


def audit_config(config_files: Sequence[str],
                 bindings: Sequence[str] = (),
                 model: Optional[str] = None,
                 export_dir: Optional[str] = None,
                 model_dir: Optional[str] = None,
                 device: str = "cuda",
                 device_count: Optional[int] = None,
                 timeout_s: float = 600.0
                 ) -> Tuple[Dict[str, Any], List[Dict[str, Any]],
                            List[Finding]]:
  """Audits every compiled step a research config deploys.

  Device-free in THIS process: enumeration is `forge.plan_from_config`
  and all tracing happens in one worker subprocess on `device`
  (`device_count` limits the cards it sees). Returns `(plan, per-target
  results, findings)` — findings already filtered through the config's
  suppression comments."""
  from tensor2robot_tpu_torch.obs import forge

  plan = forge.plan_from_config(config_files, bindings, model=model,
                                export_dir=export_dir,
                                model_dir=model_dir)
  targets = [t for t in plan["targets"]
             if t["family"] in ("serve", "session", "train")]
  results = run_targets(plan, targets, device, device_count, timeout_s)
  return plan, results, report_findings(plan, results)


def format_report(plan: Dict[str, Any],
                  results: Sequence[Dict[str, Any]],
                  findings: Sequence[Finding]) -> str:
  """The `graftscope audit` summary table (format_plan's sibling)."""
  lines = [f"graftaudit: {', '.join(plan['config_files'])} "
           f"(model: {json.dumps(plan.get('model'))})"]
  for result in results:
    status = result["status"]
    detail = (result.get("error") or result.get("reason")
              or f"{len(result.get('findings') or [])} finding(s), "
                 f"{result.get('launches', 0)} kernel launch(es), "
                 f"{result.get('wall_s', 0.0):.1f} s")
    lines.append(f"  {result['family']:<9}{result['name']:<18}"
                 f"{status:>8}  {detail}")
    for graph in result.get("graphs") or []:
      ops = ", ".join(f"{k} x{v}" for k, v in sorted(graph["ops"].items()))
      lines.append(f"    {graph['executable']:<28}{graph['nodes']:>6} "
                   f"nodes  {ops or 'no t2r ops'}"
                   + (f"; in place: {', '.join(graph['mutated'])}"
                      if graph["mutated"] else ""))
  lines.append(f"  {len(findings)} finding(s) after suppressions")
  return "\n".join(lines)


engine_lib.register(engine_lib.Rule(
    name="audit", kind="graph",
    scope="compiled steps, via `graftscope audit <config>`",
    family="audit",
    infos=(
        engine_lib.RuleInfo(
            id="audit-baked-constant", severity="warning",
            doc=("a large tensor is a constant of a compiled\n"
                 "step's graph (closed over or made from host\n"
                 "data: carried by every cache entry, never\n"
                 "donated)"),
            meaning=("a large tensor is a constant of a compiled step's "
                     "graph — closed over or made from host data, it is "
                     "carried by every cache entry and never donated")),
        engine_lib.RuleInfo(
            id="audit-undonated-state", severity="warning",
            doc=("a state-sized input whose shape/dtype reappears\n"
                 "in the outputs is neither donated nor written in\n"
                 "place (two live copies per call)"),
            meaning=("a state-sized input whose shape/dtype reappears "
                     "in the outputs is neither donated nor written in "
                     "place — two live copies per call")),
        engine_lib.RuleInfo(
            id="audit-host-callback-in-loop", severity="warning",
            doc=("a host op (.item()) inside a while_loop body:\n"
                 "one device-to-host sync PER ITERATION"),
            meaning=("a host op (`.item()`'s `_local_scalar_dense`) "
                     "inside a `while_loop` body — one device-to-host "
                     "sync per iteration")),
        engine_lib.RuleInfo(
            id="audit-unhashable-static", severity="warning",
            doc=("a static arg Dynamo guards by identity (a\n"
                 "silent recompile per fresh instance)"),
            meaning=("a static arg Dynamo guards by object identity — a "
                     "silent recompile per fresh instance")),
    )))


if __name__ == "__main__":
  if len(sys.argv) == 4 and sys.argv[1] == "--worker":
    sys.exit(_worker_main(sys.argv[2], sys.argv[3]))
  print("usage: python -m tensor2robot_tpu_torch.analysis.graph_audit "
        "--worker <spec.json> <result.json>\n(operators drive the audit "
        "through `python -m tensor2robot_tpu_torch.bin.graftscope audit`)",
        file=sys.stderr)
  sys.exit(2)
