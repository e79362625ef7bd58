"""graftscope-xray: compile, cost and memory introspection of a step.

The port of the JAX package's `obs.xray`. The JAX package AOT-compiles a
jitted step and reads XLA's cost and memory analysis; the port's
compiled step is a `torch.compile` graph:

* `analyze_jit(name, fn, *args)` compiles `fn` with `torch.compile`
  (`fullgraph=True`, `dynamic=False`; Inductor on CUDA, `aot_eager` on the
  CPU, the table `COMPILE_BACKENDS`), runs the call that compiles it and
  returns (compiled, record, outputs): torch compiles at the first call,
  so that call is a real one and its outputs are handed back rather than
  computed twice. A `fn` with a `compile_with(compile)` method (the train
  step, `parallel.train_step`) compiles its own regions with the given
  `compile`, so a step whose backward runs outside Dynamo still has its
  forward, loss and (through AOTAutograd) backward compiled. The record
  keeps the JAX package's keys: `compile_s` (the first call's wall:
  Dynamo's capture, AOTAutograd and the backend for the forward, the
  backward's compile, which AOTAutograd defers to the first backward at
  static shapes, and the run; the number a warm cache must lower),
  `trace_s` and `lower_s` (0: torch has no separate stages, so
  `compile_time_s` in `obs.runlog` is the first call's wall), `backend_s`
  (the part of it inside the forward's backend), `jaxpr_eqns`
  (the nodes of the captured FX graphs), `donated_bytes` /
  `undonated_bytes` (by `donate_argnums`: the arguments updated in
  place), `flops` (`FlopCounterMode` over the call, run on fake tensors,
  with the kernels' registered formulas; `flops_upper_bound` names the
  operators of `UPPER_BOUND_FLOP_OPS` it counted, whose formulas give the
  most the call can need, so `flops` and what is derived from it are
  upper bounds), `bytes_accessed` (None: nothing
  reports it), `temp_bytes` (the peak bytes live at once among the
  tensors that call's operations create, on fake tensors: it never
  touches the allocator, so the run record's allocator peak stays the
  run's own) and, priced against the H100's peaks (`utils.backend`),
  `arithmetic_intensity`, `roofline_ms`, `peak_flops`, `peak_hbm_bw` over
  `io_bytes` (each argument read once, each output written once). It
  adds `graph_breaks` (Dynamo's count over the call: with `fullgraph` a
  break fails the compile instead, so a compiled step has none) and
  `graphs`.
* `XrayedFunction` compiles on its first call and runs the compiled step
  after. It keeps the JAX package's degrade contract: a failed analysis
  counts `xray/analyze_failures` and runs the plain (eager) step from
  then on; a later call whose recompile fails counts
  `xray/compiled_call_fallbacks` and runs it eagerly; an error while the
  compiled step executes is raised. The eager step runs on the same
  device through the same kernels. A step on a mesh of more than one rank
  is not compiled (`obs.excache.mesh_compile_unsafe`; `cache/skipped_mesh`).
  Each later compile of the same function is counted in
  `xray/recompiles`.
* `memory_accounting` prices a `TrainState` (+ batch) in bytes and
  `hbm_watermark_estimate` turns it into the run record's per-device
  watermark estimate: resident state + resident batch + the step's
  scratch (a compile record's `temp_bytes` when there is one, else the
  parameter bytes again). `pytree_shard_bytes` and `analytic_mfu` are the
  JAX package's.

Records land in the process-wide metrics registry (`xray/<name>/...`), in
a module-level collector drained into `obs.runlog` run records, and in
the caller's hands. torch is imported only inside the functions.
"""

from __future__ import annotations

import contextlib
import logging
import threading
import time
import weakref
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

from tensor2robot_tpu_torch.obs import metrics as metrics_lib
from tensor2robot_tpu_torch.utils import backend as backend_lib

__all__ = ["analyze_jit", "XrayedFunction", "memory_accounting",
           "hbm_watermark_estimate", "analytic_mfu", "pytree_bytes",
           "pytree_shard_bytes", "records", "clear_records",
           "step_cache_key", "COMPILE_BACKENDS"]

# The compiler backend by device type. Inductor on the card; on the CPU
# `aot_eager`, which traces through the same operators (the kernels'
# fake implementations included) and runs the same aten ops, at a
# compile cost of seconds. Tests that need Inductor on the CPU patch it.
COMPILE_BACKENDS = {"cuda": "inductor", "cpu": "aot_eager"}

# Dynamo keeps one cache per code object: every engine rung and replica
# compiles the same predict function. The limit is raised to this many
# entries at the first compile, so that a ladder never falls back.
_RECOMPILE_LIMIT = 64

_RECORDS: List[Dict[str, Any]] = []
_LOCK = threading.Lock()
_log = logging.getLogger(__name__)


def records() -> List[Dict[str, Any]]:
  """Compile records collected since the last `clear_records()`."""
  with _LOCK:
    return list(_RECORDS)


def clear_records() -> None:
  """Drops collected records (run start, alongside trace/metrics reset)."""
  with _LOCK:
    _RECORDS.clear()


def _collect(record: Dict[str, Any]) -> None:
  with _LOCK:
    _RECORDS.append(record)


def _leaves(tree) -> List[Any]:
  """The leaves of nested dicts, lists and tuples (a tensor or array, or
  anything else, is a leaf)."""
  if isinstance(tree, Mapping):
    return [leaf for value in tree.values() for leaf in _leaves(value)]
  if isinstance(tree, (list, tuple)):
    return [leaf for value in tree for leaf in _leaves(value)]
  if tree is None:
    return []
  if hasattr(tree, "__dataclass_fields__"):
    return [leaf for field in tree.__dataclass_fields__
            for leaf in _leaves(getattr(tree, field))]
  return [tree]


def _leaf_nbytes(leaf) -> int:
  """Logical bytes of one tensor or array leaf (0 for anything else)."""
  nbytes = getattr(leaf, "nbytes", None)
  if nbytes is not None:
    return int(nbytes)
  shape = getattr(leaf, "shape", None)
  itemsize = getattr(getattr(leaf, "dtype", None), "itemsize", None)
  if shape is None or itemsize is None:
    return 0
  size = 1
  for dim in shape:
    size *= int(dim)
  return size * int(itemsize)


def pytree_bytes(tree) -> int:
  """Total logical bytes over every tensor/array leaf of `tree`."""
  return sum(_leaf_nbytes(x) for x in _leaves(tree))


def pytree_shard_bytes(tree) -> int:
  """Per-device bytes over every leaf: a rank of the port holds only its
  own blocks, so its leaves' bytes are already per shard."""
  return pytree_bytes(tree)


def analytic_mfu(flops: float, step_sec: float,
                 peak_flops: float = backend_lib.H100_PEAK_BF16_FLOPS
                 ) -> float:
  """Model FLOP utilization: the step's FLOPs over (time x device peak)."""
  return flops / max(step_sec, 1e-12) / peak_flops


def memory_accounting(state=None, batch=None) -> Dict[str, float]:
  """Prices a TrainState (+ optional batch) in bytes under the JAX
  package's keys (`<field>_bytes` and, equal on one device,
  `<field>_bytes_per_shard`). `state` is duck-typed on the TrainState
  fields (`params`, `opt_state`, `ema_params`, `mutable_state`); any may
  be absent."""
  out: Dict[str, float] = {}
  state_total = 0
  for field, key in (("params", "params"), ("opt_state", "opt_state"),
                     ("ema_params", "ema"), ("mutable_state", "mutable")):
    tree = getattr(state, field, None)
    if tree is None:
      continue
    total = pytree_bytes(tree)
    out[f"{key}_bytes"] = out[f"{key}_bytes_per_shard"] = float(total)
    state_total += total
  if state is not None:
    out["state_bytes"] = out["state_bytes_per_shard"] = float(state_total)
  if batch is not None:
    out["batch_bytes"] = out["batch_bytes_per_shard"] = float(
        pytree_bytes(batch))
  return out


def hbm_watermark_estimate(memory: Dict[str, float],
                           compile_records=()) -> float:
  """Per-device watermark estimate in bytes: resident state + resident
  batch + the step's scratch — a compile record's `temp_bytes` when one
  reports it, else the parameter bytes again (the gradient buffers a
  train step materializes, the floor for any backward pass)."""
  temp = max((float(r.get("temp_bytes") or 0.0) for r in compile_records),
             default=0.0)
  scratch = max(temp, memory.get("params_bytes_per_shard", 0.0))
  return (memory.get("state_bytes_per_shard", 0.0)
          + memory.get("batch_bytes_per_shard", 0.0) + scratch)


# ---------------------------------------------------------------------------
# Compile telemetry.
# ---------------------------------------------------------------------------


def _first_device(tree):
  """The device of the first tensor leaf of `tree` (None without one)."""
  for leaf in _leaves(tree):
    device = getattr(leaf, "device", None)
    if device is not None and hasattr(leaf, "dtype"):
      return device
  return None


class _GraphCounter:
  """A `torch.compile` backend that counts the graphs Dynamo captures,
  their FX nodes and its own time, and hands each graph to the real
  backend (Inductor or `aot_eager`)."""

  def __init__(self, backend: str):
    self.backend = backend
    self.graphs = 0
    self.nodes = 0
    self.seconds = 0.0

  def __call__(self, gm, example_inputs):
    import torch

    start = time.perf_counter()
    self.graphs += 1
    self.nodes += sum(1 for node in gm.graph.nodes
                      if node.op not in ("placeholder", "output"))
    compiled = torch._dynamo.lookup_backend(self.backend)(gm, example_inputs)
    self.seconds += time.perf_counter() - start
    return compiled


def _graph_breaks() -> int:
  import torch

  return int(sum(torch._dynamo.utils.counters["graph_break"].values()))


class _LiveBytes:
  """A dispatch mode that tracks the bytes held by the tensors the
  operations under it create, and their peak (storages counted once,
  views free)."""

  def __init__(self):
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    tracker = self
    self.live = 0
    self.peak = 0
    self._refs: Dict[int, int] = {}

    def release(key, nbytes):
      tracker._refs[key] -= 1
      if not tracker._refs[key]:
        del tracker._refs[key]
        tracker.live -= nbytes

    class Mode(TorchDispatchMode):
      def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for leaf in _leaves(out if isinstance(out, (list, tuple)) else [out]):
          if not isinstance(leaf, torch.Tensor):
            continue
          storage = leaf.untyped_storage()
          key = storage._cdata
          if key not in tracker._refs:
            tracker._refs[key] = 0
            tracker.live += storage.nbytes()
            tracker.peak = max(tracker.peak, tracker.live)
          tracker._refs[key] += 1
          weakref.finalize(leaf, release, key, storage.nbytes())
        return out

    self.mode = Mode()


# Operators whose registered flop formula is the most the call can need,
# not what it does: the decode tick attends each lane's index + 1
# positions, which its shapes do not carry, so it counts all T.
UPPER_BOUND_FLOP_OPS = ("t2r.decode_tick",)


def _fake_profile(fn, args) -> Tuple[Optional[float], Optional[float],
                                     List[str]]:
  """(flops, temp_bytes, upper-bound ops) of one call of `fn` on fake
  copies of `args`: `FlopCounterMode` (the kernels' operators count by
  their registered formulas), the peak of `_LiveBytes`, and which of
  `UPPER_BOUND_FLOP_OPS` the count holds. No device work, no allocator
  traffic. (None, None, []) when the call cannot run on fake tensors."""
  import torch
  from torch._subclasses.fake_tensor import FakeTensorMode
  from torch.utils.flop_counter import FlopCounterMode

  try:
    with FakeTensorMode(allow_non_fake_inputs=True) as fake_mode:
      memo: Dict[int, Any] = {}

      def fake(tree):
        if isinstance(tree, torch.Tensor):
          if id(tree) not in memo:
            memo[id(tree)] = fake_mode.from_tensor(tree)
          return memo[id(tree)]
        if hasattr(tree, "__dataclass_fields__"):
          return type(tree)(**{f: fake(getattr(tree, f))
                               for f in tree.__dataclass_fields__})
        if isinstance(tree, Mapping):
          out = type(tree)() if hasattr(type(tree), "__setitem__") else {}
          for key, value in tree.items():
            out[key] = fake(value)
          return out
        if isinstance(tree, (list, tuple)):
          return type(tree)(fake(v) for v in tree)
        return tree

      fake_args = fake(tuple(args))
      live = _LiveBytes()
      with FlopCounterMode(display=False) as flops, live.mode:
        fn(*fake_args)
      counted = {str(op) for op in flops.get_flop_counts().get("Global",
                                                                {})}
      return (float(flops.get_total_flops()), float(live.peak),
              [op for op in UPPER_BOUND_FLOP_OPS if op in counted])
  except Exception:  # noqa: BLE001 - cost analysis is optional, as in JAX
    return None, None, []


def _compile_region(counter: _GraphCounter) -> Callable:
  """`torch.compile` as the X-ray compiles: whole graphs, static shapes,
  through the counting backend."""
  import torch

  def compile_fn(fn):
    return torch.compile(fn, backend=counter, fullgraph=True, dynamic=False)

  return compile_fn


def _raise_recompile_limit() -> None:
  import torch

  config = torch._dynamo.config
  for name in ("recompile_limit", "cache_size_limit"):
    if hasattr(config, name):
      setattr(config, name, max(int(getattr(config, name)), _RECOMPILE_LIMIT))
      break
  if hasattr(config, "accumulated_recompile_limit"):
    config.accumulated_recompile_limit = max(
        int(config.accumulated_recompile_limit), 4 * _RECOMPILE_LIMIT)


def _backend_for(args) -> Tuple[Any, str]:
  """(device of the first tensor of `args`, the compile backend for it)."""
  device = _first_device(args)
  return device, COMPILE_BACKENDS.get(getattr(device, "type", "cpu"),
                                      COMPILE_BACKENDS["cpu"])


def step_cache_key(name: str, args, model=None,
                   donate_argnums: Tuple[int, ...] = (), mesh=None
                   ) -> Tuple[str, Dict[str, str]]:
  """(key, components): the graftcache key `analyze_jit` looks up for
  `name` at `args`, computed without compiling (the engines'
  `rung_cache_keys`, the forge's `--verify`)."""
  from tensor2robot_tpu_torch.obs import excache as excache_lib

  device, backend = _backend_for(args)
  components = excache_lib.key_components(
      args, model=model, donate_argnums=donate_argnums, device=device,
      mesh=mesh, backend=backend)
  return excache_lib.cache_key(name, **components), components


def analyze_jit(name: str, fn, *args,
                registry: Optional[metrics_lib.Registry] = None,
                collect: bool = True, cache=None, model=None,
                donate_argnums: Tuple[int, ...] = (), mesh=None
                ) -> Tuple[Callable, Dict[str, Any], Any]:
  """Compiles `fn` at `args` with `torch.compile`, instrumented (module
  docstring); returns (compiled, record, outputs of the compiling call).

  `cache` (an `obs.excache.ExecutableCache` or a directory) keys the
  step by `excache.key_components` (the args, `model`,
  `donate_argnums`, the device, `mesh`, the versions and the kernels).
  On a hit the entry's artifacts are loaded into the compiler's caches
  before the compile, and the record carries a `cache` block `{hit,
  key, load_ms, bytes}` and the cold process's `compile_s` as
  `cold_compile_s`; on a miss the compile runs isolated
  (`excache.compile_isolated`) and its artifacts are stored. Cache
  trouble of any kind compiles fresh and is counted.

  Raises when the compile fails (callers that must not die use
  `XrayedFunction`)."""
  import torch

  from tensor2robot_tpu_torch.obs import excache as excache_lib

  reg = registry or metrics_lib.get_registry()
  cache = excache_lib.as_cache(cache)
  device, backend = _backend_for(args)
  _raise_recompile_limit()

  cache_key = components = entry = None
  if cache is not None:
    try:
      cache_key, components = step_cache_key(name, args, model,
                                             donate_argnums, mesh)
    except Exception as e:  # noqa: BLE001 - key trouble = no caching
      reg.counter("cache/key_failures").inc()
      _log.warning("graftcache: key for %r failed (%s: %s); compiling "
                   "fresh", name, type(e).__name__, e)
    if cache_key is not None:
      entry = cache.load(cache_key)

  counter = _GraphCounter(backend)
  compile_fn = _compile_region(counter)
  compiled = (fn.compile_with(compile_fn) if hasattr(fn, "compile_with")
              else compile_fn(fn))
  storing = cache_key is not None and entry is None
  breaks_before = _graph_breaks()
  with (excache_lib.compile_isolated() if storing
        else contextlib.nullcontext()):
    start = time.perf_counter()
    outputs = compiled(*args)
    backend_lib.sync(outputs)
    first_call_s = time.perf_counter() - start
    blob = None
    if storing:
      try:
        saved = torch.compiler.save_cache_artifacts()
        blob = saved[0] if saved else None
      except Exception as e:  # noqa: BLE001 - an unsavable compile stores
        # an empty entry (`cache/bypassed`), never breaks the run.
        _log.warning("graftcache: artifacts of %r unavailable (%s)",
                     name, e)
  graph_breaks = _graph_breaks() - breaks_before
  flops, temp_bytes, upper_ops = _fake_profile(fn, args)
  donated = sum(pytree_bytes(args[i]) for i in donate_argnums
                if i < len(args))
  io_bytes = float(pytree_bytes(args) + pytree_bytes(outputs))
  record: Dict[str, Any] = {
      "name": name,
      "backend": backend,
      "device": str(device) if device is not None else "cpu",
      "trace_s": 0.0,
      "lower_s": 0.0,
      "compile_s": first_call_s,
      "backend_s": counter.seconds,
      "jaxpr_eqns": counter.nodes,
      "graphs": counter.graphs,
      "graph_breaks": graph_breaks,
      "donated_bytes": float(donated),
      "undonated_bytes": float(pytree_bytes(args) - donated),
      "flops": flops,
      "bytes_accessed": None,
      "io_bytes": io_bytes,
      "temp_bytes": temp_bytes,
  }
  if upper_ops:
    # `flops`, `arithmetic_intensity` and `roofline_ms` are upper bounds.
    record["flops_upper_bound"] = upper_ops
  if flops is not None and io_bytes:
    record["arithmetic_intensity"] = flops / io_bytes
    record["roofline_ms"] = 1e3 * max(
        flops / backend_lib.H100_PEAK_BF16_FLOPS,
        io_bytes / backend_lib.H100_PEAK_HBM_BW)
    record["peak_flops"] = backend_lib.H100_PEAK_BF16_FLOPS
    record["peak_hbm_bw"] = backend_lib.H100_PEAK_HBM_BW
  if entry is not None:
    record["cold_compile_s"] = entry["record"].get("compile_s")
    record["cache"] = {"hit": True, "key": cache_key,
                       "load_ms": entry["load_ms"], "bytes": entry["bytes"]}
    reg.gauge(f"xray/{name}/cache_load_ms").set(entry["load_ms"])
  elif storing:
    stored = cache.store(cache_key, blob, record=record, name=name,
                         components=components)
    record["cache"] = {"hit": False, "key": cache_key, "stored": stored,
                       "bytes": len(blob or b"")}
  reg.counter("xray/analyses").inc()
  reg.gauge(f"xray/{name}/compile_s").set(record["compile_s"])
  reg.gauge(f"xray/{name}/jaxpr_eqns").set(float(record["jaxpr_eqns"]))
  reg.gauge(f"xray/{name}/graph_breaks").set(float(graph_breaks))
  reg.gauge(f"xray/{name}/donated_bytes").set(float(donated))
  if flops is not None:
    reg.gauge(f"xray/{name}/flops").set(flops)
  if collect:
    _collect(record)
  compiled.graph_counter = counter
  return compiled, record, outputs


def _compile_error_types() -> Tuple[type, ...]:
  """The exceptions a (re)compile raises: Dynamo's own and a backend's."""
  import torch

  return (torch._dynamo.exc.TorchDynamoException,)


class XrayedFunction:
  """Compiles a step on its first call; never breaks the call (module
  docstring). `name`, `cache`, `model`, `donate_argnums` and `mesh` go to
  `analyze_jit`."""

  def __init__(self, name: str, fn,
               registry: Optional[metrics_lib.Registry] = None,
               cache=None, model=None,
               donate_argnums: Tuple[int, ...] = (), mesh=None):
    self._name = name
    self._fn = fn
    self._registry = registry or metrics_lib.get_registry()
    self._cache = cache
    self._model = model
    self._donate_argnums = tuple(donate_argnums)
    self._mesh = mesh
    self._compiled = None
    self._record: Optional[Dict[str, Any]] = None
    self._failed = False
    self._graphs_at_warmup = 0
    self._lock = threading.Lock()

  @property
  def record(self) -> Optional[Dict[str, Any]]:
    return self._record

  @property
  def compiled(self) -> bool:
    """True once the step runs compiled."""
    return self._compiled is not None

  @property
  def recompiles(self) -> int:
    """Graphs compiled after the first call (0 when every later call
    reused the first call's graphs)."""
    counter = getattr(self._compiled, "graph_counter", None)
    return 0 if counter is None else counter.graphs - self._graphs_at_warmup

  def _first_call(self, args):
    from tensor2robot_tpu_torch.obs import excache as excache_lib

    if excache_lib.mesh_compile_unsafe(self._mesh):
      self._registry.counter("cache/skipped_mesh").inc()
      self._failed = True
      return self._fn(*args)
    try:
      compiled, record, outputs = analyze_jit(
          self._name, self._fn, *args, registry=self._registry,
          cache=self._cache, model=self._model,
          donate_argnums=self._donate_argnums, mesh=self._mesh)
    except _compile_error_types() as e:
      self._failed = True
      self._registry.counter("xray/analyze_failures").inc()
      _log.warning("graftscope-xray: compiling %r failed (%s: %s); "
                   "running the eager step", self._name,
                   type(e).__name__, e)
      return self._fn(*args)
    self._compiled, self._record = compiled, record
    self._graphs_at_warmup = compiled.graph_counter.graphs
    return outputs

  def __call__(self, *args):
    with self._lock:
      if self._compiled is None and not self._failed:
        return self._first_call(args)
    compiled = self._compiled
    if compiled is None:
      return self._fn(*args)
    graphs = compiled.graph_counter.graphs
    try:
      outputs = compiled(*args)
    except _compile_error_types():
      # The recompile at new arguments failed before anything ran: run
      # the eager step from now on. An error of the step itself is not
      # a compile error and is raised.
      with self._lock:
        self._compiled = None
        self._failed = True
      self._registry.counter("xray/compiled_call_fallbacks").inc()
      return self._fn(*args)
    if compiled.graph_counter.graphs != graphs:
      self._registry.counter("xray/recompiles").inc(
          compiled.graph_counter.graphs - graphs)
    return outputs
