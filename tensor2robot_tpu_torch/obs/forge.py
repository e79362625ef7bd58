"""graftforge: the compile farm that warms every compiled step a
deployment needs before any process of it starts.

The port of the JAX package's `obs.forge`. Three layers:

* ENUMERATION (`plan_from_config`, no device): from a parsed config
  alone (no device, no checkpoint, no traffic) the complete set of
  compiled steps the deployment needs: every `BucketedEngine` rung (per
  replica where the fleet places replicas on their own devices, once
  where they share a namespace), every `SessionEngine` decode rung and
  the slot reset, the train step, the eval step. Targets the port cannot
  compile or cache are enumerated as UNFORGEABLE with the reason: a train
  step on a mesh of more than one rank (`excache.mesh_compile_unsafe`),
  and the eval step (eager in the port; a plain jit the JAX farm leaves
  to its XLA-cache tier).
* THE FARM (`run_forge`): one fresh worker process per forgeable target,
  `jobs` at a time. A worker builds exactly what the live process builds
  (predictor and engine for rungs, state and step for the trainer) and
  compiles through the same `obs.xray.analyze_jit` and graftcache path,
  so a forged entry has the key the live process computes. A fresh
  process per target is load-bearing: `save_cache_artifacts()` returns
  everything a process compiled, so one target per process keeps every
  entry its own.
* THE MANIFEST: one `forge-manifest-v1` record (per executable its key,
  family, compile wall, sizes; per target its error; the unforgeable
  remainder), appended to `runs.jsonl` as a `bench` record's `forge`
  block.

`verify_plan` checks a cache against a plan without compiling: workers
compute each target's keys (`rung_cache_keys`, or the train step's key
components), and the parent checks presence and checksums through the
cache's torch-free sidecars.

CLI: `python -m tensor2robot_tpu_torch.bin.graftscope forge <config.gin>`
(`--plan`, `--jobs N`, `--verify`; exit 0 ok, 1 missing or bad entries,
2 usage). Workers run on the card unless the spec names another device
(`--device cpu`). torch-free at import: workers are where torch lives.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time
from typing import Any, Dict, List, Optional, Sequence

from tensor2robot_tpu_torch.obs import graftrace
from tensor2robot_tpu_torch.utils import config

__all__ = ["FORGE_SCHEMA", "plan_from_config", "run_forge", "verify_plan",
           "forge_config", "format_plan", "graftforge", "build_train_step",
           "build_rung_engine"]

FORGE_SCHEMA = "forge-manifest-v1"
FORGE_SCHEMA_VERSION = 1

# Families the farm knows. "eval" is enumerated (the plan is the coverage
# statement) but never farmed: the port's eval step runs eagerly.
FAMILIES = ("serve", "session", "train", "eval")

MESH_REASON = ("train step on a mesh of more than one rank: the port "
               "compiles no step whose collectives cross processes "
               "(excache.mesh_compile_unsafe)")
EVAL_REASON = ("eval step runs eagerly in the port (never routed through "
               "analyze_jit)")


@config.configurable
def graftforge(model=None,
               model_dir: Optional[str] = None,
               export_dir: Optional[str] = None,
               jobs: int = 2):
  """Config surface for forge inputs a config pins (`graftforge.model =
  @MyModel` names the model whose steps a serving-only config deploys).
  Returns the bound values; the CLI merges them under its own flags."""
  return {"model": model, "model_dir": model_dir,
          "export_dir": export_dir, "jobs": jobs}


# ---------------------------------------------------------------------------
# Enumeration (no device).
# ---------------------------------------------------------------------------


def _ref_name(value) -> Optional[str]:
  """The configurable name behind an (unresolved) @reference binding."""
  name = getattr(value, "name", None)
  if isinstance(name, str):
    return name.rsplit(".", 1)[-1]
  if isinstance(value, str):
    return value.rsplit(".", 1)[-1]
  return None


def _bucket_ladder(max_batch_size: int) -> List[int]:
  # Local twin of serving.engine.bucket_ladder: enumeration builds
  # nothing; tests pin the two ladders against each other.
  ladder, b = [], 1
  while b < max_batch_size:
    ladder.append(b)
    b *= 2
  ladder.append(max_batch_size)
  return ladder


def _resolve_model_source(model: Optional[str] = None,
                          export_dir: Optional[str] = None
                          ) -> Optional[Dict[str, Any]]:
  """Model-source resolution, most explicit first: caller argument,
  `graftforge.model` binding, the trainer/loop model bindings a full
  config already carries. Serving-only configs (serve_fleet.gin) carry
  no model: callers pass `--model` / `--export-dir`, or the plan records
  `model: None` and the farm refuses with exit 2."""
  if export_dir:
    return {"kind": "export", "dir": str(export_dir)}
  if model == "flagship":
    return {"kind": "flagship"}
  if model:
    return {"kind": "configurable", "name": str(model)}
  for dotted in ("graftforge.model", "train_eval_model.model",
                 "run_graftloop.model_ctor"):
    # Raw binding on purpose: `@Name()` references resolve to a BUILT
    # model, and enumeration must not construct one at plan time.
    bound = config.raw_binding(dotted)
    if bound is not None:
      name = _ref_name(bound)
      if name == "flagship":
        return {"kind": "flagship"}
      if name:
        return {"kind": "configurable", "name": name}
  return None


def _mesh_size(mesh_shape) -> int:
  size = 1
  for dim in mesh_shape or ():
    size *= int(dim)
  return size


def plan_from_config(config_files: Sequence[str],
                     bindings: Sequence[str] = (),
                     model: Optional[str] = None,
                     export_dir: Optional[str] = None,
                     model_dir: Optional[str] = None) -> Dict[str, Any]:
  """Enumerates the compiled steps a config deploys.

  Parses the config (fresh registry) and reads its bindings; nothing is
  built, and no device is touched (the config's own imports load the
  modules it names). Returns the plan the farm, the
  verifier and the `--plan` renderer consume: `{"targets": [...],
  "model": ..., "config_files": [...]}`, each target with its family,
  name (the cache namespace), rungs and replicas, and `forgeable` +
  `reason`."""
  config.clear_config()
  config.parse_config_files_and_bindings(list(config_files),
                                         list(bindings))
  bound = config.bound_configurables()
  query = config.query_parameter_or
  model_source = _resolve_model_source(model=model, export_dir=export_dir)
  model_dir = model_dir or query("graftforge.model_dir") \
      or query("run_graftloop.model_dir")
  targets: List[Dict[str, Any]] = []

  # -- serving bucket ladders (BucketedEngine behind a fleet or solo) ------
  has_loop = "run_graftloop" in bound
  has_fleet = "ServingFleet" in bound
  has_serve = (has_fleet or has_loop or "BucketedEngine" in bound
               or "MicroBatcher" in bound)
  if has_serve:
    buckets = query("BucketedEngine.buckets")
    if buckets is None:
      max_batch = int(query("BucketedEngine.max_batch_size")
                      or query("ServingFleet.max_batch_size")
                      or query("run_graftloop.max_batch_size") or 8)
      buckets = _bucket_ladder(max_batch)
    else:
      buckets = sorted({int(b) for b in buckets})
    replicas = int(query("ServingFleet.num_replicas")
                   or query("run_graftloop.num_replicas") or 1)
    # A ServingFleet deployment (run_graftserve --replicas) pins each
    # replica to its own device group, so the keys differ per replica
    # (the device component): one target per replica. The loop's fleet
    # shares its device: one entry set warms every replica.
    placed = has_fleet and not has_loop and replicas > 1
    namespace = "serve/loop" if has_loop else "serve/engine"
    for index in range(replicas if placed else 1):
      targets.append({
          "family": "serve",
          "name": namespace,
          "buckets": list(buckets),
          "replica_index": index,
          "num_replicas": replicas,
          "placed": placed,
          "executables": len(buckets),
          "forgeable": True,
      })

  # -- session decode ladders ----------------------------------------------
  if "SessionEngine" in bound:
    buckets = query("SessionEngine.buckets")
    if buckets is None:
      buckets = _bucket_ladder(int(query("SessionEngine.max_tick_batch")
                                   or 8))
    else:
      buckets = sorted({int(b) for b in buckets})
    targets.append({
        "family": "session",
        "name": "serve/session",
        "buckets": list(buckets),
        "max_sessions": int(query("SessionEngine.max_sessions") or 64),
        "executables": len(buckets) + 1,  # + the slot reset
        "forgeable": True,
    })

  # -- train / eval steps --------------------------------------------------
  has_trainer = config.raw_binding("train_eval_model.model") is not None
  if has_trainer or has_loop:
    if has_trainer:
      mesh_shape = query("train_eval_model.mesh_shape")
      mode = str(query("train_eval_model.mode") or "train_and_evaluate")
    else:  # the loop's learner: one device
      mesh_shape, mode = None, "train"
    model_name = _ref_name(config.raw_binding("train_eval_model.model")
                           or config.raw_binding("run_graftloop.model_ctor"))
    virtual_stages = None
    if model_name:
      virtual_stages = config.query_parameter_or(
          f"{model_name}.num_virtual_stages")
    on_mesh = _mesh_size(mesh_shape) > 1
    target = {
        "family": "train",
        "name": "train_step",
        "mesh_shape": list(mesh_shape) if mesh_shape else None,
        "batch_size": int(
            query("run_graftloop.train_batch_size")
            or query("DefaultRandomInputGenerator.batch_size")
            or query("DefaultRecordInputGenerator.batch_size") or 16),
        "executables": 1,
        "forgeable": not on_mesh,
    }
    if on_mesh:
      target["reason"] = MESH_REASON
    if virtual_stages is not None:
      target["num_virtual_stages"] = int(virtual_stages)
    targets.append(target)
    if "evaluate" in mode or "eval" in mode.replace("evaluate", ""):
      targets.append({"family": "eval", "name": "eval_step",
                      "executables": 1, "forgeable": False,
                      "reason": EVAL_REASON})

  return {
      "schema": FORGE_SCHEMA,
      "schema_version": FORGE_SCHEMA_VERSION,
      "config_files": [str(p) for p in config_files],
      "bindings": [str(b) for b in bindings],
      "model": model_source,
      "model_dir": model_dir,
      "targets": targets,
  }


def format_plan(plan: Dict[str, Any]) -> str:
  """The `--plan` table: one line per target, unforgeable reasons
  spelled out."""
  lines = [f"graftforge plan: {', '.join(plan['config_files'])} "
           f"(model: {json.dumps(plan.get('model'))})"]
  lines.append(f"  {'family':<9}{'name':<18}{'executables':>12}  detail")
  total = forgeable = 0
  for target in plan["targets"]:
    count = int(target.get("executables") or 0)
    total += count
    detail = []
    if target.get("buckets"):
      detail.append(f"rungs {target['buckets']}")
    if target["family"] == "session":
      detail.append("+ slot reset")
      detail.append(f"max_sessions {target.get('max_sessions')}")
    if target.get("placed"):
      detail.append(f"replica {target['replica_index']}"
                    f"/{target['num_replicas']} (placed)")
    elif int(target.get("num_replicas") or 1) > 1:
      detail.append(f"shared by {target['num_replicas']} replicas")
    if target.get("num_virtual_stages") is not None:
      detail.append(f"v={target['num_virtual_stages']} (1F1B)")
    shape = target.get("mesh_shape")
    if shape:
      detail.append(f"mesh {tuple(shape) if isinstance(shape, list) else shape}")
    if target["forgeable"]:
      forgeable += count
    else:
      detail.append(f"UNFORGEABLE: {target.get('reason')}")
    lines.append(f"  {target['family']:<9}{target['name']:<18}"
                 f"{count:>12}  {'; '.join(detail)}")
  lines.append(f"  total {total} executable(s), {forgeable} forgeable")
  return "\n".join(lines)


# ---------------------------------------------------------------------------
# The farm (parent side).
# ---------------------------------------------------------------------------


def _worker_env() -> Dict[str, str]:
  env = dict(os.environ)
  # The workers import the package from the tree this module came from.
  root = os.path.dirname(os.path.dirname(os.path.dirname(
      os.path.abspath(__file__))))
  env["PYTHONPATH"] = os.pathsep.join(
      [root] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
  # Cross-process tracing: when the parent armed graftrace, workers
  # export their own shards into the same directory.
  trace_dir = graftrace.export_dir()
  if trace_dir:
    env["GRAFTRACE_DIR"] = trace_dir
    env.setdefault("GRAFTRACE_ROLE", "forge-worker")
  return env


def _run_workers(plan: Dict[str, Any], cache_dir: str, jobs: int,
                 verify: bool, device: str,
                 timeout_s: float) -> List[Dict[str, Any]]:
  """Runs one worker process per forgeable target, `jobs` at a time, and
  collects their results. Workers re-parse the config themselves and
  write their results to a JSON file each: stdout stays human."""
  forgeable = [t for t in plan["targets"] if t["forgeable"]]
  if not forgeable:
    return []
  jobs = max(1, int(jobs))
  env = _worker_env()
  results: List[Dict[str, Any]] = []
  deadline = time.monotonic() + timeout_s
  with tempfile.TemporaryDirectory(prefix="graftforge-") as tmp:
    pending = list(enumerate(forgeable))
    running = []

    def finish(proc, result_path, target):
      if proc.poll() is None:
        proc.terminate()
        try:
          proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
          proc.kill()
          proc.wait()
      if os.path.isfile(result_path):
        try:
          with open(result_path) as f:
            results.extend(json.load(f))
          return
        except (OSError, ValueError):
          pass
      results.append({"name": target["name"], "family": target["family"],
                      "status": "error",
                      "error": f"worker exited {proc.returncode} without a "
                               "result"})

    while pending or running:
      while pending and len(running) < jobs:
        index, target = pending.pop(0)
        spec = {"config_files": plan["config_files"],
                "bindings": plan["bindings"], "model": plan.get("model"),
                "model_dir": plan.get("model_dir"), "cache_dir": cache_dir,
                "verify": bool(verify), "device": device,
                "targets": [target]}
        spec_path = os.path.join(tmp, f"spec-{index}.json")
        result_path = os.path.join(tmp, f"result-{index}.json")
        with open(spec_path, "w") as f:
          json.dump(spec, f)
        running.append((subprocess.Popen(
            [sys.executable, "-m", "tensor2robot_tpu_torch.obs.forge",
             "--worker", spec_path, result_path], env=env), result_path,
            target))
      still = []
      for proc, result_path, target in running:
        if proc.poll() is None and time.monotonic() < deadline:
          still.append((proc, result_path, target))
        else:
          finish(proc, result_path, target)
      running = still
      if running:
        time.sleep(0.05)
  return results


def run_forge(plan: Dict[str, Any], cache_dir: str, jobs: int = 2,
              device: str = "cuda", timeout_s: float = 1200.0,
              runs_path: Optional[str] = None) -> Dict[str, Any]:
  """Runs the compile farm over a plan and returns (and with `runs_path`
  appends) the `forge-manifest-v1` manifest."""
  start = time.perf_counter()
  results = _run_workers(plan, cache_dir, jobs, verify=False, device=device,
                         timeout_s=timeout_s)
  executables: List[Dict[str, Any]] = []
  errors: List[Dict[str, Any]] = []
  for result in results:
    if result.get("status") == "ok":
      executables.extend(result.get("executables") or [])
    else:
      errors.append({"name": result.get("name"),
                     "family": result.get("family"),
                     "error": result.get("error")})
  unforgeable = [{"name": t["name"], "family": t["family"],
                  "reason": t.get("reason")}
                 for t in plan["targets"] if not t["forgeable"]]
  manifest = {
      "schema": FORGE_SCHEMA,
      "schema_version": FORGE_SCHEMA_VERSION,
      "config_files": plan["config_files"],
      "bindings": plan["bindings"],
      "cache_dir": str(cache_dir),
      "jobs": int(jobs),
      "device": device,
      "wall_s": round(time.perf_counter() - start, 3),
      "executables": executables,
      "errors": errors,
      "unforgeable": unforgeable,
      "counts": {
          "forged": sum(1 for e in executables
                        if e.get("action") == "compiled"),
          "cached": sum(1 for e in executables
                        if e.get("action") == "cached"),
          # A compile that failed ran eagerly and stored nothing: a farm
          # of fallbacks warmed nothing (the CLI exits 1 on it).
          "fallback": sum(1 for e in executables
                          if e.get("action") == "fallback"),
          "errors": len(errors),
          "unforgeable": len(unforgeable),
      },
      "total_compile_s": round(sum(float(e.get("compile_s") or 0.0)
                                   for e in executables), 3),
  }
  if runs_path:
    from tensor2robot_tpu_torch.obs import runlog as runlog_lib

    runlog_lib.append_record(runs_path, runlog_lib.make_record(
        "bench", extra={"forge": manifest}))
  return manifest


def verify_plan(plan: Dict[str, Any], cache_dir: str, device: str = "cuda",
                timeout_s: float = 600.0) -> Dict[str, Any]:
  """Checks an existing cache against the plan without compiling: the
  workers compute each forgeable target's keys, and the parent checks
  presence and checksum through the cache's sidecars."""
  from tensor2robot_tpu_torch.obs import excache as excache_lib

  results = _run_workers(plan, cache_dir, jobs=1, verify=True, device=device,
                         timeout_s=timeout_s)
  ok_keys, bad_keys = excache_lib.ExecutableCache(cache_dir).verify()
  present, missing, corrupt = [], [], []
  errors: List[Dict[str, Any]] = []
  for result in results:
    if result.get("status") != "ok":
      errors.append({"name": result.get("name"),
                     "error": result.get("error")})
      continue
    for executable in result.get("executables") or []:
      key = executable.get("key")
      if key in bad_keys:
        corrupt.append(dict(executable))
      elif key in ok_keys:
        present.append(dict(executable))
      else:
        missing.append(dict(executable))
  return {"present": present, "missing": missing, "corrupt": corrupt,
          "errors": errors}


def forge_config(config_files: Sequence[str],
                 bindings: Sequence[str] = (),
                 cache_dir: str = ".graftcache",
                 jobs: int = 2,
                 model: Optional[str] = None,
                 export_dir: Optional[str] = None,
                 model_dir: Optional[str] = None,
                 device: str = "cuda",
                 runs_path: Optional[str] = None):
  """Enumerate and farm one config; returns (plan, manifest)."""
  plan = plan_from_config(config_files, bindings, model=model,
                          export_dir=export_dir, model_dir=model_dir)
  manifest = run_forge(plan, cache_dir, jobs=jobs, device=device,
                       runs_path=runs_path)
  return plan, manifest


# ---------------------------------------------------------------------------
# Worker side (a fresh process; the only half that imports torch).
# ---------------------------------------------------------------------------


def _build_model(source: Dict[str, Any], device: str):
  if source["kind"] == "flagship":
    from tensor2robot_tpu_torch.research.qtopt import flagship

    return flagship.make_flagship_model(
        "cpu" if device == "cpu" else "cuda")
  if source["kind"] == "configurable":
    return config.get_configurable(source["name"])()
  raise ValueError(f"unknown model source {source!r}")


def _build_predictor(spec: Dict[str, Any], target: Dict[str, Any]):
  """What the live deployment builds: an export-bundle predictor when
  serving exports, else a checkpoint predictor that restores when the
  model_dir has checkpoints and random-inits otherwise (cache keys take
  shapes and dtypes, not values, so both warm the same entries)."""
  from tensor2robot_tpu_torch.predictors import predictors as predictors_lib

  source = spec.get("model")
  device = spec.get("device", "cuda")
  if source is None:
    raise ValueError("no model source: pass --model / --export-dir or bind "
                     "graftforge.model in the config")
  if source["kind"] == "export":
    predictor = predictors_lib.ExportedModelPredictor(
        export_dir=source["dir"], device=device)
    if not predictor.restore():
      raise RuntimeError(f"no valid export bundle under {source['dir']}")
  else:
    predictor = predictors_lib.CheckpointPredictor(
        model=_build_model(source, device),
        model_dir=spec.get("model_dir") or "/nonexistent", device=device)
    if not predictor.restore():
      predictor.init_randomly()
  if target.get("placed"):
    import torch

    from tensor2robot_tpu_torch.parallel import mesh as mesh_lib

    devices = ([torch.device(device)] if device == "cpu" else None)
    groups = mesh_lib.replica_device_groups(int(target["num_replicas"]),
                                            devices)
    group = groups[int(target["replica_index"])]
    if group:
      predictor.place_on_device(group[0])
  return predictor


def build_rung_engine(spec: Dict[str, Any], target: Dict[str, Any],
                      cache=True):
  """The engine a "serve" / "session" target deploys, built as the live
  process builds it, with the spec's cache (or none, for `--verify`)."""
  cache_dir = spec["cache_dir"] if cache else None
  if target["family"] == "serve":
    from tensor2robot_tpu_torch.serving import engine as engine_lib

    # The farm worker IS the enumeration: target["buckets"] came from
    # plan_from_config's spec walk, so the ladder is spec-derived by
    # construction.
    return engine_lib.BucketedEngine(  # graftlint: disable=warmup-unforgeable
        predictor=_build_predictor(spec, target),
        buckets=target["buckets"], cache=cache_dir,
        cache_namespace=target["name"])
  if target["family"] == "session":
    from tensor2robot_tpu_torch.serving import session as session_lib

    predictor = _build_predictor(spec, target)
    # Spec-derived by construction, same as above.
    return session_lib.SessionEngine(  # graftlint: disable=warmup-unforgeable
        predictor=predictor,
        max_sessions=int(target.get("max_sessions") or 64),
        buckets=target["buckets"], device=predictor.device,
        cache=cache_dir, cache_namespace=target["name"])
  raise ValueError(f"no rung engine for family {target['family']!r}")


def _rung_name(target: Dict[str, Any], rung) -> str:
  if rung == "reset":
    return f"{target['name']}/reset_slot"
  kind = "decode" if target["family"] == "session" else "bucket"
  return f"{target['name']}/{kind}{rung}"


def _engine_result(spec: Dict[str, Any], target: Dict[str, Any],
                   verify: bool) -> List[Dict[str, Any]]:
  if verify:
    engine = build_rung_engine(spec, target, cache=False)
    if target["family"] == "session":
      engine.warmup()  # its keys take the arena
    return [{"name": _rung_name(target, rung), "family": target["family"],
             "rung": rung, "key": key}
            for rung, key in engine.rung_cache_keys().items()]
  engine = build_rung_engine(spec, target).warmup()
  by_name = {str(r.get("name")): r for r in engine.compile_records}
  out = []
  for entry in engine.warmup_provenance:
    rung = entry["rung"]
    name = _rung_name(target, rung)
    record = by_name.get(name, {})
    cache_block = record.get("cache") or {}
    out.append({
        "name": name,
        "family": target["family"],
        "rung": rung,
        "key": entry.get("key") or cache_block.get("key"),
        "action": {"cache": "cached", "compile": "compiled"}.get(
            entry["source"], "fallback"),
        "compile_s": round(float(record.get("compile_s") or 0.0), 4),
        "ms": round(float(entry.get("ms") or 0.0), 2),
        "bytes": int(cache_block.get("bytes") or 0),
        "stored": bool(cache_block.get("stored", entry["source"]
                                       == "cache")),
    })
  return out


def build_train_step(spec: Dict[str, Any], target: Dict[str, Any]):
  """The trainer's step and its first call's arguments, built as
  `train_eval_model` builds them on one device: (model, step, (state,
  features, labels))."""
  import torch

  from tensor2robot_tpu_torch import modes as modes_lib
  from tensor2robot_tpu_torch.data import input_generators
  from tensor2robot_tpu_torch.parallel import mesh as mesh_lib
  from tensor2robot_tpu_torch.parallel import train_step as ts

  if target.get("mesh_shape"):
    raise ValueError(MESH_REASON)
  device = torch.device(spec.get("device", "cuda"))
  model = _build_model(spec["model"], device.type)
  generator = input_generators.DefaultRandomInputGenerator(
      batch_size=int(target.get("batch_size") or 16))
  generator.set_specification_from_model(model, modes_lib.TRAIN)
  features, labels = mesh_lib.place_batch(
      device, next(generator.create_dataset(modes_lib.TRAIN)))
  state = ts.create_train_state(model, torch.Generator().manual_seed(0),
                                device)
  return model, ts.make_train_step(model), (state, features, labels)


def _train_result(spec: Dict[str, Any], target: Dict[str, Any],
                  verify: bool) -> List[Dict[str, Any]]:
  """Compiles (or, for `--verify`, keys) the train step that
  `build_train_step` assembles, through the live trainer's path."""
  from tensor2robot_tpu_torch.obs import excache as excache_lib
  from tensor2robot_tpu_torch.obs import xray as xray_lib

  model, step, args = build_train_step(spec, target)
  if verify:
    key, _ = xray_lib.step_cache_key(target["name"], args, model)
    return [{"name": target["name"], "family": "train", "key": key}]
  _, record, _ = xray_lib.analyze_jit(
      target["name"], step, *args, model=model,
      cache=excache_lib.ExecutableCache(spec["cache_dir"]))
  cache_block = record.get("cache") or {}
  return [{
      "name": target["name"],
      "family": "train",
      "key": cache_block.get("key"),
      "action": "cached" if cache_block.get("hit") else "compiled",
      "compile_s": round(float(record.get("compile_s") or 0.0), 4),
      "bytes": int(cache_block.get("bytes") or 0),
      "stored": bool(cache_block.get("stored", cache_block.get("hit"))),
  }]


def _forge_target(spec: Dict[str, Any],
                  target: Dict[str, Any]) -> Dict[str, Any]:
  verify = bool(spec.get("verify"))
  try:
    if target["family"] in ("serve", "session"):
      executables = _engine_result(spec, target, verify)
    elif target["family"] == "train":
      executables = _train_result(spec, target, verify)
    else:
      raise ValueError(f"cannot forge family {target['family']!r}")
  except Exception as e:  # noqa: BLE001 - one bad target != a dead farm
    return {"name": target["name"], "family": target["family"],
            "status": "error", "error": f"{type(e).__name__}: {e}"}
  return {"name": target["name"], "family": target["family"],
          "status": "ok", "executables": executables}


def _worker_main(spec_path: str, result_path: str) -> int:
  with open(spec_path) as f:
    spec = json.load(f)
  graftrace.init_from_env()  # arm shard export when the parent did
  config.clear_config()
  config.parse_config_files_and_bindings(list(spec["config_files"]),
                                         list(spec["bindings"]))
  results = [_forge_target(spec, target) for target in spec["targets"]]
  with open(result_path, "w") as f:
    json.dump(results, f, default=str)
  graftrace.flush()
  return 0 if all(r["status"] == "ok" for r in results) else 1


if __name__ == "__main__":
  if len(sys.argv) == 4 and sys.argv[1] == "--worker":
    sys.exit(_worker_main(sys.argv[2], sys.argv[3]))
  print("usage: python -m tensor2robot_tpu_torch.obs.forge --worker "
        "<spec.json> <result.json>\n(operators drive the farm through "
        "`python -m tensor2robot_tpu_torch.bin.graftscope forge`)",
        file=sys.stderr)
  sys.exit(2)
