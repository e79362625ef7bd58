"""graftserve CLI: load-test the serving stack against an export bundle.

    python3 -m tensor2robot_tpu_torch.bin.run_graftserve \
        --export_dir /tmp/run/export \
        --concurrency 8 --requests_per_thread 100 [--replicas 2] \
        [--devices cuda:0,cuda:0] \
        [--config_files tensor2robot_tpu_torch/configs/serve_fleet.gin]

Counterpart of `tensor2robot_tpu.bin.run_graftserve`, with its flags
parsed by argparse. Restores an `ExportedModelPredictor` from the newest
bundle under `--export_dir`, fronts it with `BucketedEngine` +
`MicroBatcher` (or, with `--replicas N`, a `ServingFleet` of N replicas,
each restoring its own predictor pinned to its device group), warms
every rung, drives a closed-loop load (`loadgen.run_load`) and prints
ONE JSON line: QPS, outcomes, latency percentiles, the rungs, the
engines' warm counts and the shed and SLO counters.

`--devices` lists the devices the replicas are carved from
(`parallel.mesh.replica_device_groups`), comma-separated: by default
every visible CUDA card. One card listed twice serves two replicas on
it. The single-engine mode serves on the first device.

`--executable_cache_dir` compiles every engine rung (`BucketedEngine(
cache=..., cache_namespace='serve/engine')`), loading and storing the
compiler's artifacts there; the line reports `engine_compiles` (fresh
compiles per engine) and `compile_sec` (each compiled rung's first-call
wall), as the JAX CLI does, beside `engine_warms`. Without the flag the
rungs run eagerly and both are 0 / empty.
"""

from __future__ import annotations

import argparse
import json
import logging
import sys
from typing import Optional, Sequence

from tensor2robot_tpu_torch.utils import config


def _parse(argv):
  parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
  parser.add_argument("--config_files", action="append", default=[],
                      help="Config (.gin) file to parse (e.g. "
                      "serve_fleet.gin); may repeat.")
  parser.add_argument("--config", action="append", default=[],
                      help="A binding string, applied after the files; may "
                      "repeat.")
  parser.add_argument("--export_dir", default=None,
                      help="Export root with version-named bundles.")
  parser.add_argument("--concurrency", type=int, default=8,
                      help="Closed-loop client threads.")
  parser.add_argument("--requests_per_thread", type=int, default=100,
                      help="Requests per client.")
  parser.add_argument("--deadline_ms", type=float, default=0.0,
                      help="Per-request admission deadline (0 disables); "
                      "expired requests are shed and counted as SLO "
                      "breaches.")
  parser.add_argument("--replicas", type=int, default=1,
                      help="1 serves through one BucketedEngine + "
                      "MicroBatcher; >1 builds a ServingFleet.")
  parser.add_argument("--devices", default=None,
                      help="Comma-separated devices the replicas are "
                      "carved from (default: every visible CUDA card).")
  parser.add_argument("--executable_cache_dir", default=None,
                      help="graftcache directory: compile every engine rung "
                      "and keep the compiler's artifacts there (replicas "
                      "share the 'serve/engine' cache namespace).")
  return parser.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> int:
  args = _parse(argv)
  logging.basicConfig(level=logging.INFO,
                      format="%(asctime)s %(levelname)s %(name)s: %(message)s")
  if not args.export_dir:
    raise SystemExit("--export_dir is required.")
  config.parse_config_files_and_bindings(args.config_files, args.config)

  import torch

  from tensor2robot_tpu_torch import serving
  from tensor2robot_tpu_torch import specs as specs_lib
  from tensor2robot_tpu_torch.obs import metrics as obs_metrics
  from tensor2robot_tpu_torch.parallel import mesh as mesh_lib
  from tensor2robot_tpu_torch.predictors import predictors as predictors_lib
  from tensor2robot_tpu_torch.serving import loadgen

  devices = ([torch.device(d.strip()) for d in args.devices.split(",")]
             if args.devices else None)
  groups = mesh_lib.replica_device_groups(args.replicas, devices)
  predictor = predictors_lib.ExportedModelPredictor(
      export_dir=args.export_dir, device=groups[0][0])
  if not predictor.restore():
    print(f"no valid export bundle under {args.export_dir!r}",
          file=sys.stderr)
    return 2
  request = dict(specs_lib.make_random_numpy(
      predictor.get_feature_specification(), batch_size=1,
      seed=0).items())
  deadline_ms = args.deadline_ms or None
  if args.replicas > 1:
    # Each replica restores its OWN predictor from the export, pinned to
    # its device group; the first one above validated the bundle.
    def make_replica(index, group):
      p = (predictor if index == 0
           else predictors_lib.ExportedModelPredictor(
               export_dir=args.export_dir, device=group[0]))
      if index > 0 and not p.restore():
        raise RuntimeError(f"replica {index}: export restore failed")
      p.place_on_device(group[0])
      return serving.BucketedEngine(predictor=p,
                                    cache=args.executable_cache_dir,
                                    cache_namespace="serve/engine")

    with serving.ServingFleet(replica_factory=make_replica,
                              num_replicas=args.replicas,
                              devices=[d for g in groups for d in g],
                              warmup=True) as fleet:
      result = loadgen.run_load(
          fleet.predict, lambda i: request, concurrency=args.concurrency,
          requests_per_thread=args.requests_per_thread,
          deadline_ms=deadline_ms)
      warms = fleet.warm_counts()
      engine_compiles = fleet.compile_counts()
      compile_records = [r for i in range(fleet.num_replicas)
                         for r in fleet.replica(i).compile_records]
      buckets = fleet.replica(0).buckets
  else:
    engine = serving.BucketedEngine(
        predictor=predictor, cache=args.executable_cache_dir,
        cache_namespace="serve/engine").warmup()
    with serving.MicroBatcher(backend=engine) as batcher:
      result = loadgen.run_load(
          batcher.predict, lambda i: request, concurrency=args.concurrency,
          requests_per_thread=args.requests_per_thread,
          deadline_ms=deadline_ms)
    warms = engine.warm_count
    engine_compiles = engine.compile_count
    compile_records = engine.compile_records
    buckets = engine.buckets
  snap = obs_metrics.snapshot(prefix="serve/")
  print(json.dumps({
      "global_step": predictor.global_step,
      "replicas": args.replicas,
      "qps": round(result["qps"], 2),
      "ok": result["ok"],
      "errors": result["errors"],
      "concurrency": result["concurrency"],
      "latency_ms": {k: round(v, 3)
                     for k, v in loadgen.latency_percentiles().items()},
      "buckets": buckets,
      "engine_warms": warms,
      "engine_compiles": engine_compiles,
      "compile_sec": [round(float(r.get("compile_s") or 0.0), 3)
                      for r in compile_records],
      "shed_deadline": snap.get("counter/serve/batcher/shed_deadline", 0.0),
      "shed_queue_full": snap.get("counter/serve/batcher/shed_queue_full",
                                  0.0),
      "fleet_shed": snap.get("counter/serve/fleet/shed", 0.0),
      "slo_breaches": snap.get("counter/serve/slo_breaches", 0.0),
  }), flush=True)
  return 0


if __name__ == "__main__":
  sys.exit(main())
