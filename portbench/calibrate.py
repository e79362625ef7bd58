"""The readings the limits of `correct` are set from, at a cell's own
size: the sound program on each seed, the control on each control seed,
and for a training cell the half-batch fault.

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,3 \\
        --control-seeds 4,5,6 [--seconds 2]

* Training: the program's first three steps against the float32
  reference (no window is needed); the control is the reference with
  every product's operands in float8 e4m3 put in the program's place;
  the half-batch fault is the float32 reference fed half of each batch
  (the mean taken over the rest) put in the program's place; the bf16
  witness is the reference rounded as a bfloat16 program rounds, which
  shows what bfloat16 alone reads; `ema_unchanged` and
  `mutable_unchanged` are the program's own readings with that part of
  its state put back to where it started (an EMA never updated,
  batch-norm statistics never moved), where the state has such a part.
  A state left unchanged as a whole reads 1 on `update_gap` and is not
  run.
* Serving: the sound program is a run of the cell with a short window
  (`--seconds`) per seed; the control is the reference with TF32
  operands at every position of the same observation rows.

Prints one JSON line per reading and, last, the largest sound reading
and the smallest control and fault reading of each number.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _half(batch):
  features, labels = batch
  cut = lambda tree: type(tree)({k: v[:v.shape[0] // 2]
                                 for k, v in tree.items()})
  return cut(features), cut(labels)


def readings(cell: str, seeds, control_seeds, seconds: float, device,
             configure=None):
  """[(kind, seed, numbers)] of the sound program on `seeds` and of the
  control (and for training the faults) on `control_seeds`.
  `configure(run)` may change a prepared run (the tests shrink it)."""
  import torch

  from portbench import compare, harness, precision

  def prepare(seed, window):
    run = harness.prepare(cell, seed, window, False, device,
                          time.perf_counter())
    if configure is not None:
      configure(run)
    return run

  out = []
  for seed in seeds:
    run = prepare(seed, seconds)
    driver = harness.load_module("drivers", run.traffic["driver"])
    if run.traffic["driver"] == "train_step":
      begun = driver.start(run)
      del begun["state"], begun["step"]
      numbers = driver.reference_numbers(
          run, begun["program"], begun["params0"], begun["mutable0"],
          begun["batches"][:3])
    else:
      driver.run(run)
      numbers = run.numbers
    out.append(("sound", seed, numbers))
    if torch.device(device).type == "cuda":
      torch.cuda.empty_cache()
  for seed in control_seeds:
    run = prepare(seed, seconds)
    driver = harness.load_module("drivers", run.traffic["driver"])
    if run.traffic["driver"] == "train_step":
      begun = driver.start(run)
      del begun["state"], begun["step"]
      p0, m0 = begun["params0"], begun["mutable0"]
      batches = begun["batches"][:3]
      with precision.exact_float32():
        ref = run.reference.train_readings(p0, m0, batches, run.config)
        stand_ins = {
            "control": run.reference.train_readings(p0, m0, batches,
                                                    run.config, "fp8"),
            "half_batch": run.reference.train_readings(
                p0, m0, [_half(b) for b in batches], run.config),
            "witness_bf16": run.reference.train_readings(
                p0, m0, batches, run.config, "bf16")}
      for group, start in (("ema", p0), ("mutable", m0)):
        if begun["program"]["after"][group]:
          stuck = dict(begun["program"]["after"], **{group: start})
          stand_ins[f"{group}_unchanged"] = dict(begun["program"],
                                                 after=stuck)
      for kind, readings_ in stand_ins.items():
        out.append((kind, seed, compare.train_numbers(readings_, ref, p0,
                                                      m0)))
    else:
      _, params, table = driver.inputs(run)
      ref = driver.reference_actions(run, params, table)
      control = driver.reference_actions(run, params, table, "tf32")
      out.append(("control", seed, compare.serve_numbers(
          control.reshape(-1, control.shape[-1]),
          ref.reshape(-1, ref.shape[-1]))))
    if torch.device(device).type == "cuda":
      torch.cuda.empty_cache()
  return out


def summary(found):
  """{kind: {number: extreme}}: the largest sound reading, the smallest
  of every other kind."""
  result = {}
  for kind, _, numbers in found:
    pick = max if kind == "sound" else min
    slot = result.setdefault(kind, {})
    for name, value in numbers.items():
      slot[name] = value if name not in slot else pick(slot[name], value)
  return result


def main(argv=None) -> int:
  parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  parser.add_argument("--workload", required=True)
  parser.add_argument("--seeds", default="")
  parser.add_argument("--control-seeds", default="")
  parser.add_argument("--seconds", type=float, default=2.0)
  args = parser.parse_args(argv)
  if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
  import torch

  if not torch.cuda.is_available():
    print("calibration needs a CUDA device", file=sys.stderr)
    return 2
  seeds = [int(s) for s in args.seeds.split(",") if s]
  control_seeds = [int(s) for s in args.control_seeds.split(",") if s]
  found = readings(args.workload, seeds, control_seeds, args.seconds,
                   torch.device("cuda", 0))
  for kind, seed, numbers in found:
    print(json.dumps({"kind": kind, "seed": seed, **numbers}), flush=True)
  print(json.dumps({"summary": summary(found),
                    "seconds": time.perf_counter() - T_START}), flush=True)
  return 0


if __name__ == "__main__":
  sys.exit(main())
