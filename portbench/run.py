"""Runs one cell of the port's benchmark once and prints its result.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout that holds the port. The last line of
standard output is one JSON object (`correct`, `attempted`, `failed`,
`metrics`, `device`, with `--trace 1` also `breakdown`, and last `checks`:
each number compared beside its limit); the last lines of standard
error repeat the checks. Exits 2, printing no result, when the card the
cell needs is absent, and 3 when the process has loaded JAX or the JAX
package. Every build and compile cache the run may fill stays in fixed
directories inside the checkout.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
CACHE = ROOT / ".portbench_cache"


def _arguments(argv):
  parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  parser.add_argument("--workload", required=True)
  parser.add_argument("--seed", type=int, required=True)
  parser.add_argument("--seconds", type=float, required=True)
  parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
  return parser.parse_args(argv)


def main(argv=None) -> int:
  args = _arguments(argv)
  for var, sub in (("TRITON_CACHE_DIR", "triton"),
                   ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
    os.environ[var] = str(CACHE / sub)
  if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
  from portbench import harness

  bench = harness.manifest()
  entry = next((w for w in bench["workloads"] if w["name"] == args.workload),
               None)
  if entry is None:
    print(f"no workload named {args.workload!r}", file=sys.stderr)
    return 2
  import torch

  if (not torch.cuda.is_available()
      or torch.cuda.device_count() < entry["chips"]):
    print(f"cell {args.workload} needs {entry['chips']} CUDA device(s); "
          f"found {torch.cuda.device_count()}", file=sys.stderr)
    return 2
  device = torch.device("cuda", 0)
  torch.cuda.set_device(device)
  run = harness.prepare(args.workload, args.seed % (1 << 63), args.seconds,
                        bool(args.trace), device, T_START, bench)
  result = harness.execute(run, bench)
  print(f"setup phases (s since start): {run.stats.get('setup_phases')}; "
        f"calls a 2 s of the window: {run.stats.get('per_2s')}",
        file=sys.stderr)
  return finish(result, torch.cuda.get_device_name(device), entry["chips"])


def finish(result, kind: str, count: int) -> int:
  """Prints the checks on standard error and the result line on standard
  output, and returns 0; prints no result and returns 3 when the process
  has loaded JAX or the JAX package."""
  from portbench import hygiene

  result["device"] = {"platform": "gpu", "kind": kind, "count": count,
                      **result["device"]}
  found = hygiene.forbidden_modules()
  if found:
    print(f"the run loaded forbidden modules: {found}", file=sys.stderr)
    return 3
  result["checks"] = result.pop("checks")  # the last key of the line
  for name, c in result["checks"].items():
    print(f"check {name} {c['value']!r} limit {c['limit']!r}",
          file=sys.stderr)
  sys.stderr.flush()
  print(json.dumps(result), flush=True)
  return 0


if __name__ == "__main__":
  sys.exit(main())
