"""Times the session decode-tick kernel of one tree of this repository on
one CUDA card, or of two trees in turns.

    python3 tensor2robot_tpu_torch/bin/time_decode.py [--root DIR]
    python3 tensor2robot_tpu_torch/bin/time_decode.py --pair OTHER_DIR

On the serving arena ([65, 4096, 8, 64] f32, K and V from seed 0), one
`fused_decode_attention` call at two shapes: the served bucket of 8 lanes
at indices [4095, 3072, 2048, 1024, 512, 256, 48, 1], and one lane at
index 4095 (a lone robot deep into its episode). Each with its bound:
the bytes it must move (K and V rows below each index read once; q,
k_new, v_new read; out and the appended rows written) over 3.35 TB/s.
Times are CUDA events around single calls, mean of 20 after 3 warm-up
calls, as `chip_smoke.py` times them (`ms`): before each call the L2
cache is flushed by reading a 128 MB buffer (which leaves it clean) and
the device spins ~0.2 ms, so the host has enqueued the call before the
device reaches the start event. `ms_write_flush` repeats the method of
earlier versions of `chip_smoke.py` (a 128 MB write, no spin), whose
reading of a short kernel also holds dirty-line write-backs and the
host's launch time. `kernel_ms` is the kernel's own duration on the
device (torch.profiler, CUDA activity), after the same flush and spin:
the event time less the launch. `--root`
names the tree whose `tensor2robot_tpu_torch` is timed (default: the one
holding this script). `--pair OTHER_DIR` runs OTHER_DIR, this tree, this
tree, OTHER_DIR, each in its own process, and prints the four results as
one JSON line, also written to `chiprun_out/time_decode.json`.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import subprocess
import sys

_THIS_ROOT = pathlib.Path(__file__).resolve().parents[2]
REPORT = "chiprun_out/time_decode.json"
HBM_BYTES_PER_S = 3.35e12
SPIN_CYCLES = 400_000  # ~0.2 ms at 1.98 GHz
SHAPES = {"B8": [4095, 3072, 2048, 1024, 512, 256, 48, 1], "B1": [4095]}


def _card_line() -> str:
  return subprocess.run(
      ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
      check=True, capture_output=True, text=True, timeout=60).stdout.strip()


def time_tree(root: str) -> dict:
  """The timings of the tree at `root`, in this process."""
  sys.path.insert(0, root)
  import torch

  from tensor2robot_tpu_torch.ops import decode_kernels

  if not torch.cuda.is_available():
    raise RuntimeError("time_decode needs a CUDA card")
  device = torch.device("cuda", 0)
  flush = torch.zeros(128 * 2**20, dtype=torch.uint8, device=device)

  def prepare(write_flush: bool) -> None:
    if write_flush:
      flush.zero_()
    else:
      flush.sum()
      torch.cuda._sleep(SPIN_CYCLES)

  def ms(fn, write_flush: bool = False, iters: int = 20,
         warmup: int = 3) -> float:
    total = 0.0
    for i in range(warmup + iters):
      prepare(write_flush)
      start = torch.cuda.Event(enable_timing=True)
      end = torch.cuda.Event(enable_timing=True)
      start.record()
      fn()
      end.record()
      end.synchronize()
      if i >= warmup:
        total += start.elapsed_time(end)
    return total / iters

  def kernel_ms(fn, iters: int = 20) -> float:
    """The decode kernel's own device time (torch.profiler), mean."""
    activities = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
      for _ in range(iters):
        prepare(False)
        fn()
      torch.cuda.synchronize()
    times = [e.device_time_total for e in prof.events()
             if "decode_tick" in e.name]
    if len(times) != iters:
      raise RuntimeError(f"profiled {len(times)} decode kernels, want {iters}")
    return 1e-3 * sum(times) / iters

  s, t, h, d = 65, 4096, 8, 64
  gen = torch.Generator(device=device).manual_seed(0)
  k_arena = torch.randn((s, t, h, d), generator=gen, device=device)
  v_arena = torch.randn((s, t, h, d), generator=gen, device=device)
  result = {"root": root, "card": _card_line()}
  for name, index_l in SHAPES.items():
    b = len(index_l)
    q, k_new, v_new = (torch.randn((b, h, d), generator=gen, device=device)
                       for _ in range(3))
    args = (q, k_new, v_new, k_arena, v_arena,
            torch.arange(1, b + 1, dtype=torch.int32, device=device),
            torch.tensor(index_l, dtype=torch.int32, device=device),
            torch.ones((b,), dtype=torch.bool, device=device))
    row = h * d * 4
    moved = 2 * sum(index_l) * row + 6 * b * row
    call = lambda: decode_kernels.fused_decode_attention(*args)
    result[name] = {"index": index_l, "ms": ms(call),
                    "ms_write_flush": ms(call, write_flush=True),
                    "kernel_ms": kernel_ms(call),
                    "bound_ms": 1e3 * moved / HBM_BYTES_PER_S,
                    "bytes": moved}
  return result


def main() -> None:
  parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
  parser.add_argument("--root", default=str(_THIS_ROOT))
  parser.add_argument("--pair", default=None,
                      help="another tree: run it, this one, this one, it")
  args = parser.parse_args()
  if args.pair is None:
    print(json.dumps(time_tree(os.path.abspath(args.root))), flush=True)
    return
  other = os.path.abspath(args.pair)
  runs = []
  for root in (other, str(_THIS_ROOT), str(_THIS_ROOT), other):
    done = subprocess.run([sys.executable, os.path.abspath(__file__), "--root",
                           root], capture_output=True, text=True, timeout=900)
    if done.returncode != 0:
      raise RuntimeError(f"timing {root} failed:\n{done.stderr[-4000:]}")
    runs.append(json.loads(done.stdout.strip().splitlines()[-1]))
  result = {"order": "other, this, this, other", "runs": runs}
  os.makedirs(os.path.dirname(REPORT), exist_ok=True)
  with open(REPORT, "w") as f:
    json.dump(result, f, indent=1)
  print(json.dumps(result), flush=True)


if __name__ == "__main__":
  main()
