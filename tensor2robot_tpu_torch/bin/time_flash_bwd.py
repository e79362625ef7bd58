"""Times the f32 flash backward kernels of one tree of this repository on
one CUDA card, or of two trees in turns.

    python3 tensor2robot_tpu_torch/bin/time_flash_bwd.py [--root DIR]
    python3 tensor2robot_tpu_torch/bin/time_flash_bwd.py --pair OTHER_DIR

At the train step's shape (B=2 H=8 T=4096 D=64, causal, f32; inputs from
seed 0, lse and out from the plain forward): the dQ and the dK/dV kernel,
each timed alone, the split pass where the tree has one (the f32 kernels
read its planes, so its time is added to each), and
`torch.autograd.grad` of `scaled_dot_product_attention`, the library's
whole f32 backward. Times are CUDA events around single calls with the
L2 cache flushed (128 MB write) before each, mean of 20 after 3 warm-up
calls. `--root` names the tree whose `tensor2robot_tpu_torch` is timed
(default: the one holding this script). `--pair OTHER_DIR` runs OTHER_DIR,
this tree, this tree, OTHER_DIR, each in its own process, and prints the
four results as one JSON line, also written to
`chiprun_out/time_flash_bwd.json`.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import subprocess
import sys

_THIS_ROOT = pathlib.Path(__file__).resolve().parents[2]
REPORT = "chiprun_out/time_flash_bwd.json"


def _card_line() -> str:
  return subprocess.run(
      ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
      check=True, capture_output=True, text=True, timeout=60).stdout.strip()


def time_tree(root: str) -> dict:
  """The timings of the tree at `root`, in this process."""
  sys.path.insert(0, root)
  import torch

  from tensor2robot_tpu_torch.ops import attention

  if not torch.cuda.is_available():
    raise RuntimeError("time_flash_bwd needs a CUDA card")
  torch.backends.cuda.matmul.allow_tf32 = False
  device = torch.device("cuda", 0)
  flush = torch.empty(128 * 2**20, dtype=torch.uint8, device=device)

  def ms(fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
      fn()
    total = 0.0
    for _ in range(iters):
      flush.zero_()
      start = torch.cuda.Event(enable_timing=True)
      end = torch.cuda.Event(enable_timing=True)
      start.record()
      fn()
      end.record()
      end.synchronize()
      total += start.elapsed_time(end)
    return total / iters

  b, h, t, d = 2, 8, 4096, 64
  gen = torch.Generator(device=device).manual_seed(0)
  q, k, v, do = (torch.randn((b, h, t, d), generator=gen, device=device)
                 for _ in range(4))
  q3, k3, v3, do3 = (x.reshape(b * h, t, d) for x in (q, k, v, do))
  out, lse = attention._flash_forward_plain(q3, k3, v3, True, t)
  delta = (do3 * out).sum(dim=-1).contiguous()
  args = (q3, k3, v3, do3, lse, delta, True, t)
  split_ms = None
  if hasattr(attention, "_launch_flash_bwd_split"):  # f32 on its planes
    split = lambda: attention._launch_flash_bwd_split(q3, k3, v3, do3)
    args += (split(),)
    split_ms = ms(split)
  dq_ms = ms(lambda: attention._launch_flash_bwd_dq(*args))
  dkv_ms = ms(lambda: attention._launch_flash_bwd_dkv(*args))
  leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
  sdpa = torch.nn.functional.scaled_dot_product_attention(*leaves,
                                                          is_causal=True)
  library_ms = ms(lambda: torch.autograd.grad(sdpa, leaves, do,
                                              retain_graph=True))
  extra = split_ms or 0.0
  return {"root": root, "card": _card_line(),
          "shape": f"B={b} H={h} T={t} D={d} causal float32",
          "dq_ms": dq_ms, "dkv_ms": dkv_ms, "split_ms": split_ms,
          "dq_with_split_ms": dq_ms + extra, "dkv_with_split_ms": dkv_ms + extra,
          "backward_ms": dq_ms + dkv_ms + extra, "library_ms": library_ms}


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
