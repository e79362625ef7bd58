"""Times the trainer loop of one tree of this repository on one CUDA card,
or of two trees in turns, and splits the loop's wall by thread.

    python3 tensor2robot_tpu_torch/bin/time_train_loop.py [--root DIR]
    python3 tensor2robot_tpu_torch/bin/time_train_loop.py --pair OTHER_DIR

`configs/train_longcontext_flash.gin` at full width (bf16, batch 2,
T 4096, 2 blocks) through `train_eval_model`, a log every 5 steps and no
checkpoint before the last step, `RUN_STEPS` steps. A hook synchronizes
the card at after_step `FROM` and `STEPS`; the wall between, over the
steps between, is the run's step wall (the data threads still run at
`STEPS`, so their CPU clocks are read). Arms, each a fresh run:

* `loop`: the tree's defaults (a tree with step telemetry: telemetry on,
  at the card's default cadence, the log cadence);
* `off`: `step_stats_every_n_steps = 0` (only on a tree that has it);
* `inline`: `device_prefetch_depth = 0`, so batches are made and placed
  on the main thread and no data thread runs (telemetry off where the
  tree has it).

They run `--rounds` times, in an order reversed every round. Then one
more run of each arm samples the main thread's stack every 1 ms (its
wall is reported apart: the sampler takes the interpreter lock). For
every run: the CPU ms a step of each Python thread (its pthread CPU
clock) and of the whole process over the timed window. And `bare`: the
train step alone on one placed batch, `STEPS - FROM` steps enqueued
back to back after `FROM` warm-up steps, one synchronize at each end.

`--root` names the tree whose `tensor2robot_tpu_torch` is timed
(default: the one holding this script). `--pair OTHER_DIR` runs
OTHER_DIR, this tree, this tree, OTHER_DIR, each in its own process, and
prints the four results as one JSON line, also written to
`chiprun_out/time_train_loop.json`. Its `summary` pools each tree's
runs: per arm the walls (median, mean and its 95% half-width) and the
threads' CPU ms a step, telemetry on over off paired by round, and this
tree's `off` and `loop` medians over the other tree's `loop`.
"""

from __future__ import annotations

import argparse
import collections
import inspect
import json
import os
import pathlib
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import weakref

_THIS_ROOT = pathlib.Path(__file__).resolve().parents[2]
REPORT = "chiprun_out/time_train_loop.json"
CONFIG = "tensor2robot_tpu_torch/configs/train_longcontext_flash.gin"
FROM, STEPS, RUN_STEPS, LOG_EVERY = 20, 80, 90, 5
SAMPLE_S = 1e-3
WIDTHS = dict(obs_size=16, action_size=7, sequence_length=4096,
              hidden_size=512, num_blocks=2, num_heads=8)
DEVICE = "cuda"


def _card_line() -> str:
  return subprocess.run(
      ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
      check=True, capture_output=True, text=True, timeout=60).stdout.strip()


def _thread_cpu_s() -> dict:
  """CPU seconds of each live Python thread, by name."""
  out = {}
  for thread in threading.enumerate():
    try:
      clock = time.pthread_getcpuclockid(thread.ident)
      out[thread.name] = out.get(thread.name, 0.0) + time.clock_gettime(clock)
    except (OSError, TypeError):
      continue  # ended since the listing
  return out


class _StackSampler:
  """Samples the main thread's stack every `SAMPLE_S`: per sample its
  innermost frame, and its innermost frame in `tensor2robot_tpu_torch`."""

  def __init__(self):
    self._main = threading.main_thread().ident
    self._stop = threading.Event()
    self.leaf = collections.Counter()
    self.repo = collections.Counter()
    self.samples = 0
    self._thread = threading.Thread(target=self._run, daemon=True,
                                    name="stack-sampler")
    # Backstop: a sampler never stopped (a run that fails before its
    # last step) stops at interpreter exit at the latest.
    weakref.finalize(self, self._stop.set)

  @staticmethod
  def _site(frame) -> str:
    code = frame.f_code
    return (f"{os.path.basename(code.co_filename)}:{code.co_name}:"
            f"{frame.f_lineno}")

  def _run(self):
    while not self._stop.wait(SAMPLE_S):
      frame = sys._current_frames().get(self._main)
      if frame is None:
        continue
      self.samples += 1
      self.leaf[self._site(frame)] += 1
      while frame is not None and \
          "tensor2robot_tpu_torch" not in frame.f_code.co_filename:
        frame = frame.f_back
      self.repo[self._site(frame) if frame is not None else "(none)"] += 1

  def start(self):
    self._thread.start()

  def close(self) -> None:
    """Stops the sampling thread and joins it (idempotent)."""
    self._stop.set()
    if self._thread.is_alive():
      self._thread.join()

  def stop(self) -> dict:
    """`close()`, then the samples' summary."""
    self.close()
    n = max(self.samples, 1)
    return {"samples": self.samples,
            "leaf": [(s, c / n) for s, c in self.leaf.most_common(12)],
            "repo": [(s, c / n) for s, c in self.repo.most_common(12)]}


def time_tree(root: str, rounds: int) -> dict:
  """The arms of the tree at `root`, in this process."""
  sys.path.insert(0, root)
  import torch

  from tensor2robot_tpu_torch import train_eval
  from tensor2robot_tpu_torch.data import input_generators
  from tensor2robot_tpu_torch.hooks import core as hooks_core
  from tensor2robot_tpu_torch.models import sequence_model
  from tensor2robot_tpu_torch.parallel import train_step as ts
  from tensor2robot_tpu_torch.utils import config

  if not torch.cuda.is_available():
    raise RuntimeError("time_train_loop needs a CUDA card")
  has_telemetry = "step_stats_every_n_steps" in inspect.signature(
      train_eval.train_eval_model).parameters
  off = {"step_stats_every_n_steps": 0} if has_telemetry else {}
  arms = {"loop": {}, "inline": dict(off, device_prefetch_depth=0)}
  if has_telemetry:
    arms["off"] = dict(off)
  runs_dir = os.path.join(str(_THIS_ROOT), "_smoke_runs")
  os.makedirs(runs_dir, exist_ok=True)
  scratch = tempfile.mkdtemp(dir=runs_dir)

  class Clock(hooks_core.Hook):
    def __init__(self, sample: bool):
      self.sample = sample
      self.marks = {}

    def after_step(self, ctx, step, metrics):
      if step == FROM:
        torch.cuda.synchronize()
        self.cpu = (_thread_cpu_s(), time.process_time())
        self.sampler = _StackSampler() if self.sample else None
        if self.sampler is not None:
          self.sampler.start()
        self.marks[FROM] = time.perf_counter()
      elif step == STEPS:
        torch.cuda.synchronize()
        self.marks[STEPS] = time.perf_counter()
        threads, process = _thread_cpu_s(), time.process_time()
        self.stacks = (self.sampler.stop() if self.sampler is not None
                       else None)
        per_step = 1e3 / (STEPS - FROM)
        self.cpu = {
            "process": (process - self.cpu[1]) * per_step,
            "threads": {name: (threads[name] - self.cpu[0].get(name, 0.0))
                        * per_step for name in threads}}

  class Builder(hooks_core.HookBuilder):
    def __init__(self, hook):
      self.hook = hook

    def create_hooks(self, model, model_dir):
      return [self.hook]

  def run(name: str, kwargs: dict, sample: bool = False) -> dict:
    model_dir = tempfile.mkdtemp(dir=scratch)
    clock = Clock(sample)
    config.clear_config()
    config.parse_config_file(os.path.join(root, CONFIG))
    for binding in (f"train_eval_model.model_dir = '{model_dir}'",
                    f"train_eval_model.max_train_steps = {RUN_STEPS}",
                    "train_eval_model.checkpoint_every_n_steps = 1000",
                    f"train_eval_model.log_every_n_steps = {LOG_EVERY}"):
      config.parse_config(binding)
    try:
      train_eval.train_eval_model(hook_builders=[Builder(clock)], **kwargs)
    finally:
      config.clear_config()
      shutil.rmtree(model_dir, ignore_errors=True)
    marks = clock.marks
    out = {"arm": name,
           "step_wall_ms": 1e3 * (marks[STEPS] - marks[FROM]) / (STEPS - FROM),
           "cpu_ms_per_step": clock.cpu}
    if sample:
      out["main_stacks"] = clock.stacks
    return out

  def bare() -> dict:
    device = torch.device(DEVICE)
    model = sequence_model.SequenceRegressionModel(
        attention_backend="flash", use_bfloat16=True, **WIDTHS)
    state = ts.create_train_state(model, torch.Generator().manual_seed(0),
                                  device)
    generator = input_generators.DefaultRandomInputGenerator(batch_size=2,
                                                             seed=5)
    generator.set_specification_from_model(model, "train")
    batch = next(generator.create_dataset("train"))
    features = {k: v.to(device) for k, v in batch["features"].items()}
    labels = {k: v.to(device) for k, v in batch["labels"].items()}
    step_fn = ts.make_train_step(model)
    for _ in range(FROM):
      state, _ = step_fn(state, features, labels)
    torch.cuda.synchronize()
    cpu = (_thread_cpu_s(), time.process_time())
    start = time.perf_counter()
    for _ in range(STEPS - FROM):
      state, _ = step_fn(state, features, labels)
    torch.cuda.synchronize()
    wall = time.perf_counter() - start
    per_step = 1e3 / (STEPS - FROM)
    threads = _thread_cpu_s()
    return {"arm": "bare", "step_wall_ms": wall * per_step,
            "cpu_ms_per_step": {
                "process": (time.process_time() - cpu[1]) * per_step,
                "threads": {n: (threads[n] - cpu[0].get(n, 0.0)) * per_step
                            for n in threads}}}

  try:
    runs = [run("warmup", {})]  # the kernels' build and first launches
    order = list(arms)
    for r in range(rounds):
      for name in (order if r % 2 == 0 else order[::-1]):
        runs.append(dict(run(name, arms[name]), round=r))
        print(json.dumps(runs[-1]), file=sys.stderr, flush=True)
    sampled = [run(name, arms[name], sample=True) for name in order]
    bares = [bare() for _ in range(3)]
  finally:
    shutil.rmtree(scratch, ignore_errors=True)
  walls = {name: [r["step_wall_ms"] for r in runs if r["arm"] == name]
           for name in order}
  return {"root": root, "has_telemetry": has_telemetry,
          "steps_timed": STEPS - FROM, "from_step": FROM,
          "log_every": LOG_EVERY, "rounds": rounds,
          "walls_ms": walls,
          "median_ms": {n: statistics.median(w) for n, w in walls.items()},
          "bare_ms": [b["step_wall_ms"] for b in bares],
          "runs": runs[1:], "sampled": sampled, "bare": bares}


def _band(values) -> dict:
  """Median, mean and the 95% half-width of the mean (1.96 sd / sqrt n)."""
  n = len(values)
  sd = statistics.stdev(values) if n > 1 else float("nan")
  return {"n": n, "median": statistics.median(values),
          "mean": statistics.fmean(values), "min": min(values),
          "max": max(values), "half_width_95": 1.96 * sd / n ** 0.5}


def summarize(trees: list) -> dict:
  """Pools runs of one tree's processes: each arm's walls and its
  threads' CPU ms a step (medians), and telemetry on over off paired by
  round (the `loop` and `off` runs of one round)."""
  out = {"walls_ms": {}, "cpu_ms_per_step": {}}
  runs = [r for tree in trees for r in tree["runs"]]
  for arm in trees[0]["walls_ms"]:
    mine = [r for r in runs if r["arm"] == arm]
    out["walls_ms"][arm] = _band([r["step_wall_ms"] for r in mine])
    names = {n for r in mine for n in r["cpu_ms_per_step"]["threads"]}
    out["cpu_ms_per_step"][arm] = {
        "process": statistics.median(
            r["cpu_ms_per_step"]["process"] for r in mine),
        **{n: statistics.median(r["cpu_ms_per_step"]["threads"].get(n, 0.0)
                                for r in mine) for n in sorted(names)}}
  bare = [b for tree in trees for b in tree["bare"]]
  out["walls_ms"]["bare"] = _band([b["step_wall_ms"] for b in bare])
  out["cpu_ms_per_step"]["bare"] = {
      "process": statistics.median(b["cpu_ms_per_step"]["process"]
                                   for b in bare),
      "MainThread": statistics.median(
          b["cpu_ms_per_step"]["threads"]["MainThread"] for b in bare)}
  if trees[0]["has_telemetry"]:
    ratios = []
    for tree in trees:
      by_round = collections.defaultdict(dict)
      for r in tree["runs"]:
        by_round[r["round"]][r["arm"]] = r["step_wall_ms"]
      ratios += [arms["loop"] / arms["off"] for arms in by_round.values()]
    out["on_over_off"] = dict(_band(ratios), ratios=ratios)
  return out


def main(argv=None) -> int:
  parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
  parser.add_argument("--root", default=str(_THIS_ROOT))
  parser.add_argument("--pair", default=None)
  parser.add_argument("--rounds", type=int, default=6)
  args = parser.parse_args(argv)
  card = _card_line()
  if args.pair is None:
    tree = time_tree(args.root, args.rounds)
    result = {"card": card, **tree, "summary": summarize([tree])}
  else:
    other = str(pathlib.Path(args.pair).resolve())
    result = {"card": card, "order": [], "runs": []}
    for root in (other, str(_THIS_ROOT), str(_THIS_ROOT), other):
      proc = subprocess.run(
          [sys.executable, str(pathlib.Path(__file__).resolve()),
           "--root", root, "--rounds", str(args.rounds)],
          capture_output=True, text=True, timeout=900)
      sys.stderr.write(proc.stderr[-4000:])
      if proc.returncode != 0:
        raise RuntimeError(f"timing {root} exited {proc.returncode}")
      result["order"].append("other" if root == other else "this")
      result["runs"].append(json.loads(proc.stdout.strip().splitlines()[-1]))
    result["summary"] = {
        side: summarize([t for t, o in zip(result["runs"], result["order"])
                         if o == side]) for side in ("this", "other")}
    this, other = (result["summary"][side]["walls_ms"]
                   for side in ("this", "other"))
    result["summary"]["this_over_other_loop"] = {
        arm: this[arm]["median"] / other["loop"]["median"]
        for arm in ("off", "loop") if arm in this}
  os.makedirs(os.path.dirname(REPORT), exist_ok=True)
  with open(REPORT, "w") as f:
    json.dump(result, f, indent=1)
  print(json.dumps(result))
  return 0


if __name__ == "__main__":
  sys.exit(main())
