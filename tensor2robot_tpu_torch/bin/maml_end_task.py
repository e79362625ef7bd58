"""The pose MAML end task: adaptation's gain over init seeds and lengths.

    python3 -m tensor2robot_tpu_torch.bin.maml_end_task \
        --inits 0-7 --steps 60,150,300 [--deterministic] [--device cpu]

`MAMLModel` over `PoseEnvRegressionModel` at image 32 (4 tasks a batch,
6 + 6 samples, 2 inner steps at lr 0.2, Adam 2e-3) trains on
`research.pose_env.meta_tasks.offset_reach_batch` drawn from
`RandomState(0)` (the JAX test's stream) from each init seed. At each
length it reads the conditioned and unconditioned mean absolute error
over 16 held-out tasks (4 batches, seeds 123-126; seed 123 alone is the
JAX test's). One JSON line per init seed; all of them also to
`chiprun_out/maml_end_task.json`. `chip_smoke.py` phase 12b runs one
seed of it through the same functions. Runs on the CUDA card unless
told `--device cpu`.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from tensor2robot_tpu_torch.meta_learning import maml
from tensor2robot_tpu_torch.models import optimizers
from tensor2robot_tpu_torch.parallel import train_step
from tensor2robot_tpu_torch.research.pose_env import meta_tasks
from tensor2robot_tpu_torch.research.pose_env import models as pose_models
from tensor2robot_tpu_torch.utils import device as device_lib

END_TASK = dict(image=32, tasks=4, cond=6, inf=6, inner_steps=2,
                inner_lr=0.2, adam=2e-3)
EVAL_SEEDS = (123, 124, 125, 126)
DATA_SEED = 0
OUTPUT = "chiprun_out/maml_end_task.json"


def make_model(task: Dict = END_TASK) -> maml.MAMLModel:
  base = pose_models.PoseEnvRegressionModel(
      image_size=task["image"],
      optimizer_fn=lambda: optimizers.create_adam_optimizer(task["adam"]))
  return maml.MAMLModel(base_model=base,
                        num_condition_samples_per_task=task["cond"],
                        num_inference_samples_per_task=task["inf"],
                        num_inner_loop_steps=task["inner_steps"],
                        inner_learning_rate=task["inner_lr"])


def batch(rng: np.random.RandomState, device, task: Dict = END_TASK
          ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
  features, labels = meta_tasks.offset_reach_batch(
      rng, task["tasks"], task["cond"], task["inf"], task["image"])
  return ({k: torch.as_tensor(v, device=device) for k, v in features.items()},
          {k: torch.as_tensor(v, device=device) for k, v in labels.items()})


def held_out_mae(model, state, device, task: Dict = END_TASK
                 ) -> Tuple[float, float, List[Tuple[float, float]]]:
  """(conditioned, unconditioned) MAE over the held-out batches, and
  each batch's pair."""
  eval_step = train_step.make_eval_step(model)
  pairs = []
  for seed in EVAL_SEEDS:
    metrics = eval_step(state, *batch(np.random.RandomState(seed), device,
                                      task))
    pairs.append((float(metrics["conditioned/mean_absolute_error"]),
                  float(metrics["unconditioned/mean_absolute_error"])))
  cond, uncond = np.mean(pairs, axis=0).tolist()
  return cond, uncond, pairs


def train(model, device, steps: int, init_seed: int = 0,
          task: Dict = END_TASK, on_step=None):
  """`steps` meta-steps from `init_seed`'s fresh parameters on the
  `DATA_SEED` stream (its first batch skipped: the JAX test draws it for
  init); `on_step(step, state, metrics)` after each. Returns the state
  and the losses (device tensors)."""
  rng = np.random.RandomState(DATA_SEED)
  batch(rng, device, task)
  state = train_step.create_train_state(
      model, torch.Generator().manual_seed(init_seed), device)
  step_fn = train_step.make_train_step(model)
  losses = []
  for step in range(1, steps + 1):
    state, metrics = step_fn(state, *batch(rng, device, task))
    losses.append(metrics["loss"])
    if on_step is not None:
      on_step(step, state, metrics)
  return state, losses


def _seeds(text: str) -> List[int]:
  first, _, last = text.partition("-")
  return list(range(int(first), int(last or first) + 1))


def main(argv: Optional[Sequence[str]] = None) -> List[dict]:
  parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
  parser.add_argument("--inits", default="0-7",
                      help="Init seeds, 'first-last' or one seed.")
  parser.add_argument("--steps", default="60,150,300",
                      help="Comma-separated lengths to read the MAE at.")
  parser.add_argument("--deterministic", action="store_true",
                      help="cuDNN's deterministic algorithms only.")
  parser.add_argument("--device", default=None)
  args = parser.parse_args(argv)
  device = device_lib.resolve_device(args.device)
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  torch.backends.cudnn.deterministic = args.deterministic
  lengths = sorted(int(s) for s in args.steps.split(","))
  rows = []
  for init in _seeds(args.inits):
    model = make_model()
    reads = {}

    def read(step, state, metrics, model=model, reads=reads):
      if step in lengths:
        cond, uncond, _ = held_out_mae(model, state, device)
        reads[step] = {"conditioned_mae": cond, "unconditioned_mae": uncond,
                       "ratio": cond / uncond,
                       "loss": float(metrics["loss"])}

    start = time.perf_counter()
    train(model, device, lengths[-1], init, on_step=read)
    row = {"init": init, "device": str(device),
           "device_name": (torch.cuda.get_device_name(device)
                           if device.type == "cuda" else "cpu"),
           "torch": torch.__version__,
           "deterministic": args.deterministic, "reads": reads,
           "wall_s": time.perf_counter() - start}
    print(json.dumps(row), flush=True)
    rows.append(row)
  os.makedirs(os.path.dirname(OUTPUT), exist_ok=True)
  with open(OUTPUT, "w") as f:
    json.dump(rows, f, indent=1)
  return rows


if __name__ == "__main__":
  main()
