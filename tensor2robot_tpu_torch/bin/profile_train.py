"""Where a train step's time goes, on one CUDA card.

    python3 -m tensor2robot_tpu_torch.bin.profile_train [--steps 10]

Builds the model of `configs/train_longcontext_flash.gin` (T 4096, hidden
512, 2 blocks, 8 heads, bf16 on f32 masters; random weights, seed 0) and
one random batch of 2 from its input generator, warms the train step up,
then profiles `--steps` steps with `torch.profiler` (CPU + CUDA
activity). Prints one JSON object: wall ms per step (timed without the
profiler), examples/s, device-busy ms per step, the device's idle share,
the device time per step of the flash kernels (forward, dQ, dK/dV) and
their share of the step (kernels matched by name prefix, both designs;
a flash kernel that launched but matches no device event raises), and
the device-time ranking of kernels. Also
written to `chiprun_out/profile_train.json`.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict

import torch

from tensor2robot_tpu_torch.data import input_generators
from tensor2robot_tpu_torch.models import sequence_model
from tensor2robot_tpu_torch.obs import device_profile
from tensor2robot_tpu_torch.ops import attention
from tensor2robot_tpu_torch.parallel import train_step
from tensor2robot_tpu_torch.utils import config

_CONFIG = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "configs", "train_longcontext_flash.gin")
# Prefixes of the device-kernel names of csrc/flash_fwd.cu and
# csrc/flash_bwd.cu, shared by both designs of each (bf16 and f32:
# flash_fwd_tc_kernel and flash_fwd_tc_split_kernel; flash_bwd_dq_tc_kernel
# and flash_bwd_dq_tc_split_kernel; flash_bwd_dkv_tc_kernel and
# flash_bwd_dkv_tc_split_kernel).
_FLASH_KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")


def _flash_launches() -> Dict[str, int]:
  """The flash wrappers' launch counters, by `_FLASH_KERNELS` prefix."""
  return {"flash_fwd": attention.flash_forward.launches,
          "flash_bwd_dq": attention.flash_backward.launches_dq,
          "flash_bwd_dkv": attention.flash_backward.launches_dkv}


def flash_device_ms(events, launched: Dict[str, int]) -> Dict[str, float]:
  """Device ms of each flash kernel among (name, ms) `events`, matched by
  prefix. Raises if a kernel that `launched` says ran reads 0 ms: its
  name no longer matches, and the flash share would silently drop."""
  flash = {prefix: sum(ms for key, ms in events if prefix in key)
           for prefix in _FLASH_KERNELS}
  missing = [prefix for prefix in _FLASH_KERNELS
             if launched.get(prefix, 0) > 0 and flash[prefix] <= 0]
  if missing:
    raise RuntimeError(f"flash kernels {missing} launched in the window but "
                       f"no device event matched them; device kernels: "
                       f"{[key for key, _ in events][:20]}")
  return flash


def main() -> None:
  parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
  parser.add_argument("--steps", type=int, default=10)
  args = parser.parse_args()
  torch.backends.cuda.matmul.allow_tf32 = False
  config.parse_config_file(_CONFIG)
  model = sequence_model.SequenceRegressionModel()
  batch_size = config.query_parameter("DefaultRandomInputGenerator.batch_size")
  device = torch.device("cuda", 0)
  generator = input_generators.DefaultRandomInputGenerator(
      batch_size=batch_size, seed=0)
  generator.set_specification_from_model(model, "train")
  batch = next(generator.create_dataset("train"))
  features = {k: v.to(device) for k, v in batch["features"].items()}
  labels = {k: v.to(device) for k, v in batch["labels"].items()}
  step_fn = train_step.make_train_step(model)
  holder = [train_step.create_train_state(
      model, torch.Generator().manual_seed(0), device)]

  def one_step():
    holder[0], _ = step_fn(holder[0], features, labels)

  for _ in range(3):
    one_step()
  before = _flash_launches()
  report = device_profile.profile_window(one_step, args.steps)
  events = report.pop("events")
  launched = {k: n - before[k] for k, n in _flash_launches().items()}
  flash = flash_device_ms(events, launched)
  flash_ms = sum(flash.values())
  report.update({
      "card": torch.cuda.get_device_name(0),
      "examples_per_s": batch_size / (report["wall_ms_per_call"] / 1e3),
      "flash_device_ms_per_step": flash,
      "flash_launches_in_window": launched, "flash_share_of_step":
      flash_ms / report["wall_ms_per_call"],
      "flash_share_of_device_busy":
      flash_ms / report["device_busy_ms_per_call"],
      "steps": args.steps, "batch": batch_size})
  os.makedirs("chiprun_out", exist_ok=True)
  with open("chiprun_out/profile_train.json", "w") as f:
    json.dump(report, f, indent=1)
  print(json.dumps(report))


if __name__ == "__main__":
  main()
