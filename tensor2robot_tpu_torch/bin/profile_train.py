"""Where a train step's time goes, on one CUDA card.

    python3 -m tensor2robot_tpu_torch.bin.profile_train [--steps 10]
        [--model longcontext|qtopt]

Builds the model of a training config with random weights (seed 0) and
one random batch from its input generator, warms the train step up, then
profiles `--steps` steps with `torch.profiler` (CPU + CUDA activity):

* `longcontext` (default): `configs/train_longcontext_flash.gin` (T 4096,
  hidden 512, 2 blocks, 8 heads, batch 2, bf16 on f32 masters);
* `qtopt`: `configs/train_qtopt.gin` (Grasping44 at 472x472, batch 32,
  bf16 on f32 masters).

Prints one JSON object: wall ms per step (timed without the profiler),
examples/s, device-busy ms per step, the device's idle share, the device
time per step by kind of kernel (`device_ms_by_kind`: cuDNN convolutions,
cuBLAS/CUTLASS products, max-pool, reductions — batch-norm statistics —,
elementwise — batch-norm normalisation, relu, casts, the optimizer —,
copies, the flash kernels, other), and the device-time ranking of
kernels. For `longcontext` also the device time per step of the flash
kernels (forward, dQ, dK/dV) and their share of the step (kernels
matched by name prefix, both designs; a flash kernel that launched but
matches no device event raises). Also written to
`chiprun_out/profile_train.json` (`profile_train_qtopt.json`).
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

_CONFIGS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "configs")
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


# Kinds of device kernels, by name fragments (lower case), in the order
# they are tried: a cuDNN convolution's name may hold "gemm" too.
_KINDS = (
    ("flash", _FLASH_KERNELS),
    ("cudnn_conv", ("conv", "cudnn", "xmma", "fprop", "dgrad", "wgrad",
                    "implicit")),
    ("cublas_gemm", ("gemm", "cublas", "cutlass", "splitk")),
    ("max_pool", ("max_pool",)),
    ("reduction", ("reduce",)),
    ("elementwise", ("elementwise", "foreach", "where", "fill")),
    ("copy", ("memcpy", "memset", "copy", "cat")),
)


def device_ms_by_kind(events) -> Dict[str, float]:
  """Device ms of (name, ms) `events` summed by `_KINDS`; 'other' takes
  the rest."""
  out = {kind: 0.0 for kind, _ in _KINDS}
  out["other"] = 0.0
  for name, ms in events:
    lower = name.lower()
    kind = next((k for k, parts in _KINDS if any(p in lower for p in parts)),
                "other")
    out[kind] += ms
  return out


def _model(name: str):
  """The model and batch size of the config `name` profiles."""
  if name == "qtopt":
    from tensor2robot_tpu_torch.research.qtopt import models as qtopt_models

    config.parse_config_file(os.path.join(_CONFIGS, "train_qtopt.gin"))
    model = qtopt_models.QTOptModel()
  else:
    config.parse_config_file(os.path.join(_CONFIGS,
                                          "train_longcontext_flash.gin"))
    model = sequence_model.SequenceRegressionModel()
  return model, config.query_parameter(
      "DefaultRandomInputGenerator.batch_size")


def main() -> None:
  parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
  parser.add_argument("--steps", type=int, default=10)
  parser.add_argument("--model", choices=("longcontext", "qtopt"),
                      default="longcontext")
  args = parser.parse_args()
  torch.backends.cuda.matmul.allow_tf32 = False
  model, batch_size = _model(args.model)
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
  report.update({
      "model": args.model, "card": torch.cuda.get_device_name(0),
      "tf32": {"cudnn": torch.backends.cudnn.allow_tf32,
               "matmul": torch.backends.cuda.matmul.allow_tf32},
      "examples_per_s": batch_size / (report["wall_ms_per_call"] / 1e3),
      "device_ms_by_kind": device_ms_by_kind(events),
      "steps": args.steps, "batch": batch_size})
  if args.model == "longcontext":
    launched = {k: n - before[k] for k, n in _flash_launches().items()}
    flash = flash_device_ms(events, launched)
    flash_ms = sum(flash.values())
    report.update({
        "flash_device_ms_per_step": flash,
        "flash_launches_in_window": launched, "flash_share_of_step":
        flash_ms / report["wall_ms_per_call"],
        "flash_share_of_device_busy":
        flash_ms / report["device_busy_ms_per_call"]})
  os.makedirs("chiprun_out", exist_ok=True)
  suffix = "" if args.model == "longcontext" else f"_{args.model}"
  with open(f"chiprun_out/profile_train{suffix}.json", "w") as f:
    json.dump(report, f, indent=1)
  print(json.dumps(report))


if __name__ == "__main__":
  main()
