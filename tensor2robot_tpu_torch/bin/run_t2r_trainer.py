"""Trainer CLI: config files in, training out.

    python3 -m tensor2robot_tpu_torch.bin.run_t2r_trainer \
        --config_files tensor2robot_tpu_torch/configs/train_longcontext_flash.gin \
        --config "train_eval_model.model_dir = '/tmp/run'"

Counterpart of `tensor2robot_tpu.bin.run_t2r_trainer` with the same flags
(both may repeat; bindings apply after the files), parsed with argparse.
Everything else is injected through the config; the binary only calls
`train_eval_model()`, which runs on the CUDA card (bind
`train_eval_model.device = 'cpu'` to run on the CPU).

Launched by `torchrun` (one process per rank), it reads the launcher's
environment (`RANK`, `WORLD_SIZE`, `MASTER_ADDR`, `MASTER_PORT`,
`LOCAL_RANK`) and brings the world up through
`parallel.mesh.initialize_multihost` before training: NCCL when the run
is on the card (rank r on `cuda:LOCAL_RANK` unless the config binds a
card), gloo on the CPU.
"""

from __future__ import annotations

import argparse
import logging
import os
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from tensor2robot_tpu_torch import train_eval
from tensor2robot_tpu_torch.parallel import mesh as mesh_lib
from tensor2robot_tpu_torch.utils import config


def _initialize_from_launcher() -> bool:
  """Brings up the world of a `torchrun` launch from its environment;
  True when it did (False without one, or when it is already up)."""
  world_size = int(os.environ.get("WORLD_SIZE", "1"))
  if world_size <= 1 or dist.is_initialized():
    return False
  device = str(config.query_parameter_or("train_eval_model.device")
               or "cuda")
  on_cpu = device.startswith("cpu")
  if device == "cuda":  # one card a rank; a bound 'cuda:<i>' is kept
    torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
  mesh_lib.initialize_multihost(
      coordinator_address=(f"{os.environ['MASTER_ADDR']}:"
                           f"{os.environ['MASTER_PORT']}"),
      num_processes=world_size, process_id=int(os.environ["RANK"]),
      device="cpu" if on_cpu else "cuda")
  return True


def main(argv: Optional[Sequence[str]] = None) -> dict:
  parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
  parser.add_argument("--config_files", action="append", default=[],
                      help="Config (.gin) file to parse; may repeat.")
  parser.add_argument("--config", action="append", default=[],
                      help="A binding string, applied after the files; may "
                      "repeat.")
  args = parser.parse_args(argv)
  logging.basicConfig(level=logging.INFO,
                      format="%(asctime)s %(levelname)s %(name)s: %(message)s")
  config.parse_config_files_and_bindings(args.config_files, args.config)
  started = _initialize_from_launcher()
  try:
    result = train_eval.train_eval_model()
    if started:
      dist.barrier()  # every rank leaves together
    return result
  finally:
    if started:
      # The group's threads stop before the interpreter does: a gloo
      # group still up at exit aborts the process.
      dist.destroy_process_group()


if __name__ == "__main__":
  main()
