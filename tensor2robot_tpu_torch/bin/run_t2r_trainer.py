"""Trainer CLI: config files in, training out.

    python3 -m tensor2robot_tpu_torch.bin.run_t2r_trainer \
        --config_files tensor2robot_tpu_torch/configs/train_longcontext_flash.gin \
        --config "train_eval_model.model_dir = '/tmp/run'"

Counterpart of `tensor2robot_tpu.bin.run_t2r_trainer` with the same flags
(both may repeat; bindings apply after the files), parsed with argparse.
Everything else is injected through the config; the binary only calls
`train_eval_model()`, which runs on the CUDA card (bind
`train_eval_model.device = 'cpu'` to run on the CPU).
"""

from __future__ import annotations

import argparse
import logging
from typing import Optional, Sequence

from tensor2robot_tpu_torch import train_eval
from tensor2robot_tpu_torch.utils import config


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
  return train_eval.train_eval_model()


if __name__ == "__main__":
  main()
