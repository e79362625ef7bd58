"""Actor CLI: continuous collect/eval against a training job.

    python3 -m tensor2robot_tpu_torch.bin.run_collect_eval \
        --config_files tensor2robot_tpu_torch/configs/collect_random.gin \
        --config "collect_eval_loop.root_dir = '/tmp/actor1'"

Counterpart of `tensor2robot_tpu.bin.run_collect_eval` with the same
flags (both may repeat; bindings apply after the files), parsed with
argparse. Everything else is injected through the config; the binary
only calls `collect_eval_loop()`. A policy's predictor runs on the CUDA
card unless its config binds `device = 'cpu'`.
"""

from __future__ import annotations

import argparse
import logging
from typing import Optional, Sequence

from tensor2robot_tpu_torch.envs import run_env
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
  return run_env.collect_eval_loop()


if __name__ == "__main__":
  main()
