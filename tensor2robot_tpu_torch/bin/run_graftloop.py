"""graftloop CLI: the always-on actor/learner loop, from config.

    python3 -m tensor2robot_tpu_torch.bin.run_graftloop \
        --config_files tensor2robot_tpu_torch/configs/loop_qtopt.gin \
        --config "run_graftloop.model_dir = '/tmp/loop1'"

Counterpart of `tensor2robot_tpu.bin.run_graftloop` with the same flags
(both may repeat; bindings apply after the files), parsed with argparse.
One supervised process runs the actors, the learner and the continuous
deployment (`loop.loop.run_graftloop`) on the CUDA card (bind
`run_graftloop.device = 'cpu'` to run on the CPU) and prints the loop's
summary as one JSON line.
"""

from __future__ import annotations

import argparse
import json
import logging
from typing import Optional, Sequence

from tensor2robot_tpu_torch.loop import loop as loop_lib
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
  summary = loop_lib.run_graftloop()
  print(json.dumps(summary, default=str), flush=True)
  return summary


if __name__ == "__main__":
  main()
