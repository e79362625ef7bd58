"""Export CLI: one serving bundle from a training checkpoint.

    python3 -m tensor2robot_tpu_torch.bin.export_saved_model \
        --config_files tensor2robot_tpu_torch/configs/train_qtopt.gin \
        --config "export_checkpoint.model = @QTOptModel()" \
        --config "export_checkpoint.model_dir = '/tmp/run'"

Counterpart of `tensor2robot_tpu.bin.export_saved_model` with the same
flags (both may repeat; bindings apply after the files), parsed with
argparse. `export_checkpoint` restores a checkpoint of `model_dir` (the
newest verified, or `checkpoint_step`) onto the CUDA card (bind
`export_checkpoint.device = 'cpu'` for the CPU) and writes the port's
bundle (`export.export_generator.DefaultExportGenerator`) under
`export_dir` (default `<model_dir>/export`).
"""

from __future__ import annotations

import argparse
import logging
import os
from typing import Optional, Sequence

from tensor2robot_tpu_torch import checkpoints as checkpoints_lib
from tensor2robot_tpu_torch.export import export_generator as export_lib
from tensor2robot_tpu_torch.utils import config
from tensor2robot_tpu_torch.utils import device as device_lib

_log = logging.getLogger(__name__)


@config.configurable
def export_checkpoint(model=config.REQUIRED,
                      model_dir: str = config.REQUIRED,
                      export_dir: Optional[str] = None,
                      checkpoint_step: Optional[int] = None,
                      write_saved_model: bool = False,
                      export_raw_receivers: bool = False,
                      device=None) -> str:
  """Restores a checkpoint and writes one export bundle; returns its
  path."""
  device = device_lib.resolve_device(device)
  export_dir = export_dir or os.path.join(model_dir, "export")
  with checkpoints_lib.CheckpointManager(
      os.path.join(model_dir, checkpoints_lib.CHECKPOINT_DIRNAME)) as manager:
    state = manager.restore(checkpoint_step, device=device)
  generator = export_lib.DefaultExportGenerator(
      write_saved_model=write_saved_model,
      export_raw_receivers=export_raw_receivers)
  generator.set_specification_from_model(model)
  path = generator.export(state, export_dir, global_step=int(state.step))
  _log.info("Exported %s (step %d)", path, int(state.step))
  return path


def main(argv: Optional[Sequence[str]] = None) -> str:
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
  return export_checkpoint()


if __name__ == "__main__":
  main()
