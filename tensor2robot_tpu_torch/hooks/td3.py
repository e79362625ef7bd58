"""TD3 hooks: current and lagged exports, and serving warmup requests.

Counterpart of `tensor2robot_tpu.hooks.td3`. The target networks of TD3
and QT-Opt read a one-version-lagged export directory; a synchronous
export also carries a warmup request, a spec-shaped random feed that a
serving frontend runs before it takes traffic.
"""

from __future__ import annotations

import json
import os
from typing import List

import numpy as np

from tensor2robot_tpu_torch import modes as modes_lib
from tensor2robot_tpu_torch import specs as specs_lib
from tensor2robot_tpu_torch.hooks import core as hooks_lib
from tensor2robot_tpu_torch.utils import config

__all__ = ["write_warmup_request", "TD3HookBuilder", "WARMUP_FILENAME"]

WARMUP_FILENAME = "warmup_request.json"


def write_warmup_request(export_path: str,
                         feature_spec: specs_lib.SpecStructLike,
                         batch_size: int = 1) -> str:
  """Writes `{"inputs": {key: nested list}}` of `make_random_numpy(
  feature_spec, batch_size, seed=0)` beside an export bundle; returns
  its path."""
  sample = specs_lib.make_random_numpy(feature_spec, batch_size=batch_size,
                                       seed=0)
  payload = {key: np.asarray(value).tolist() for key, value in sample.items()}
  path = os.path.join(export_path, WARMUP_FILENAME)
  with open(path, "w") as f:
    json.dump({"inputs": payload}, f)
  return path


class _WarmupExportHook(hooks_lib.ExportHook):
  """An `ExportHook` whose synchronous exports get a warmup request (an
  asynchronous export returns no path to write it beside, as in the JAX
  package)."""

  def __init__(self, warmup_batch_size: int = 1, **kwargs):
    super().__init__(**kwargs)
    self._warmup_batch_size = warmup_batch_size

  def after_checkpoint(self, ctx, step):
    path = super().after_checkpoint(ctx, step)
    if path:
      write_warmup_request(
          path, ctx.model.preprocessor.get_in_feature_specification(
              modes_lib.PREDICT), batch_size=self._warmup_batch_size)
    return path


@config.configurable
class TD3HookBuilder(hooks_lib.HookBuilder):
  """Current and lagged export directories, with warmup requests."""

  def __init__(self, export_generator=None, num_versions: int = 3,
               batch_size: int = 1):
    self._export_generator = export_generator
    self._num_versions = num_versions
    self._batch_size = batch_size

  def create_hooks(self, model, model_dir) -> List[hooks_lib.Hook]:
    return [_WarmupExportHook(
        warmup_batch_size=self._batch_size,
        export_generator=self._export_generator,
        num_versions=self._num_versions,
        lagged_export_dir_name="lagged_export")]
