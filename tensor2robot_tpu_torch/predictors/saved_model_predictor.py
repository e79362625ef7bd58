"""SavedModel predictor: serves the `torch.export` program of an export
bundle's `saved_model/` without the model's code.

Counterpart of `tensor2robot_tpu.predictors.saved_model_predictor`. The
JAX package loads a TensorFlow SavedModel and calls it through the TF
runtime; the port loads the program that its own
`DefaultExportGenerator(write_saved_model=True)` writes
(`export.saved_model`) and calls it on a device, CUDA unless the caller
passes `device='cpu'`. A TensorFlow SavedModel (a `saved_model.pb`, in
`saved_model/` or at the bundle's root) is refused at `restore()`: there
is no TensorFlow runtime beside the port.

`restore()` waits up to `timeout_secs` for a bundle with a SavedModel and
loads the newest. Before it serves, it checks the bundle's feature specs
against the program's declared feeds: two specs with one feed name, or
names that differ from the declared ones, raise `ValueError`.
"""

from __future__ import annotations

import glob
import os
import time
from typing import Any, Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch

from tensor2robot_tpu_torch import specs as specs_lib
from tensor2robot_tpu_torch.export import saved_model as saved_model_lib
from tensor2robot_tpu_torch.predictors import predictors as predictors_lib
from tensor2robot_tpu_torch.utils import config
from tensor2robot_tpu_torch.utils import device as device_lib

__all__ = ["SavedModelPredictor"]

_TF_SAVED_MODEL = "saved_model.pb"


def _tf_saved_model(path: str) -> Optional[str]:
  """The TensorFlow SavedModel file of a bundle directory, if it has one."""
  for candidate in (
      os.path.join(path, saved_model_lib.SAVED_MODEL_DIRNAME,
                   _TF_SAVED_MODEL),
      os.path.join(path, _TF_SAVED_MODEL)):
    if os.path.isfile(candidate):
      return candidate
  return None


def _bundle_dirs(export_dir: str) -> List[str]:
  """Digit-named bundles holding a SavedModel of either kind: a complete
  port bundle with its program, or any directory with a TensorFlow one.
  Oldest first."""
  valid = set(predictors_lib._valid_export_dirs(export_dir))
  out = []
  for path in glob.glob(os.path.join(export_dir, "*")):
    program = os.path.join(path, saved_model_lib.SAVED_MODEL_DIRNAME,
                           saved_model_lib.PROGRAM_FILENAME)
    if os.path.basename(path).isdigit() and (
        _tf_saved_model(path) or (path in valid and os.path.isfile(program))):
      out.append(path)
  return sorted(out, key=lambda p: int(os.path.basename(p)))


@config.configurable
class SavedModelPredictor(predictors_lib.AbstractPredictor):
  """Loads `<bundle>/saved_model/` and serves its program (module doc)."""

  def __init__(self, export_dir: Optional[str] = None,
               timeout_secs: float = 0.0, device=None):
    if export_dir is None:
      raise ValueError("export_dir is required.")
    self._export_dir = export_dir
    self._timeout_secs = timeout_secs
    self._device = device_lib.resolve_device(device)
    self._program = None
    self._assets: Optional[specs_lib.Assets] = None
    self._inputs: List[Dict[str, Any]] = []

  @property
  def device(self) -> torch.device:
    return self._device

  def restore(self) -> bool:
    deadline = time.time() + self._timeout_secs
    dirs = _bundle_dirs(self._export_dir)
    while not dirs and time.time() < deadline:
      time.sleep(1.0)
      dirs = _bundle_dirs(self._export_dir)
    if not dirs:
      return False
    newest = dirs[-1]
    tf_file = _tf_saved_model(newest)
    if tf_file is not None:
      raise ValueError(
          f"{newest} holds a TensorFlow SavedModel ({tf_file}); the port "
          "serves only its own torch.export program. Export the "
          "checkpoint with the port's DefaultExportGenerator("
          "write_saved_model=True).")
    directory = os.path.join(newest, saved_model_lib.SAVED_MODEL_DIRNAME)
    assets = specs_lib.load_assets(
        os.path.join(newest, specs_lib.ASSET_FILENAME))
    signature = saved_model_lib.read_signature(directory)
    self._validate_feeds(assets, signature)
    self._program = saved_model_lib.load_program(directory, self._device)
    self._assets = assets
    self._inputs = signature["inputs"]
    return True

  @staticmethod
  def _validate_feeds(assets: specs_lib.Assets,
                      signature: Mapping[str, Any]) -> None:
    """Feed name -> feature key, checked: two specs sharing a feed name
    would overwrite each other, and names that differ from the program's
    declared inputs would feed the wrong tensors."""
    feeds: Dict[str, str] = {}
    for key, spec in specs_lib.filter_required(
        assets.feature_spec).items():
      name = saved_model_lib.feed_name(key, spec)
      if name in feeds:
        raise ValueError(
            f"Feature specs {feeds[name]!r} and {key!r} both feed serving "
            f"signature input {name!r}; give them distinct spec names.")
      feeds[name] = key
    declared = [spec["name"] for spec in signature["inputs"]]
    if set(feeds) != set(declared):
      raise ValueError(
          "Feature spec names do not match the serving_default signature "
          f"inputs. Signature declares {sorted(declared)}; specs feed "
          f"{sorted(feeds)} (missing: {sorted(set(declared) - set(feeds))}, "
          f"unexpected: {sorted(set(feeds) - set(declared))}).")

  def get_feature_specification(self) -> specs_lib.SpecStruct:
    self.assert_is_loaded()
    return self._assets.feature_spec

  @property
  def global_step(self) -> int:
    if self._assets is None:
      return -1
    return int(self._assets.global_step or 0)

  def _run(self, arrays: Sequence[np.ndarray]) -> Dict[str, np.ndarray]:
    with torch.no_grad():
      outputs = self._program(*(
          torch.as_tensor(np.asarray(a, dtype=spec["dtype"]),
                          device=self._device)
          for a, spec in zip(arrays, self._inputs)))
    return {k: v.cpu().numpy() for k, v in outputs.items()}

  def predict(self, features: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    self.assert_is_loaded()
    flat = specs_lib.flatten_spec_structure(dict(features))
    return self._run([flat[spec["key"]] for spec in self._inputs])

  def predict_tf_example(self, serialized: Sequence[bytes]
                         ) -> Dict[str, np.ndarray]:
    """Serialized `tf.train.Example`s in (the tf_example receiver of the
    JAX package's SavedModel), outputs of the program out."""
    self.assert_is_loaded()
    return self._run(saved_model_lib.tf_example_feeds(serialized,
                                                      self._inputs))
