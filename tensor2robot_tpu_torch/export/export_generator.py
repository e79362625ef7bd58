"""Export generators: serving bundles a robot-side predictor loads without
the trainer.

Counterpart of `tensor2robot_tpu.export.export_generator`. A bundle under
`<base>/<version>/` holds:

* `t2r_assets.json` and `assets.extra/t2r_assets.pbtxt`: the serving
  feature and label specs and the global step (`specs.Assets`);
* `signature.json`: the port's model class and configurable name, the
  serving output keys, the receiver flags and the global step;
* `operative_config.gin`: the port's `config.operative_config_str()`,
  from which a predictor without a model object rebuilds it;
* `params/variables.pt`: `torch.save` of {"params": the eval-time
  parameters (the EMA shadow when the state keeps one), "mutable": the
  mutable state (batch-norm statistics)}, tensors on the CPU;
* with `write_saved_model=True`, `saved_model/`: a `torch.export`
  program of the predict function (`export.saved_model`), served by
  `predictors.saved_model_predictor.SavedModelPredictor`.

`version` is microseconds since the epoch, above every version already
under `base`. The JAX package creates the version directory and then
fills it; here a version is written into a hidden `.<version>.tmp-<pid>`
directory and renamed into place, as the port's checkpoints are, so a
poller never sees a half-written digit-named bundle.

As in the JAX package, the SavedModel embeds the preprocessor when it is
not the identity and runs on torch ops alone (it runs on fake tensors);
a preprocessor that computes on the host is refused at
`set_specification_from_model` unless `export_raw_receivers=True`, where
clients feed model-layout features.
"""

from __future__ import annotations

import json
import logging
import os
import shutil
import time
from typing import List, Optional

import numpy as np
import torch

from tensor2robot_tpu_torch import modes as modes_lib
from tensor2robot_tpu_torch import specs as specs_lib
from tensor2robot_tpu_torch.export import saved_model as saved_model_lib
from tensor2robot_tpu_torch.parallel import train_step as ts
from tensor2robot_tpu_torch.preprocessors import base as preprocessors_lib
from tensor2robot_tpu_torch.utils import config

__all__ = ["AbstractExportGenerator", "DefaultExportGenerator",
           "SIGNATURE_FILENAME", "PARAMS_DIRNAME", "VARIABLES_FILENAME",
           "OPERATIVE_CONFIG_FILENAME", "SAVED_MODEL_DIRNAME",
           "directory_bytes"]

SIGNATURE_FILENAME = "signature.json"
PARAMS_DIRNAME = "params"
VARIABLES_FILENAME = "variables.pt"
OPERATIVE_CONFIG_FILENAME = "operative_config.gin"
SAVED_MODEL_DIRNAME = saved_model_lib.SAVED_MODEL_DIRNAME

_log = logging.getLogger(__name__)


def directory_bytes(path: str) -> int:
  """Bytes of every file under `path`."""
  return sum(os.path.getsize(os.path.join(root, name))
             for root, _, names in os.walk(path) for name in names)


def _unwrap_preprocessor(preprocessor):
  """The preprocessor under the bfloat16 device policy (its cast is
  applied again by the predict path)."""
  if isinstance(preprocessor, preprocessors_lib.Bfloat16DevicePolicy):
    return preprocessor.inner
  return preprocessor


def _newest_version(base: str) -> int:
  return max((int(name) for name in os.listdir(base) if name.isdigit()),
             default=0)


class AbstractExportGenerator:
  """Holds the model; writes versioned export bundles."""

  def __init__(self, export_raw_receivers: bool = False):
    # Raw receivers skip the preprocessor in serving: clients send
    # model-layout features.
    self._export_raw_receivers = export_raw_receivers
    self._model = None

  def set_specification_from_model(self, model) -> None:
    self._model = model

  def _serving_feature_spec(self) -> specs_lib.SpecStruct:
    if self._model is None:
      raise ValueError("Call set_specification_from_model first.")
    if self._export_raw_receivers:
      return specs_lib.flatten_spec_structure(
          self._model.get_feature_specification(modes_lib.PREDICT))
    return self._model.preprocessor.get_in_feature_specification(
        modes_lib.PREDICT)

  def prepare(self, state: ts.TrainState) -> None:
    """Work that needs the live state, run on the trainer's thread before
    an asynchronous export takes its host snapshot. Default: none."""

  def export(self, state: ts.TrainState, export_dir_base: str,
             global_step: Optional[int] = None) -> str:
    raise NotImplementedError


@config.configurable
class DefaultExportGenerator(AbstractExportGenerator):
  """Writes the port's bundle (module docstring)."""

  def __init__(self, export_raw_receivers: bool = False,
               write_saved_model: bool = False):
    super().__init__(export_raw_receivers=export_raw_receivers)
    self._write_saved_model = write_saved_model
    self._embed_preprocessor = False
    self._outputs: Optional[List[str]] = None

  def set_specification_from_model(self, model) -> None:
    """With `write_saved_model`, fails fast (before any training or
    write) when the SavedModel could not serve what the bundle serves."""
    super().set_specification_from_model(model)
    self._outputs = None
    if self._write_saved_model:
      self._check_saved_model_compat(model)

  def _check_saved_model_compat(self, model) -> None:
    """Decides whether the SavedModel embeds the preprocessor: not for
    raw receivers or the identity, yes for one on torch ops; a
    preprocessor that computes on the host raises."""
    self._embed_preprocessor = False
    inner = _unwrap_preprocessor(model.preprocessor)
    if self._export_raw_receivers or isinstance(
        inner, preprocessors_lib.NoOpPreprocessor):
      return
    if saved_model_lib.preprocess_is_traceable(model.preprocessor):
      self._embed_preprocessor = True
      return
    raise ValueError(
        f"write_saved_model=True with the non-embeddable host-side "
        f"preprocessor {type(inner).__name__} requires "
        "export_raw_receivers=True (clients feed model-layout, "
        "already-preprocessed features); the bundle applies the "
        "preprocessor and serves wire-layout features.")

  def prepare(self, state: ts.TrainState) -> None:
    """Probes the serving output keys once, with one row through the
    predict path on the state's device."""
    if self._outputs is None:
      self._outputs = self._infer_output_keys(state)

  def _infer_output_keys(self, state: ts.TrainState) -> List[str]:
    model = self._model
    device = next(iter(state.params.values())).device
    sample = specs_lib.make_random_numpy(self._serving_feature_spec(),
                                         batch_size=1, seed=0)
    try:
      features = specs_lib.SpecStruct({
          k: torch.as_tensor(np.asarray(v), device=device)
          for k, v in sample.items()})
      if not self._export_raw_receivers:
        features, _ = model.preprocessor.preprocess(
            features, specs_lib.SpecStruct(), modes_lib.PREDICT)
      return sorted(ts.make_predict_fn(model)(state, features).keys())
    except Exception:  # noqa: BLE001 - the bundle is still written
      _log.exception("Could not infer the serving output keys of %s; the "
                     "bundle's predict path is likely broken.",
                     type(model).__name__)
      return []

  def export(self, state: ts.TrainState, export_dir_base: str,
             global_step: Optional[int] = None) -> str:
    """Writes one bundle of `state` under `export_dir_base`; returns its
    path. `global_step` defaults to the state's step."""
    model = self._model
    if model is None:
      raise ValueError("Call set_specification_from_model first.")
    step = int(global_step if global_step is not None else state.step)
    self.prepare(state)
    os.makedirs(export_dir_base, exist_ok=True)
    version = str(max(int(time.time() * 1e6),
                      _newest_version(export_dir_base) + 1))
    path = os.path.join(export_dir_base, version)
    tmp = os.path.join(export_dir_base, f".{version}.tmp-{os.getpid()}")
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    try:
      if self._write_saved_model:
        self._check_saved_model_compat(model)  # the model may be new
      feature_spec = self._serving_feature_spec()
      assets = specs_lib.Assets(
          feature_spec=feature_spec,
          label_spec=specs_lib.flatten_spec_structure(
              model.get_label_specification(modes_lib.PREDICT)),
          global_step=step)
      specs_lib.write_assets(assets, os.path.join(tmp,
                                                  specs_lib.ASSET_FILENAME))
      specs_lib.write_assets_pbtxt(assets, os.path.join(
          tmp, "assets.extra", specs_lib.PBTXT_ASSET_FILENAME))
      variables = ts.map_tensors(lambda x: x.detach().cpu(), {
          "params": state.eval_params(use_ema=True),
          "mutable": state.mutable_state})
      os.makedirs(os.path.join(tmp, PARAMS_DIRNAME))
      with open(os.path.join(tmp, PARAMS_DIRNAME, VARIABLES_FILENAME),
                "wb") as f:
        torch.save(variables, f)
        f.flush()
        os.fsync(f.fileno())
      signature = {
          "model_configurable": getattr(type(model), "_configurable_name",
                                        type(model).__name__),
          "model_class": f"{type(model).__module__}."
                         f"{type(model).__qualname__}",
          "outputs": self._outputs,
          "raw_receivers": self._export_raw_receivers,
          "preprocessor_embedded": self._embed_preprocessor,
          "global_step": step,
      }
      with open(os.path.join(tmp, SIGNATURE_FILENAME), "w") as f:
        json.dump(signature, f, indent=2)
      with open(os.path.join(tmp, OPERATIVE_CONFIG_FILENAME), "w") as f:
        f.write(config.operative_config_str())
      if self._write_saved_model:
        saved_model_dir = os.path.join(tmp, SAVED_MODEL_DIRNAME)
        saved_model_lib.write_saved_model(
            model, state.replace(step=step), feature_spec,
            self._embed_preprocessor, saved_model_dir)
        specs_lib.write_assets_pbtxt(assets, os.path.join(
            saved_model_dir, "assets.extra", specs_lib.PBTXT_ASSET_FILENAME))
      os.replace(tmp, path)
    except BaseException:
      shutil.rmtree(tmp, ignore_errors=True)
      raise
    return path
