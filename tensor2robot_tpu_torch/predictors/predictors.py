"""Predictors: hold a model's parameters on a device and serve
`predict(features) -> dict`.

Counterpart of `tensor2robot_tpu.predictors.predictors`:

* `CheckpointPredictor`: random init from a seed, parameters carried over
  from the JAX package (`bridge.py`), or the newest verified checkpoint a
  port trainer wrote to `model_dir`;
* `ExportedModelPredictor`: the newest complete bundle under an export
  directory (`export.export_generator`), polled for with a timeout,
  optionally on a background thread; each `restore()` swaps a newer
  bundle in;
* `EnsemblePredictor`: the mean over a random subsample of members.

The first two share one serving surface (`_TorchPredictorBase`): the
eval-mode `predict`, `device`, `global_step`, and the two serving seams
`serving_bundle()` and `decode_bundle()`, so `BucketedEngine`,
`MicroBatcher`, the CEM policies and `SessionEngine` take either. A swap
replaces the state in one assignment and `global_step` is read from it,
so a step read before and after a call that saw the same value names the
parameters that served it.
"""

from __future__ import annotations

import abc
import functools
import importlib
import json
import os
import threading
import time
from typing import (Any, Callable, Dict, List, Mapping, NamedTuple, Optional,
                    Sequence)

import numpy as np
import torch

from tensor2robot_tpu_torch import checkpoints as checkpoints_lib
from tensor2robot_tpu_torch import modes as modes_lib
from tensor2robot_tpu_torch import specs as specs_lib
from tensor2robot_tpu_torch.export import export_generator as export_lib
from tensor2robot_tpu_torch.obs import metrics as obs_metrics
from tensor2robot_tpu_torch.parallel import train_step as ts
from tensor2robot_tpu_torch.utils import config
from tensor2robot_tpu_torch.utils import device as device_lib

__all__ = ["AbstractPredictor", "CheckpointPredictor",
           "ExportedModelPredictor", "EnsemblePredictor", "ServingBundle",
           "DecodeBundle"]


class ServingBundle(NamedTuple):
  """What a stateless serving runtime needs from a predictor."""

  predict_fn: Callable       # (state, model_features) -> outputs
  get_state: Callable        # () -> current TrainState (restore-aware)
  preprocess: Callable       # wire features -> model-layout features
  feature_spec: Any          # wire-layout feature spec


class DecodeBundle(NamedTuple):
  """What `serving.session.SessionEngine` needs from a predictor."""

  decode_fn: Callable          # (state, session_state, features)
                               #   -> (new_session_state, outputs)
  init_session_state: Callable  # (batch_size) -> state rows on the device
  get_state: Callable          # () -> current TrainState (restore-aware)
  observation_spec: Any        # per-tick feature spec
  max_ticks: Optional[int] = None  # decode horizon (KV capacity)
  decode_arena_fn: Optional[Callable] = None  # (state, arena, slots,
                               #   features, mask) -> (arena, outputs)


class AbstractPredictor(abc.ABC):
  """The robot-side serving contract."""

  @abc.abstractmethod
  def predict(self, features: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    ...

  @abc.abstractmethod
  def get_feature_specification(self) -> specs_lib.SpecStruct:
    ...

  @abc.abstractmethod
  def restore(self) -> bool:
    """Swaps in the newest parameters; returns True on success."""

  @property
  def model_version(self) -> int:
    return self.global_step

  @property
  def global_step(self) -> int:
    return -1

  def assert_is_loaded(self) -> None:
    if self.global_step < 0:
      raise ValueError(f"{type(self).__name__} has no model loaded; call "
                       "init_randomly() or load_params() + restore() first.")

  def close(self) -> None:
    pass


class _TorchPredictorBase(AbstractPredictor):
  """A model's eval-mode predict on one device over a swappable state."""

  def __init__(self, model, device):
    self._device = device_lib.resolve_device(device)
    self._state: Optional[ts.TrainState] = None
    self._model = None
    self._predict_fn = None
    if model is not None:
      self._set_model(model)

  def _set_model(self, model) -> None:
    self._model = model
    self._predict_fn = ts.make_predict_fn(model)

  @property
  def device(self) -> torch.device:
    return self._device

  @property
  def model(self):
    return self._model

  @property
  def state(self) -> Optional[ts.TrainState]:
    return self._state

  @property
  def global_step(self) -> int:
    state = self._state
    return -1 if state is None else int(state.step)

  def place_on_device(self, device) -> None:
    """Moves the served state onto `device` and keeps it there: the
    serving fleet's replica pinning seam. Every later `restore()` loads
    onto this device, so a rollout never migrates a replica off its
    device group."""
    self.assert_is_loaded()
    self._device = torch.device(device)
    self._state = self._state.to(self._device)

  def _to_device(self, features: Mapping[str, Any]) -> specs_lib.SpecStruct:
    out = specs_lib.SpecStruct()
    for key, value in specs_lib.flatten_spec_structure(features).items():
      out[key] = torch.as_tensor(np.asarray(value), device=self._device)
    return out

  def _preprocess(self, features) -> specs_lib.SpecStruct:
    features, _ = self._model.preprocessor.preprocess(
        self._to_device(features), specs_lib.SpecStruct(), modes_lib.PREDICT)
    return features

  def predict(self, features) -> Dict[str, np.ndarray]:
    return self._timed_predict(features, self._preprocess)

  def predict_preprocessed(self, features) -> Dict[str, np.ndarray]:
    """Predict on model-layout (already preprocessed) features: the
    layout a model's `pack_features` builds, not the wire layout."""
    return self._timed_predict(features, self._to_device)

  def _timed_predict(self, features, prepare) -> Dict[str, np.ndarray]:
    self.assert_is_loaded()
    start = time.perf_counter()
    outputs = self._predict_fn(self._state, prepare(features))
    result = {k: v.cpu().numpy() for k, v in outputs.items()}
    obs_metrics.histogram("serve/predict_ms").record(
        (time.perf_counter() - start) * 1e3)
    obs_metrics.counter("serve/predictions").inc()
    return result

  def get_feature_specification(self) -> specs_lib.SpecStruct:
    return self._model.preprocessor.get_in_feature_specification(
        modes_lib.PREDICT)

  def serving_bundle(self) -> ServingBundle:
    """The stateless serving seam: the predict function, a restore-aware
    state getter, the wire -> model preprocess and the wire spec."""
    self.assert_is_loaded()
    return ServingBundle(
        predict_fn=self._predict_fn,
        get_state=lambda: self._state,
        preprocess=self._preprocess,
        feature_spec=self.get_feature_specification())

  def decode_bundle(self) -> DecodeBundle:
    """The session-serving seam: the model's decode functions, its
    session-state initializer on this device, and the same restore-aware
    state getter as `serving_bundle`."""
    self.assert_is_loaded()
    model = self._model
    if not model.supports_sessions:
      raise ValueError(
          f"{type(model).__name__} has no session-decode seam "
          "(supports_sessions is False).")
    return DecodeBundle(
        decode_fn=model.decode_step_fn(),
        init_session_state=functools.partial(model.init_session_state,
                                             device=self._device),
        get_state=lambda: self._state,
        observation_spec=model.decode_observation_spec,
        max_ticks=getattr(model, "decode_max_ticks", None),
        decode_arena_fn=(model.decode_arena_step_fn()
                         if model.supports_decode_kernel else None))

  def _checked(self, name: str, tree: Mapping[str, Any],
               expected: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """`tree` as f32 tensors on this device; its keys and shapes must be
    the model's."""
    if set(tree) != set(expected):
      raise ValueError(
          f"{name} keys differ from the model's: missing "
          f"{sorted(set(expected) - set(tree))}, unexpected "
          f"{sorted(set(tree) - set(expected))}")
    out = {}
    for key, value in tree.items():
      value = torch.as_tensor(value).to(self._device, torch.float32)
      if value.shape != expected[key].shape:
        raise ValueError(f"{name}[{key!r}] has shape {tuple(value.shape)}, "
                         f"the model's is {tuple(expected[key].shape)}")
      out[key] = value
    return out


@config.configurable
class CheckpointPredictor(_TorchPredictorBase):
  """Serves a model object's predict path on one device.

  Parameters (and the mutable state: batch-norm running statistics) come
  from `init_randomly(seed)`, from `load_params(...)` (for example a JAX
  variable tree carried over by `bridge.py`), which stages them, or from
  the checkpoints a trainer wrote under `model_dir`. `predict` runs the
  eval-mode forward: EMA parameters when kept, running statistics.
  `restore()` swaps staged parameters in, or else the newest verified
  checkpoint (a corrupt newest step is quarantined and the next newest
  serves). Sessions that an engine holds keep their state across a swap:
  the bundles read the state through a getter on every call.
  """

  def __init__(self, model=None, model_dir: Optional[str] = None,
               device=None):
    if model is None:
      raise ValueError("model is required.")
    self._checkpoint_dir = None
    if model_dir is not None:
      nested = os.path.join(model_dir, checkpoints_lib.CHECKPOINT_DIRNAME)
      self._checkpoint_dir = (nested if os.path.isdir(nested)
                              or not os.path.isdir(model_dir) else model_dir)
    super().__init__(model, device)
    self._staged: Optional[ts.TrainState] = None
    self._staged_lock = threading.Lock()

  def init_randomly(self, seed: int = 0) -> None:
    """Random parameters from a seeded `torch.Generator` (flax's default
    initializers; the numbers differ from JAX's for the same seed)."""
    generator = torch.Generator().manual_seed(seed)
    self._state = ts.create_train_state(self._model, generator, self._device)

  def load_params(self, params: Mapping[str, Any],
                  ema_params: Optional[Mapping[str, Any]] = None,
                  global_step: int = 0,
                  mutable_state: Optional[Mapping[str, Any]] = None) -> None:
    """Stages a parameter `state_dict` (and EMA shadow, and mutable state:
    the model's initial one when None) for the next `restore()`. Keys and
    shapes must match the model's."""
    module = self._model.module
    expected_params = dict(module.named_parameters())
    if mutable_state is None:
      mutable_state = self._model.init_mutable_state()
    staged = {}
    for name, tree, expected in (
        ("params", params, expected_params),
        ("ema_params", ema_params, expected_params),
        ("mutable_state", mutable_state, dict(module.named_buffers()))):
      staged[name] = None if tree is None else self._checked(name, tree,
                                                             expected)
    with self._staged_lock:
      self._staged = ts.TrainState(step=int(global_step), **staged)

  def restore(self) -> bool:
    """Swaps in the parameters staged by `load_params`, or else the newest
    verified checkpoint under `model_dir`; False when there is neither."""
    with self._staged_lock:
      staged, self._staged = self._staged, None
    if staged is None and self._checkpoint_dir is not None \
        and os.path.isdir(self._checkpoint_dir):
      manager = checkpoints_lib.CheckpointManager(self._checkpoint_dir)
      if manager.latest_step() is not None:
        staged = manager.restore(device=self._device).replace(opt_state=None)
    if staged is None:
      return False
    self._state = staged.to(self._device)
    return True


# -- export bundles -------------------------------------------------------------

_JAX_PACKAGE = "tensor2robot_tpu"


def _valid_export_dirs(export_root: str) -> List[str]:
  """The complete bundles under `export_root`, oldest first: digit-named
  directories with assets (JSON, or the pbtxt under `assets.extra/`), a
  signature and params."""
  if not os.path.isdir(export_root):
    return []
  out = []
  for name in os.listdir(export_root):
    path = os.path.join(export_root, name)
    if not name.isdigit():
      continue
    has_assets = (
        os.path.isfile(os.path.join(path, specs_lib.ASSET_FILENAME))
        or os.path.isfile(os.path.join(path, "assets.extra",
                                       specs_lib.PBTXT_ASSET_FILENAME)))
    if (has_assets
        and os.path.isfile(os.path.join(path, export_lib.SIGNATURE_FILENAME))
        and os.path.isdir(os.path.join(path, export_lib.PARAMS_DIRNAME))):
      out.append(path)
  return sorted(out, key=lambda p: int(os.path.basename(p)))


def _model_from_bundle(path: str):
  """The model a bundle names in `signature.json`, built after parsing
  the bundle's `operative_config.gin`, which REBINDS the process's
  configurables (where a trainer shares the process, pass `model=` to the
  predictor instead). A bundle naming a class of the JAX package is
  refused before anything of it is imported."""
  with open(os.path.join(path, export_lib.SIGNATURE_FILENAME)) as f:
    signature = json.load(f)
  module_name, _, class_name = signature["model_class"].rpartition(".")
  if module_name.split(".")[0] == _JAX_PACKAGE:
    raise ValueError(
        f"the bundle {path} names the JAX package's model class "
        f"{signature['model_class']!r}; the port does not import the JAX "
        "package. Export the checkpoint with the port, or pass model= (and "
        "carry JAX variables across with bridge.py).")
  config_path = os.path.join(path, export_lib.OPERATIVE_CONFIG_FILENAME)
  if os.path.isfile(config_path):
    config.parse_config_file(config_path)
  cls = importlib.import_module(module_name)
  for part in class_name.split("."):
    cls = getattr(cls, part)
  return cls()


@config.configurable
class ExportedModelPredictor(_TorchPredictorBase):
  """Serves the newest complete bundle under `export_dir`.

  `restore()` polls up to `timeout_secs` for a first bundle (every
  second; `close()` interrupts the wait), and loads the newest one when it
  is not the one loaded: its eval-time parameters and mutable state
  become the served state in one swap, with `global_step` from its
  assets. The model comes from `model=`, else from the bundle
  (`_model_from_bundle`). `restore_async()` runs `restore` on a thread.
  """

  def __init__(self, export_dir: Optional[str] = None, model=None,
               timeout_secs: float = 0.0, device=None):
    if export_dir is None:
      raise ValueError("export_dir is required.")
    super().__init__(model, device)
    self._export_dir = export_dir
    self._timeout_secs = timeout_secs
    self._loaded_path: Optional[str] = None
    self._restore_thread: Optional[threading.Thread] = None
    self._restore_lock = threading.Lock()
    self._stop_restore = threading.Event()

  @property
  def loaded_path(self) -> Optional[str]:
    return self._loaded_path

  def restore(self) -> bool:
    deadline = time.time() + self._timeout_secs
    dirs = _valid_export_dirs(self._export_dir)
    while (not dirs and time.time() < deadline
           and not self._stop_restore.is_set()):
      self._stop_restore.wait(timeout=1.0)
      dirs = _valid_export_dirs(self._export_dir)
    if not dirs:
      return False
    with self._restore_lock:
      if dirs[-1] != self._loaded_path:
        self._load(dirs[-1])
    return True

  def _load(self, path: str) -> None:
    assets = specs_lib.load_assets(os.path.join(path,
                                                specs_lib.ASSET_FILENAME))
    if self._model is None:
      self._set_model(_model_from_bundle(path))
    variables = torch.load(
        os.path.join(path, export_lib.PARAMS_DIRNAME,
                     export_lib.VARIABLES_FILENAME),
        map_location=self._device, weights_only=True)
    module = self._model.module
    state = ts.TrainState(
        step=int(assets.global_step or 0),
        params=self._checked("params", variables["params"],
                             dict(module.named_parameters())),
        mutable_state=self._checked("mutable", variables.get("mutable") or {},
                                    dict(module.named_buffers())))
    self._state = state
    self._loaded_path = path

  def restore_async(self) -> threading.Thread:
    """`restore()` on a thread (returned; `close()` joins it)."""
    # Backstop exemption (the JAX package's): a one-shot restore worker
    # with no loop — it terminates by itself after one bundle load.
    thread = threading.Thread(
        target=self.restore, name="export-restore",
        daemon=True)  # graftlint: disable=thread-stage-missing-backstop
    thread.start()
    self._restore_thread = thread
    return thread

  def close(self) -> None:
    """Interrupts a `restore()` waiting for a first bundle and joins the
    `restore_async` thread; a later `restore()` works again."""
    self._stop_restore.set()
    thread = self._restore_thread
    if thread is not None and thread.is_alive():
      thread.join()
    self._stop_restore.clear()


@config.configurable
class EnsemblePredictor(AbstractPredictor):
  """The mean of each output over a random subsample (`num_samples`,
  default all) of member predictors, drawn by a seeded numpy generator."""

  def __init__(self, predictors: Optional[Sequence[AbstractPredictor]] = None,
               num_samples: Optional[int] = None, seed: int = 0):
    if not predictors:
      raise ValueError("predictors are required.")
    self._predictors = list(predictors)
    self._num_samples = num_samples or len(self._predictors)
    self._rng = np.random.RandomState(seed)

  def restore(self) -> bool:
    return all(p.restore() for p in self._predictors)

  def get_feature_specification(self) -> specs_lib.SpecStruct:
    return self._predictors[0].get_feature_specification()

  @property
  def global_step(self) -> int:
    return min(p.global_step for p in self._predictors)

  def predict(self, features) -> Dict[str, np.ndarray]:
    chosen = self._rng.choice(len(self._predictors), self._num_samples,
                              replace=False)
    outputs = [self._predictors[i].predict(features) for i in chosen]
    return {k: np.mean([o[k] for o in outputs], axis=0) for k in outputs[0]}

  def close(self) -> None:
    for p in self._predictors:
      p.close()
