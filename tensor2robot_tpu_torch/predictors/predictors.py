"""Predictors: hold a model's parameters on a device and serve
`predict(features) -> dict`.

Counterpart of `tensor2robot_tpu.predictors.predictors` (serving subset):
`CheckpointPredictor` with random init from a seed, parameters carried
over from the JAX package (`bridge.py`), the newest verified checkpoint a
port trainer wrote to `model_dir`, and the two serving seams,
`serving_bundle()` and `decode_bundle()`.
"""

from __future__ import annotations

import abc
import functools
import os
import threading
import time
from typing import Any, Callable, Dict, Mapping, NamedTuple, Optional

import numpy as np
import torch

from tensor2robot_tpu_torch import checkpoints as checkpoints_lib
from tensor2robot_tpu_torch import modes as modes_lib
from tensor2robot_tpu_torch import specs as specs_lib
from tensor2robot_tpu_torch.obs import metrics as obs_metrics
from tensor2robot_tpu_torch.parallel import train_step as ts
from tensor2robot_tpu_torch.utils import config
from tensor2robot_tpu_torch.utils import device as device_lib

__all__ = ["AbstractPredictor", "CheckpointPredictor", "ServingBundle",
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


@config.configurable
class CheckpointPredictor(AbstractPredictor):
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
    self._model = model
    self._checkpoint_dir = None
    if model_dir is not None:
      nested = os.path.join(model_dir, checkpoints_lib.CHECKPOINT_DIRNAME)
      self._checkpoint_dir = (nested if os.path.isdir(nested)
                              or not os.path.isdir(model_dir) else model_dir)
    self._device = device_lib.resolve_device(device)
    self._state: Optional[ts.TrainState] = None
    self._staged: Optional[ts.TrainState] = None
    self._staged_lock = threading.Lock()
    self._predict_fn = ts.make_predict_fn(model)
    self._global_step = -1

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
    return self._global_step

  def init_randomly(self, seed: int = 0) -> None:
    """Random parameters from a seeded `torch.Generator` (flax's default
    initializers; the numbers differ from JAX's for the same seed)."""
    generator = torch.Generator().manual_seed(seed)
    self._state = ts.create_train_state(self._model, generator, self._device)
    self._global_step = 0

  def load_params(self, params: Mapping[str, Any],
                  ema_params: Optional[Mapping[str, Any]] = None,
                  global_step: int = 0,
                  mutable_state: Optional[Mapping[str, Any]] = None) -> None:
    """Stages a parameter `state_dict` (and EMA shadow, and mutable state:
    the model's initial one when None) for the next `restore()`. Keys and
    shapes must match the model's."""
    module = self._model.module
    expected_params = dict(module.named_parameters())
    expected_buffers = dict(module.named_buffers())
    if mutable_state is None:
      mutable_state = self._model.init_mutable_state()
    staged = {}
    for name, tree, expected in (
        ("params", params, expected_params),
        ("ema_params", ema_params, expected_params),
        ("mutable_state", mutable_state, expected_buffers)):
      if tree is None:
        staged[name] = None
        continue
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
      staged[name] = out
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
    self._state = staged
    self._global_step = staged.step
    return True

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
    self.assert_is_loaded()
    start = time.perf_counter()
    outputs = self._predict_fn(self._state, self._preprocess(features))
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
