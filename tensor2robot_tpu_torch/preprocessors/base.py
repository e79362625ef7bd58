"""Preprocessor contract: the 4-spec layer between wire data and model.

Counterpart of `tensor2robot_tpu.preprocessors.base` (the subset the
serving path uses). A preprocessor declares in-specs (the wire layout)
and out-specs (what the model consumes) for features and labels;
`preprocess()` validates and packs the input, applies `_preprocess_fn`,
and validates and flattens the output. Values are torch tensors.
"""

from __future__ import annotations

import abc
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from tensor2robot_tpu_torch import modes as modes_lib
from tensor2robot_tpu_torch import specs as specs_lib
from tensor2robot_tpu_torch.utils import config

__all__ = ["AbstractPreprocessor", "NoOpPreprocessor",
           "SpecTransformationPreprocessor", "Bfloat16DevicePolicy"]

SpecGetter = Callable[[str], specs_lib.SpecStruct]


class AbstractPreprocessor(abc.ABC):
  """4-spec preprocessor contract."""

  def __init__(self,
               model_feature_specification_fn: Optional[SpecGetter] = None,
               model_label_specification_fn: Optional[SpecGetter] = None):
    self._model_feature_specification_fn = model_feature_specification_fn
    self._model_label_specification_fn = model_label_specification_fn

  def model_feature_specification(self, mode: str) -> specs_lib.SpecStruct:
    if self._model_feature_specification_fn is None:
      raise ValueError(
          f"{type(self).__name__} has no model feature specification fn.")
    return specs_lib.flatten_spec_structure(
        self._model_feature_specification_fn(mode))

  def model_label_specification(self, mode: str) -> specs_lib.SpecStruct:
    if self._model_label_specification_fn is None:
      raise ValueError(
          f"{type(self).__name__} has no model label specification fn.")
    return specs_lib.flatten_spec_structure(
        self._model_label_specification_fn(mode))

  @abc.abstractmethod
  def get_in_feature_specification(self, mode: str) -> specs_lib.SpecStruct:
    """Wire feature layout this preprocessor consumes."""

  @abc.abstractmethod
  def get_in_label_specification(self, mode: str) -> specs_lib.SpecStruct:
    """Wire label layout this preprocessor consumes."""

  @abc.abstractmethod
  def get_out_feature_specification(self, mode: str) -> specs_lib.SpecStruct:
    """Feature layout delivered to the model."""

  @abc.abstractmethod
  def get_out_label_specification(self, mode: str) -> specs_lib.SpecStruct:
    """Label layout delivered to the model."""

  @abc.abstractmethod
  def _preprocess_fn(self, features: specs_lib.SpecStruct,
                     labels: specs_lib.SpecStruct,
                     mode: str) -> Tuple[specs_lib.SpecStruct,
                                         specs_lib.SpecStruct]:
    """Pure transformation from in-layout to out-layout."""

  def preprocess(self, features, labels, mode: str
                 ) -> Tuple[specs_lib.SpecStruct, specs_lib.SpecStruct]:
    """Validate and pack in, transform, validate and flatten out. Inputs
    are batched (ignore_batch=True)."""
    modes_lib.validate(mode)
    in_f_spec = specs_lib.add_sequence_length_specs(
        self.get_in_feature_specification(mode))
    features = specs_lib.validate_and_pack(in_f_spec, features,
                                           ignore_batch=True)
    if labels is not None and len(labels):
      labels = specs_lib.validate_and_pack(
          specs_lib.add_sequence_length_specs(
              self.get_in_label_specification(mode)),
          labels, ignore_batch=True)
    else:
      labels = specs_lib.SpecStruct()
    out_features, out_labels = self._preprocess_fn(features, labels, mode)
    out_features = specs_lib.validate_and_flatten(
        specs_lib.add_sequence_length_specs(
            self.get_out_feature_specification(mode)),
        out_features, ignore_batch=True)
    if out_labels is not None and len(out_labels):
      out_labels = specs_lib.validate_and_flatten(
          specs_lib.add_sequence_length_specs(
              self.get_out_label_specification(mode)),
          out_labels, ignore_batch=True)
    return out_features, out_labels


@config.configurable
class NoOpPreprocessor(AbstractPreprocessor):
  """Identity preprocessor: in == out == model specs."""

  def get_in_feature_specification(self, mode):
    return self.model_feature_specification(mode)

  def get_in_label_specification(self, mode):
    return self.model_label_specification(mode)

  def get_out_feature_specification(self, mode):
    return self.model_feature_specification(mode)

  def get_out_label_specification(self, mode):
    return self.model_label_specification(mode)

  def _preprocess_fn(self, features, labels, mode):
    return features, labels


class SpecTransformationPreprocessor(AbstractPreprocessor):
  """Base for preprocessors whose out-specs equal the model specs and whose
  in-specs are rewrites of them, leaf by leaf.

  Subclasses override `update_in_spec(spec, key)` to rewrite single leaves
  (a float32 model image becomes a larger uint8 image on the wire) and
  `_preprocess_fn` to do the matching tensor transformation.
  """

  def get_out_feature_specification(self, mode):
    return self.model_feature_specification(mode)

  def get_out_label_specification(self, mode):
    return self.model_label_specification(mode)

  def get_in_feature_specification(self, mode):
    return specs_lib.SpecStruct(
        {key: self.update_in_spec(spec, key) for key, spec in
         self.model_feature_specification(mode).items()})

  def get_in_label_specification(self, mode):
    return specs_lib.SpecStruct(
        {key: self.update_in_spec(spec, key) for key, spec in
         self.model_label_specification(mode).items()})

  def update_in_spec(self, spec: specs_lib.TensorSpec,
                     key: str) -> specs_lib.TensorSpec:
    del key  # every leaf kept as it is
    return spec


@config.configurable
class Bfloat16DevicePolicy(AbstractPreprocessor):
  """Wraps a preprocessor for the bfloat16 device policy: the wire side
  stays float32, the model-facing out-specs become bfloat16, and optional
  specs are dropped from the out-specs."""

  def __init__(self, preprocessor: AbstractPreprocessor):
    super().__init__()
    self._preprocessor = preprocessor

  @property
  def inner(self) -> AbstractPreprocessor:
    return self._preprocessor

  def get_in_feature_specification(self, mode):
    return self._preprocessor.get_in_feature_specification(mode)

  def get_in_label_specification(self, mode):
    return self._preprocessor.get_in_label_specification(mode)

  def get_out_feature_specification(self, mode):
    out = specs_lib.filter_required(
        self._preprocessor.get_out_feature_specification(mode))
    return specs_lib.replace_dtype(out, np.float32, torch.bfloat16)

  def get_out_label_specification(self, mode):
    out = specs_lib.filter_required(
        self._preprocessor.get_out_label_specification(mode))
    return specs_lib.replace_dtype(out, np.float32, torch.bfloat16)

  def _preprocess_fn(self, features, labels, mode):
    features, labels = self._preprocessor._preprocess_fn(
        features, labels, mode)
    return (specs_lib.cast_float32_to_bfloat16(_keep_required(
                features, self.get_out_feature_specification(mode))),
            specs_lib.cast_float32_to_bfloat16(_keep_required(
                labels, self.get_out_label_specification(mode))))

  def preprocess(self, features, labels, mode):
    # Validation against the inner preprocessor's in-specs, then the
    # dtype policy on the way out.
    modes_lib.validate(mode)
    out_features, out_labels = self._preprocessor.preprocess(
        features, labels, mode)
    out_features = specs_lib.cast_float32_to_bfloat16(
        _keep_required(out_features,
                       self.get_out_feature_specification(mode)))
    if out_labels is not None and len(out_labels):
      out_labels = specs_lib.cast_float32_to_bfloat16(
          _keep_required(out_labels, self.get_out_label_specification(mode)))
    return out_features, out_labels


def _keep_required(values: specs_lib.SpecStruct,
                   spec: specs_lib.SpecStruct) -> specs_lib.SpecStruct:
  """Drops value leaves not present in (required) spec, keeping _length
  side outputs for sequence specs."""
  out = specs_lib.SpecStruct()
  spec = specs_lib.add_sequence_length_specs(spec)
  for key, value in specs_lib.flatten_spec_structure(values).items():
    if key in spec:
      out[key] = value
  return out
