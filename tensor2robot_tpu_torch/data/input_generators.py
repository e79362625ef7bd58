"""Input generators: spec-filled batch sources for the train loop.

Counterpart of `tensor2robot_tpu.data.input_generators` (the abstract
generator and the random one). A generator holds feature/label specs and a
preprocess function, both injected from the model by
`set_specification_from_model`, and yields `{features, labels}` batches
for a mode. Batches are drawn with numpy from the same seeds as the JAX
package (features from `seed + step`, labels from `seed + step +
10_000_019`), so one seed gives the same bytes in both; they are then
made CPU tensors and preprocessed. The trainer moves them to the device.

Record-backed generators (TFRecord files, weighted mixtures) are not
ported yet (ROADMAP.md, Queue A).
"""

from __future__ import annotations

import abc
from typing import Iterator, Optional

import numpy as np
import torch

from tensor2robot_tpu_torch import modes as modes_lib
from tensor2robot_tpu_torch import specs as specs_lib
from tensor2robot_tpu_torch.utils import config

__all__ = ["AbstractInputGenerator", "DefaultRandomInputGenerator",
           "LABEL_SEED_OFFSET"]

# The random generator draws labels from seed + step + this offset, as the
# JAX package does.
LABEL_SEED_OFFSET = 10_000_019


def _to_tensors(values: specs_lib.SpecStruct) -> specs_lib.SpecStruct:
  return specs_lib.SpecStruct({k: torch.from_numpy(np.asarray(v))
                               for k, v in values.items()})


class AbstractInputGenerator(abc.ABC):
  """Holds specs + preprocess_fn; produces batch iterators per mode. Specs
  are not constructor inputs: they come from the model's preprocessor,
  so the input pipeline always matches what the model consumes."""

  def __init__(self, batch_size: int = 32):
    self._batch_size = batch_size
    self._feature_spec: Optional[specs_lib.SpecStruct] = None
    self._label_spec: Optional[specs_lib.SpecStruct] = None
    self._preprocess_fn = None

  @property
  def batch_size(self) -> int:
    return self._batch_size

  @property
  def feature_spec(self) -> Optional[specs_lib.SpecStruct]:
    return self._feature_spec

  @property
  def label_spec(self) -> Optional[specs_lib.SpecStruct]:
    return self._label_spec

  def set_specification(self, feature_spec, label_spec=None) -> None:
    self._feature_spec = specs_lib.flatten_spec_structure(feature_spec)
    self._label_spec = (specs_lib.flatten_spec_structure(label_spec)
                        if label_spec is not None else None)

  def set_specification_from_model(self, model, mode: str) -> None:
    """Pulls the preprocessor's in-specs and preprocess fn from a model."""
    preprocessor = model.preprocessor
    self.set_specification(
        preprocessor.get_in_feature_specification(mode),
        preprocessor.get_in_label_specification(mode))
    self._preprocess_fn = preprocessor.preprocess

  def _assert_specs_initialized(self) -> None:
    if self._feature_spec is None:
      raise ValueError(
          "Input generator specs not set. Call set_specification_from_model "
          "or set_specification first.")

  @abc.abstractmethod
  def create_dataset(self, mode: str) -> Iterator[specs_lib.SpecStruct]:
    """Returns an iterator over `{features: ..., labels: ...}` batches."""

  def __call__(self, mode: str) -> Iterator[specs_lib.SpecStruct]:
    return self.create_dataset(modes_lib.validate(mode))


@config.configurable
class DefaultRandomInputGenerator(AbstractInputGenerator):
  """Random data matching the specs, for smoke runs and benchmarks."""

  def __init__(self, batch_size: int = 32, sequence_length: int = 3,
               seed: int = 0):
    super().__init__(batch_size=batch_size)
    self._sequence_length = sequence_length
    self._seed = seed

  def create_dataset(self, mode: str) -> Iterator[specs_lib.SpecStruct]:
    self._assert_specs_initialized()

    def _iterate():
      step = 0
      while True:
        features = _to_tensors(specs_lib.make_random_numpy(
            self._feature_spec, batch_size=self._batch_size,
            sequence_length=self._sequence_length, seed=self._seed + step))
        labels = specs_lib.SpecStruct()
        if self._label_spec is not None and len(self._label_spec):
          labels = _to_tensors(specs_lib.make_random_numpy(
              self._label_spec, batch_size=self._batch_size,
              sequence_length=self._sequence_length,
              seed=self._seed + step + LABEL_SEED_OFFSET))
        step += 1
        if self._preprocess_fn is not None:
          features, labels = self._preprocess_fn(features, labels, mode)
        out = specs_lib.SpecStruct()
        out["features"] = features
        if labels is not None and len(labels):
          out["labels"] = labels
        yield out

    return _iterate()
