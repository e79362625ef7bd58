"""Input generators: spec-filled batch sources for the train loop.

Counterpart of `tensor2robot_tpu.data.input_generators`. A generator
holds feature/label specs and a preprocess function, both injected from
the model by `set_specification_from_model`, and yields `{features,
labels}` batches for a mode: CPU tensors, made from numpy with
`torch.from_numpy` (no copy) before the preprocess function, which works
on tensors. The trainer moves them to the device.

* `DefaultRecordInputGenerator` reads TFRecord files of Example records
  through `pipeline.RecordBatchPipeline` (native stager, columnar parser
  and JPEG decoder where the native library is built, overlapped parse
  and preprocess threads); `FractionalRecordInputGenerator` reads a
  fraction of the files, `MultiEvalRecordInputGenerator` picks its files
  by the eval job's name (`multi_eval_name`), and
  `WeightedRecordInputGenerator` samples records from several groups of
  files by weight.
* `DefaultRandomInputGenerator` draws with numpy from the same seeds as
  the JAX package (features from `seed + step`, labels from `seed + step
  + 10_000_019`), so one seed gives the same bytes in both;
  `DefaultConstantInputGenerator` fills every leaf with one value and
  `GeneratorInputGenerator` batches a Python generator's examples.
"""

from __future__ import annotations

import abc
import json
import os
from typing import Any, Callable, Iterator, Mapping, Optional, Sequence, Union

import numpy as np

from tensor2robot_tpu_torch import modes as modes_lib
from tensor2robot_tpu_torch import specs as specs_lib
from tensor2robot_tpu_torch.data import parsing, pipeline
from tensor2robot_tpu_torch.utils import config

__all__ = [
    "AbstractInputGenerator",
    "DefaultRecordInputGenerator",
    "FractionalRecordInputGenerator",
    "MultiEvalRecordInputGenerator",
    "GeneratorInputGenerator",
    "DefaultRandomInputGenerator",
    "DefaultConstantInputGenerator",
    "WeightedRecordInputGenerator",
    "multi_eval_name",
    "LABEL_SEED_OFFSET",
]

# The random generator draws labels from seed + step + this offset, as the
# JAX package does.
LABEL_SEED_OFFSET = 10_000_019


class AbstractInputGenerator(abc.ABC):
  """Holds specs + preprocess_fn; produces batch iterators per mode. Specs
  are not constructor inputs: they come from the model's preprocessor,
  so the input pipeline always matches what the model consumes."""

  def __init__(self, batch_size: int = 32):
    self._batch_size = batch_size
    self._feature_spec: Optional[specs_lib.SpecStruct] = None
    self._label_spec: Optional[specs_lib.SpecStruct] = None
    self._preprocess_fn = None
    # Host-overlap tuning injected by the trainer (`train_eval_model`'s
    # `host_overlap_workers` / `host_overlap_queue_mb`) through
    # `set_overlap_options`; only record-backed generators use it.
    self._overlap_options: dict = {}

  @property
  def batch_size(self) -> int:
    return self._batch_size

  @batch_size.setter
  def batch_size(self, value: int) -> None:
    self._batch_size = value

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

  def set_preprocess_fn(self, preprocess_fn) -> None:
    self._preprocess_fn = preprocess_fn

  def set_overlap_options(self,
                          num_parallel_parses: Optional[int] = None,
                          prefetch_size: Optional[int] = None,
                          overlap: Optional[bool] = None,
                          overlap_queue_mb: Optional[float] = None,
                          fused_preprocess: Optional[bool] = None) -> None:
    """Host-overlap tuning of the record pipeline (`data/overlap.py`):
    parse worker count, hand-off depth, the output queue's byte cap,
    preprocess fused into the parse pool. None keeps the generator's own
    value; generators without a record pipeline ignore the call."""
    for key, value in (("num_parallel_parses", num_parallel_parses),
                       ("prefetch_size", prefetch_size),
                       ("overlap", overlap),
                       ("overlap_queue_mb", overlap_queue_mb),
                       ("fused_preprocess", fused_preprocess)):
      if value is not None:
        self._overlap_options[key] = value

  def _assert_specs_initialized(self) -> None:
    if self._feature_spec is None:
      raise ValueError(
          "Input generator specs not set. Call set_specification_from_model "
          "or set_specification first.")

  def _preprocessed(self, features, labels, mode: str) -> specs_lib.SpecStruct:
    """`{features, labels}` of one batch of tensors after the preprocess
    function; labels left out when there are none."""
    if self._preprocess_fn is not None:
      features, labels = self._preprocess_fn(features, labels, mode)
    out = specs_lib.SpecStruct()
    out["features"] = specs_lib.flatten_spec_structure(features)
    if labels is not None and len(labels):
      out["labels"] = specs_lib.flatten_spec_structure(labels)
    return out

  @abc.abstractmethod
  def create_dataset(self, mode: str) -> Iterator[specs_lib.SpecStruct]:
    """Returns an iterator over `{features: ..., labels: ...}` batches."""

  def __call__(self, mode: str) -> Iterator[specs_lib.SpecStruct]:
    return self.create_dataset(modes_lib.validate(mode))


@config.configurable
class DefaultRecordInputGenerator(AbstractInputGenerator):
  """Reads TFRecord files of Example records. `file_patterns` is a
  comma-separated glob string, a list of them, or a mapping of
  dataset_key -> patterns for multi-dataset specs."""

  def __init__(self,
               file_patterns: Union[str, Sequence[str], Mapping[str, Any],
                                    None] = None,
               batch_size: int = 32,
               shuffle_buffer_size: int = 512,
               prefetch_size: int = 2,
               num_parallel_parses: int = 2,
               overlap: Optional[bool] = None,
               overlap_queue_mb: Optional[float] = None,
               seed: Optional[int] = None,
               process_index: Optional[int] = None,
               process_count: Optional[int] = None):
    super().__init__(batch_size=batch_size)
    if not file_patterns:
      raise ValueError("file_patterns must be provided.")
    self._file_patterns = file_patterns
    self._shuffle_buffer_size = shuffle_buffer_size
    self.set_overlap_options(num_parallel_parses=num_parallel_parses,
                             prefetch_size=prefetch_size,
                             overlap=overlap,
                             overlap_queue_mb=overlap_queue_mb)
    self._seed = seed
    # Host sharding for multi-process training; single-host by default.
    self._process_index = process_index
    self._process_count = process_count

  def set_process_info(self, process_index: int, process_count: int) -> None:
    self._process_index = process_index
    self._process_count = process_count

  def create_dataset(self, mode: str) -> Iterator[specs_lib.SpecStruct]:
    self._assert_specs_initialized()
    parse_fn = parsing.create_parse_fn(self._feature_spec, self._label_spec)
    opts = self._overlap_options
    return iter(pipeline.RecordBatchPipeline(
        self._file_patterns,
        parse_fn,
        batch_size=self._batch_size,
        mode=mode,
        shuffle_buffer_size=self._shuffle_buffer_size,
        prefetch_size=opts.get("prefetch_size", 2),
        num_parallel_parses=opts.get("num_parallel_parses", 2),
        overlap=opts.get("overlap"),
        overlap_queue_mb=opts.get("overlap_queue_mb"),
        fused_preprocess=opts.get("fused_preprocess"),
        seed=self._seed,
        preprocess_fn=self._preprocess_fn,
        process_index=self._process_index or 0,
        process_count=self._process_count or 1))


@config.configurable
class FractionalRecordInputGenerator(DefaultRecordInputGenerator):
  """Uses only the first `file_fraction` of the matched files, for data
  ablations."""

  def __init__(self, file_fraction: float = 1.0, **kwargs):
    super().__init__(**kwargs)
    if not 0.0 < file_fraction <= 1.0:
      raise ValueError(f"file_fraction must be in (0, 1], got {file_fraction}")
    self._file_fraction = file_fraction

  def create_dataset(self, mode: str) -> Iterator[specs_lib.SpecStruct]:
    if self._file_fraction < 1.0:
      files = pipeline.resolve_file_patterns(self._file_patterns)
      n = max(1, int(self._file_fraction * len(files)))
      self._file_patterns = files[:n]
    return super().create_dataset(mode)


@config.configurable
class MultiEvalRecordInputGenerator(DefaultRecordInputGenerator):
  """Picks its files by the eval job's name (`multi_eval_name`)."""

  def __init__(self,
               eval_dataset_map: Optional[Mapping[str, Any]] = None,
               **kwargs):
    if not eval_dataset_map:
      raise ValueError("eval_dataset_map must be provided.")
    eval_name = multi_eval_name()
    if eval_name not in eval_dataset_map:
      raise ValueError(
          f"Eval job {eval_name!r} not in eval_dataset_map "
          f"{sorted(eval_dataset_map)}.")
    super().__init__(file_patterns=eval_dataset_map[eval_name], **kwargs)


def multi_eval_name(default: str = "eval") -> str:
  """The eval job's name: `multi_eval_name` of the JSON in T2R_CLUSTER or
  TF_CONFIG, else `default`."""
  for var in ("T2R_CLUSTER", "TF_CONFIG"):
    raw = os.environ.get(var)
    if raw:
      try:
        return json.loads(raw).get("multi_eval_name", default)
      except (ValueError, AttributeError):
        continue
  return default


@config.configurable
class GeneratorInputGenerator(AbstractInputGenerator):
  """Batches the (features, labels) numpy dicts of a Python generator,
  `generator_fn(mode)`."""

  def __init__(self, generator_fn: Optional[Callable] = None,
               batch_size: int = 32):
    super().__init__(batch_size=batch_size)
    if generator_fn is None:
      raise ValueError("generator_fn must be provided.")
    self._generator_fn = generator_fn

  def create_dataset(self, mode: str) -> Iterator[specs_lib.SpecStruct]:
    self._assert_specs_initialized()

    def _iterate():
      gen = self._generator_fn(mode)
      while True:
        columns_f, columns_l = [], []
        for _ in range(self._batch_size):
          try:
            features, labels = next(gen)
          except StopIteration:
            return
          columns_f.append(specs_lib.flatten_spec_structure(features))
          columns_l.append(specs_lib.flatten_spec_structure(labels))
        features = pipeline.as_tensors(specs_lib.SpecStruct(
            {k: np.stack([c[k] for c in columns_f]) for k in columns_f[0]}))
        labels = pipeline.as_tensors(specs_lib.SpecStruct(
            {k: np.stack([c[k] for c in columns_l]) for k in columns_l[0]}))
        yield self._preprocessed(features, labels, mode)

    return _iterate()


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
        features = pipeline.as_tensors(specs_lib.make_random_numpy(
            self._feature_spec, batch_size=self._batch_size,
            sequence_length=self._sequence_length, seed=self._seed + step))
        labels = specs_lib.SpecStruct()
        if self._label_spec is not None and len(self._label_spec):
          labels = pipeline.as_tensors(specs_lib.make_random_numpy(
              self._label_spec, batch_size=self._batch_size,
              sequence_length=self._sequence_length,
              seed=self._seed + step + LABEL_SEED_OFFSET))
        step += 1
        yield self._preprocessed(features, labels, mode)

    return _iterate()


@config.configurable
class DefaultConstantInputGenerator(AbstractInputGenerator):
  """Constant data matching the specs. As in the JAX package, the
  preprocess function is not applied."""

  def __init__(self, constant_value: float = 1.0, batch_size: int = 32,
               sequence_length: int = 3):
    super().__init__(batch_size=batch_size)
    self._constant_value = constant_value
    self._sequence_length = sequence_length

  def create_dataset(self, mode: str) -> Iterator[specs_lib.SpecStruct]:
    self._assert_specs_initialized()

    def _iterate():
      while True:
        out = specs_lib.SpecStruct()
        out["features"] = pipeline.as_tensors(specs_lib.make_constant_numpy(
            self._feature_spec, self._constant_value, self._batch_size,
            self._sequence_length))
        if self._label_spec is not None and len(self._label_spec):
          out["labels"] = pipeline.as_tensors(specs_lib.make_constant_numpy(
              self._label_spec, self._constant_value, self._batch_size,
              self._sequence_length))
        yield out

    return _iterate()


@config.configurable
class WeightedRecordInputGenerator(AbstractInputGenerator):
  """Samples records from several groups of files by weight."""

  def __init__(self,
               file_pattern_groups: Optional[Sequence[Any]] = None,
               weights: Optional[Sequence[float]] = None,
               batch_size: int = 32,
               seed: Optional[int] = None,
               shuffle_buffer_size: int = 512):
    super().__init__(batch_size=batch_size)
    if not file_pattern_groups:
      raise ValueError("file_pattern_groups must be provided.")
    self._groups = file_pattern_groups
    self._weights = weights or [1.0 / len(file_pattern_groups)] * len(
        file_pattern_groups)
    self._seed = seed
    self._shuffle_buffer_size = shuffle_buffer_size

  def create_dataset(self, mode: str) -> Iterator[specs_lib.SpecStruct]:
    self._assert_specs_initialized()
    parse_fn = parsing.create_parse_fn(self._feature_spec, self._label_spec)
    opts = self._overlap_options
    kwargs = {k: opts[k] for k in ("prefetch_size", "num_parallel_parses",
                                   "overlap", "overlap_queue_mb")
              if k in opts}
    return iter(pipeline.WeightedRecordPipeline(
        self._groups, self._weights, parse_fn,
        batch_size=self._batch_size, mode=mode, seed=self._seed,
        shuffle_buffer_size=self._shuffle_buffer_size,
        preprocess_fn=self._preprocess_fn, **kwargs))
