"""Per-task-file meta-learning data: the `parallel_read` path.

Counterpart of `tensor2robot_tpu.meta_learning.task_data`, over the
port's `data/tfrecord.py`, `data/parsing.py` and `data/pipeline.py`:
each file holds ONE task's examples; `parallel_read` visits the task
files round-robin (shuffled, with each file's records shuffled and
repeated, in train mode; one deterministic pass each otherwise) and
yields one task's parsed `num_train + num_val` sample group per visit;
`MetaTaskRecordInputGenerator` stacks `batch_size` groups into the
condition/inference meta layout `MAMLModel` consumes. The same files and
seed give the JAX package's batches.
"""

from __future__ import annotations

import itertools
import random
from typing import Callable, Iterator, Optional, Sequence, Union

import numpy as np

from tensor2robot_tpu_torch import specs as specs_lib
from tensor2robot_tpu_torch.data import (input_generators, parsing, pipeline,
                                         tfrecord)
from tensor2robot_tpu_torch.utils import config

__all__ = ["parallel_read", "MetaTaskRecordInputGenerator"]


def _task_stream(path: str, samples_per_visit: int, train: bool,
                 shuffle_buffer_size: int,
                 seed: Optional[int]) -> Iterator[list]:
  """Yields lists of `samples_per_visit` serialized records from one
  task file (shuffle+repeat in train mode; single pass otherwise)."""
  effective_buffer = max(shuffle_buffer_size, samples_per_visit)
  epoch = 0
  # In train mode partial groups carry across epochs (tf.data's shuffle
  # -> repeat -> batch order), so a task file smaller than
  # samples_per_visit still yields groups.
  group: list = []
  while True:
    epoch_records = 0
    records: Iterator[bytes] = tfrecord.iter_records(path)
    if train:
      epoch_seed = None if seed is None else seed + epoch
      records = pipeline.shuffled(records, effective_buffer, epoch_seed)
    for record in records:
      epoch_records += 1
      group.append(record)
      if len(group) == samples_per_visit:
        yield group
        group = []
    if epoch_records == 0:
      if train:
        raise ValueError(f"Task file {path!r} contains no records.")
      return
    # Eval: one pass; a trailing partial group is dropped.
    if not train:
      return
    epoch += 1


@config.configurable
def parallel_read(file_patterns: Union[str, Sequence[str]],
                  parse_fn: Optional[Callable] = None,
                  shuffle_filenames: bool = True,
                  num_train_samples_per_task: int = 4,
                  num_val_samples_per_task: int = 4,
                  shuffle_buffer_size: int = 50,
                  filter_fn: Optional[Callable] = None,
                  interleave_cycle_length: Optional[int] = None,
                  mode: str = "train",
                  seed: Optional[int] = None
                  ) -> Iterator[specs_lib.SpecStruct]:
  """Yields one task's parsed (num_train + num_val) sample group per step:
  `parse_fn`'s output over a group of records from a single task file.
  `filter_fn(parsed_group) -> bool` drops whole groups. Every active task
  stream is visited in turn (a pull-based interleave: the cycle length is
  the number of tasks, so `interleave_cycle_length` is not used)."""
  files = pipeline.resolve_file_patterns(file_patterns)
  if parse_fn is None:
    raise ValueError("parse_fn is required.")
  train = mode == "train"
  samples = num_train_samples_per_task + num_val_samples_per_task
  if shuffle_filenames and train:
    files = list(files)
    random.Random(seed).shuffle(files)
  del interleave_cycle_length
  streams = [
      _task_stream(path, samples, train, shuffle_buffer_size,
                   None if seed is None else seed + i)
      for i, path in enumerate(files)]

  active = list(range(len(streams)))
  while active:
    next_active = []
    for i in active:
      try:
        group = next(streams[i])
      except StopIteration:
        continue
      parsed = parse_fn(group)
      if filter_fn is not None and not filter_fn(parsed):
        next_active.append(i)
        continue
      yield parsed
      next_active.append(i)
    active = next_active


@config.configurable
class MetaTaskRecordInputGenerator(input_generators.AbstractInputGenerator):
  """Batches per-task sample groups into the MAML meta layout.

  Each batch has `batch_size` TASKS: `condition/{features,labels}` carry
  the first `num_train_samples_per_task` samples of each task's group,
  `inference/features` and the labels the remaining
  `num_val_samples_per_task`.
  """

  def __init__(self,
               file_patterns: Union[str, Sequence[str], None] = None,
               batch_size: int = 4,
               num_train_samples_per_task: int = 4,
               num_val_samples_per_task: int = 4,
               shuffle_buffer_size: int = 50,
               interleave_cycle_length: Optional[int] = None,
               seed: Optional[int] = None):
    super().__init__(batch_size=batch_size)
    if not file_patterns:
      raise ValueError("file_patterns must be provided.")
    self._file_patterns = file_patterns
    self._num_train = num_train_samples_per_task
    self._num_val = num_val_samples_per_task
    self._shuffle_buffer_size = shuffle_buffer_size
    self._cycle = interleave_cycle_length
    self._seed = seed

  def _base_specs(self):
    """Per-sample specs from the model's meta specs: the condition
    framing and the per-task samples dim stripped."""
    feature_spec = specs_lib.flatten_spec_structure(self._feature_spec)
    base_features = specs_lib.SpecStruct()
    base_labels = specs_lib.SpecStruct()
    for key, spec in feature_spec.items():
      if key.startswith("condition/features/"):
        base_features[key[len("condition/features/"):]] = \
            spec.without_batch()
      elif key.startswith("condition/labels/"):
        base_labels[key[len("condition/labels/"):]] = spec.without_batch()
    return base_features, base_labels

  def create_dataset(self, mode: str) -> Iterator[specs_lib.SpecStruct]:
    self._assert_specs_initialized()
    base_features, base_labels = self._base_specs()
    record_parse = parsing.create_parse_fn(base_features, base_labels)
    groups = parallel_read(
        self._file_patterns, parse_fn=record_parse.parse_batch,
        num_train_samples_per_task=self._num_train,
        num_val_samples_per_task=self._num_val,
        shuffle_buffer_size=self._shuffle_buffer_size,
        interleave_cycle_length=self._cycle, mode=mode, seed=self._seed)

    def _batches():
      while True:
        tasks = list(itertools.islice(groups, self._batch_size))
        if len(tasks) < self._batch_size:
          return
        features = specs_lib.SpecStruct()
        labels = specs_lib.SpecStruct()
        flat_tasks = [specs_lib.flatten_spec_structure(t) for t in tasks]
        for key in flat_tasks[0].keys():
          stacked = np.stack([np.asarray(t[key]) for t in flat_tasks])
          if key.startswith("features/"):
            name = key[len("features/"):]
            features["condition/features/" + name] = \
                stacked[:, :self._num_train]
            features["inference/features/" + name] = \
                stacked[:, self._num_train:]
          elif key.startswith("labels/"):
            name = key[len("labels/"):]
            features["condition/labels/" + name] = \
                stacked[:, :self._num_train]
            labels[name] = stacked[:, self._num_train:]
        yield self._preprocessed(pipeline.as_tensors(features),
                                 pipeline.as_tensors(labels), mode)

    return _batches()
