"""Meta-learning preprocessors: task-structured spec/batch transforms.

Counterpart of `tensor2robot_tpu.meta_learning.preprocessors`:

* `MAMLPreprocessor` runs a base preprocessor inside the meta structure:
  its in/out specs are the meta versions of the base's, and the
  transform flattens the [task, samples] leading dims of each split,
  applies the base `_preprocess_fn`, and restores the dims (one joint
  base call for the inference split's features and labels, so a random
  base transform keeps them in step);
* `create_metaexample_spec` names the columns of fixed-length
  meta-episodes `<prefix>_ep<i>/<key>`;
* `FixedLenMetaExamplePreprocessor` parses those columns and stacks them
  into the condition/inference meta layout.

Values are torch tensors (numpy arrays from a parser are taken as
tensors).
"""

from __future__ import annotations

import torch

from tensor2robot_tpu_torch import specs as specs_lib
from tensor2robot_tpu_torch.meta_learning import batch_utils, maml
from tensor2robot_tpu_torch.preprocessors import base as preprocessors_lib
from tensor2robot_tpu_torch.utils import config

__all__ = ["MAMLPreprocessor", "create_metaexample_spec",
           "FixedLenMetaExamplePreprocessor"]


@config.configurable
class MAMLPreprocessor(preprocessors_lib.AbstractPreprocessor):
  """Applies a base preprocessor inside the meta structure."""

  def __init__(self, base_preprocessor=None,
               num_condition_samples_per_task: int = 1,
               num_inference_samples_per_task: int = 1, **kwargs):
    super().__init__(**kwargs)
    if base_preprocessor is None:
      raise ValueError("base_preprocessor is required.")
    self._base = base_preprocessor
    self._num_condition = num_condition_samples_per_task
    self._num_inference = num_inference_samples_per_task

  def _meta_spec(self, feature_spec, label_spec):
    return maml.create_maml_feature_spec(
        feature_spec, label_spec, self._num_condition, self._num_inference)

  def get_in_feature_specification(self, mode):
    return self._meta_spec(self._base.get_in_feature_specification(mode),
                           self._base.get_in_label_specification(mode))

  def get_in_label_specification(self, mode):
    return maml.create_maml_label_spec(
        self._base.get_in_label_specification(mode), self._num_inference)

  def get_out_feature_specification(self, mode):
    return self._meta_spec(self._base.get_out_feature_specification(mode),
                           self._base.get_out_label_specification(mode))

  def get_out_label_specification(self, mode):
    return maml.create_maml_label_spec(
        self._base.get_out_label_specification(mode), self._num_inference)

  def _preprocess_fn(self, features, labels, mode):
    features = specs_lib.flatten_spec_structure(features)
    out = specs_lib.SpecStruct()

    def _one_split(split_features, split_labels):
      split_features = specs_lib.flatten_spec_structure(split_features)
      leading = tuple(next(iter(split_features.values())).shape[:2])
      flat_f = batch_utils.flatten_batch_examples(split_features)
      flat_l = (batch_utils.flatten_batch_examples(
          specs_lib.flatten_spec_structure(split_labels))
                if split_labels is not None else specs_lib.SpecStruct())
      out_f, out_l = self._base._preprocess_fn(flat_f, flat_l, mode)
      out_f = batch_utils.unflatten_batch_examples(out_f, leading)
      if out_l is not None and len(out_l):
        out_l = batch_utils.unflatten_batch_examples(out_l, leading)
      return out_f, out_l

    cond_f, cond_l = _one_split(features["condition/features"],
                                features["condition/labels"])
    out["condition/features"] = cond_f
    out["condition/labels"] = cond_l
    inf_f, out_labels = _one_split(
        features["inference/features"],
        labels if labels is not None and len(labels) else None)
    out["inference/features"] = inf_f
    if out_labels is None or not len(out_labels):
      out_labels = labels
    return out, out_labels


def create_metaexample_spec(spec_structure,
                            num_episodes: int,
                            prefix: str) -> specs_lib.SpecStruct:
  """`<prefix>_ep<i>/<key>` columns for fixed-length meta-episodes, each
  named `<prefix>_ep<i>/<spec name or key>`."""
  out = specs_lib.SpecStruct()
  flat = specs_lib.flatten_spec_structure(spec_structure)
  for i in range(num_episodes):
    for key, spec in flat.items():
      name = spec.name or key
      out[f"{prefix}_ep{i}/{key}"] = spec.replace(
          name=f"{prefix}_ep{i}/{name}")
  return out


def _stack(columns) -> torch.Tensor:
  """[batch, ...] columns -> [batch, episodes, ...]."""
  return torch.stack([torch.as_tensor(v) for v in columns], dim=1)


@config.configurable
class FixedLenMetaExamplePreprocessor(preprocessors_lib.AbstractPreprocessor):
  """Parses `<prefix>_ep<i>/` columns and stacks them into the
  condition/inference meta layout."""

  def __init__(self, base_preprocessor=None,
               num_condition_episodes: int = 1,
               num_inference_episodes: int = 1, **kwargs):
    super().__init__(**kwargs)
    if base_preprocessor is None:
      raise ValueError("base_preprocessor is required.")
    self._base = base_preprocessor
    self._num_condition = num_condition_episodes
    self._num_inference = num_inference_episodes

  def get_in_feature_specification(self, mode):
    out = specs_lib.SpecStruct()
    features = self._base.get_in_feature_specification(mode)
    labels = self._base.get_in_label_specification(mode)
    merged = specs_lib.SpecStruct()
    merged["features"] = features
    merged["labels"] = labels
    for key, spec in create_metaexample_spec(
        merged, self._num_condition, "condition").items():
      out[key] = spec
    for key, spec in create_metaexample_spec(
        specs_lib.SpecStruct({"features": features}),
        self._num_inference, "inference").items():
      out[key] = spec
    return out

  def get_in_label_specification(self, mode):
    return create_metaexample_spec(
        self._base.get_in_label_specification(mode),
        self._num_inference, "inference")

  def get_out_feature_specification(self, mode):
    return maml.create_maml_feature_spec(
        self._base.get_out_feature_specification(mode),
        self._base.get_out_label_specification(mode),
        self._num_condition, self._num_inference)

  def get_out_label_specification(self, mode):
    return maml.create_maml_label_spec(
        self._base.get_out_label_specification(mode), self._num_inference)

  def _preprocess_fn(self, features, labels, mode):
    features = specs_lib.flatten_spec_structure(features)
    out = specs_lib.SpecStruct()

    def _episodes(tree, prefix, count):
      collected = {}
      for i in range(count):
        episode = specs_lib.flatten_spec_structure(tree[f"{prefix}_ep{i}"])
        for key, value in episode.items():
          collected.setdefault(key, []).append(value)
      return specs_lib.SpecStruct({k: _stack(v)
                                   for k, v in collected.items()})

    cond = _episodes(features, "condition", self._num_condition)
    out["condition/features"] = cond["features"]
    out["condition/labels"] = cond["labels"]
    out["inference/features"] = _episodes(features, "inference",
                                          self._num_inference)["features"]
    out_labels = labels
    if labels is not None and len(labels):
      out_labels = _episodes(specs_lib.flatten_spec_structure(labels),
                             "inference", self._num_inference)
    return out, out_labels
