"""Task-head model bases: classification, regression, critic.

Counterpart of `tensor2robot_tpu.models.heads`:

* `ClassificationModel` — network -> logits, sigmoid or softmax
  cross-entropy, accuracy / precision / recall / mse eval metrics;
* `RegressionModel` — network -> continuous outputs, MSE loss;
* `CriticModel` — state / action spec split, q_predicted regressed onto
  Monte-Carlo returns, and state tiling for CEM action batches.

Concrete models subclass one of these and provide specs and a module.
"""

from __future__ import annotations

import abc
from typing import Mapping

import numpy as np
import torch
import torch.nn.functional as F

from tensor2robot_tpu_torch import modes as modes_lib
from tensor2robot_tpu_torch import specs as specs_lib
from tensor2robot_tpu_torch.models import abstract as abstract_model
from tensor2robot_tpu_torch.parallel import collectives

__all__ = ["ClassificationModel", "RegressionModel", "CriticModel",
           "sigmoid_cross_entropy", "softmax_cross_entropy"]


def sigmoid_cross_entropy(logits: torch.Tensor,
                          labels: torch.Tensor) -> torch.Tensor:
  """Numerically stable elementwise sigmoid cross-entropy."""
  return (torch.clamp(logits, min=0) - logits * labels
          + torch.log1p(torch.exp(-torch.abs(logits))))


def softmax_cross_entropy(logits: torch.Tensor,
                          labels_onehot: torch.Tensor) -> torch.Tensor:
  return -(labels_onehot * F.log_softmax(logits, dim=-1)).sum(-1)


class ClassificationModel(abstract_model.T2RModel):
  """Logit head + cross-entropy; binary (num_classes=1, sigmoid) or
  multiclass (softmax over one-hot labels; sparse labels are one-hot
  encoded)."""

  def __init__(self, num_classes: int = 1, logits_key: str = "logits",
               class_label_key: str = "class", **kwargs):
    super().__init__(**kwargs)
    self._num_classes = num_classes
    self._logits_key = logits_key
    self._class_label_key = class_label_key

  @property
  def num_classes(self) -> int:
    return self._num_classes

  def _onehot(self, y: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    if y.ndim == logits.ndim - 1:
      return F.one_hot(y.long(), self._num_classes).to(logits.dtype)
    return y

  def model_train_fn(self, features, labels, inference_outputs, mode):
    logits = inference_outputs[self._logits_key]
    y = labels[self._class_label_key]
    if self._num_classes == 1:
      loss = torch.mean(sigmoid_cross_entropy(logits, y))
    else:
      loss = torch.mean(softmax_cross_entropy(logits,
                                              self._onehot(y, logits)))
    return loss, {"cross_entropy": loss}

  def model_eval_fn(self, features, labels, inference_outputs):
    logits = inference_outputs[self._logits_key]
    y = labels[self._class_label_key]
    loss, _ = self.model_train_fn(features, labels, inference_outputs,
                                  modes_lib.EVAL)
    if self._num_classes == 1:
      probs = torch.sigmoid(logits)
      predicted = (probs > 0.5).float()
      # Precision and recall are ratios of sums over the batch: on a data
      # split every rank's rows are gathered first, so they are the
      # global batch's (the means below are the same either way).
      group = collectives.current_batch_group()
      probs = collectives.all_gather_batch(probs, group)
      predicted = collectives.all_gather_batch(predicted, group)
      y = collectives.all_gather_batch(y, group)
      true_pos = torch.sum(predicted * y)
      return {"loss": loss,
              "accuracy": torch.mean((predicted == y).float()),
              "precision": true_pos / torch.clamp(torch.sum(predicted),
                                                  min=1.0),
              "recall": true_pos / torch.clamp(torch.sum(y), min=1.0),
              "mse": torch.mean((probs - y) ** 2)}
    predicted = torch.argmax(logits, -1)
    sparse = y if y.ndim == logits.ndim - 1 else torch.argmax(y, -1)
    return {"loss": loss,
            "accuracy": torch.mean((predicted == sparse).float())}

  def create_export_outputs_fn(self, features, inference_outputs):
    logits = inference_outputs[self._logits_key]
    scores = (torch.sigmoid(logits) if self._num_classes == 1
              else torch.softmax(logits, -1))
    return {self._logits_key: logits, "scores": scores}


class RegressionModel(abstract_model.T2RModel):
  """Continuous output head + MSE."""

  def __init__(self, output_key: str = "inference_output",
               target_label_key: str = "target", **kwargs):
    super().__init__(**kwargs)
    self._output_key = output_key
    self._target_label_key = target_label_key

  def model_train_fn(self, features, labels, inference_outputs, mode):
    predicted = inference_outputs[self._output_key]
    loss = torch.mean((predicted - labels[self._target_label_key]) ** 2)
    return loss, {"mse": loss}

  def model_eval_fn(self, features, labels, inference_outputs):
    loss, scalars = self.model_train_fn(features, labels, inference_outputs,
                                        modes_lib.EVAL)
    predicted = inference_outputs[self._output_key]
    mae = torch.mean(torch.abs(predicted - labels[self._target_label_key]))
    return {"loss": loss, "mean_absolute_error": mae, **scalars}


class CriticModel(abstract_model.T2RModel):
  """Q(state, action) regression onto Monte-Carlo returns.

  Feature specs split into state and action halves (`state/...`,
  `action/...`); serving tiles the state over an action batch so CEM can
  score many candidate actions per observation in one forward pass."""

  q_output_key = "q_predicted"
  reward_label_key = "reward"

  @abc.abstractmethod
  def get_state_specification(self, mode) -> specs_lib.SpecStruct:
    ...

  @abc.abstractmethod
  def get_action_specification(self, mode) -> specs_lib.SpecStruct:
    ...

  def get_feature_specification(self, mode) -> specs_lib.SpecStruct:
    out = specs_lib.SpecStruct()
    for prefix, spec in (("state/", self.get_state_specification(mode)),
                         ("action/", self.get_action_specification(mode))):
      for key, value in specs_lib.flatten_spec_structure(spec).items():
        out[prefix + key] = value
    return out

  def get_label_specification(self, mode) -> specs_lib.SpecStruct:
    return specs_lib.SpecStruct({
        self.reward_label_key: specs_lib.TensorSpec(
            shape=(1,), dtype=np.float32, name="reward")})

  def model_train_fn(self, features, labels, inference_outputs, mode):
    q = inference_outputs[self.q_output_key]
    loss = torch.mean((q - labels[self.reward_label_key]) ** 2)
    return loss, {"td_mse": loss}

  def model_eval_fn(self, features, labels, inference_outputs):
    loss, scalars = self.model_train_fn(features, labels, inference_outputs,
                                        modes_lib.EVAL)
    q = inference_outputs[self.q_output_key]
    return {"loss": loss, "q_mean": torch.mean(q), **scalars}

  @staticmethod
  def tile_state_for_actions(state_tree, num_action_samples: int):
    """Repeats each state row `num_action_samples` times so a [B] state
    batch scores a [B * num_action_samples] action batch (CEM serving)."""
    if isinstance(state_tree, Mapping):
      return type(state_tree)(
          {k: CriticModel.tile_state_for_actions(v, num_action_samples)
           for k, v in state_tree.items()})
    return torch.repeat_interleave(state_tree, num_action_samples, dim=0)
