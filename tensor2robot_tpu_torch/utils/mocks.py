"""Mock model + input generator fixtures.

Counterpart of `tensor2robot_tpu.utils.mocks`: a tiny MLP with batch norm
(`MockMLP`, layers `dense_0`, `bn_0`, `dense_1`, `bn_1`, `head`, the JAX
package's names) producing one logit, the binary classifier around it
(`MockT2RModel`), and a deterministic linearly separable dataset
(`make_separable_data`, the same numpy draws as the JAX package) cycled
by `MockInputGenerator`. It trains end to end in a few hundred CPU steps
(`configs/mock_train.gin`) and is the base model of the MAML tests.
"""

from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tensor2robot_tpu_torch import modes as modes_lib
from tensor2robot_tpu_torch import specs as specs_lib
from tensor2robot_tpu_torch.data import input_generators, pipeline
from tensor2robot_tpu_torch.layers import flax_layers
from tensor2robot_tpu_torch.models import abstract as abstract_model
from tensor2robot_tpu_torch.models import optimizers as optimizers_lib
from tensor2robot_tpu_torch.specs import SpecStruct, TensorSpec
from tensor2robot_tpu_torch.utils import config

__all__ = ["MockMLP", "MockT2RModel", "MockInputGenerator",
           "make_separable_data"]

INPUT_SIZE = 3


class MockMLP(nn.Module):
  """Two Dense (+ flax BatchNorm) + relu layers and a one-logit head;
  `forward` returns ({logit, prediction}, new batch-norm statistics)."""

  def __init__(self, hidden_size: int = 16, use_batch_norm: bool = True):
    super().__init__()
    self.use_batch_norm = use_batch_norm
    width = INPUT_SIZE
    for i in range(2):
      self.add_module(f"dense_{i}", nn.Linear(width, hidden_size))
      if use_batch_norm:
        self.add_module(f"bn_{i}", flax_layers.BatchNorm(hidden_size))
      width = hidden_size
    self.head = nn.Linear(width, 1)

  def forward(self, features, mode: str = modes_lib.TRAIN,
              train: bool = False):
    x = features["x"]
    new_state = {}
    for i in range(2):
      x = getattr(self, f"dense_{i}")(x)
      if self.use_batch_norm:
        x, stats = getattr(self, f"bn_{i}")(x, train)
        new_state.update({f"bn_{i}.{k}": v for k, v in stats.items()})
      x = F.relu(x)
    logit = self.head(x)
    return SpecStruct({"logit": logit,
                       "prediction": torch.sigmoid(logit)}), new_state


@config.configurable
class MockT2RModel(abstract_model.T2RModel):
  """Binary classifier over 3-dim features; optional multi-dataset specs
  exercising `dataset_key` joins. Adam at 1e-2 unless an `optimizer_fn`
  is given."""

  def __init__(self, multi_dataset: bool = False, use_batch_norm: bool = True,
               **kwargs):
    super().__init__(**kwargs)
    self._multi_dataset = multi_dataset
    self._use_batch_norm = use_batch_norm

  def get_feature_specification(self, mode):
    return SpecStruct({
        "x": TensorSpec(shape=(INPUT_SIZE,), dtype=np.float32,
                        name="measured_position",
                        dataset_key="dataset1" if self._multi_dataset
                        else ""),
    })

  def get_label_specification(self, mode):
    return SpecStruct({
        "y": TensorSpec(shape=(1,), dtype=np.float32, name="valid_position",
                        dataset_key="dataset2" if self._multi_dataset
                        else ""),
    })

  def create_module(self):
    return MockMLP(use_batch_norm=self._use_batch_norm)

  def create_optimizer(self):
    if self._optimizer_fn is not None:
      return super().create_optimizer()
    return optimizers_lib.create_adam_optimizer(1e-2)

  def model_train_fn(self, features, labels, inference_outputs, mode):
    logit = inference_outputs["logit"]
    y = labels["y"]
    loss = torch.mean(torch.clamp(logit, min=0) - logit * y
                      + torch.log1p(torch.exp(-torch.abs(logit))))
    return loss, {"sigmoid_xent": loss}

  def model_eval_fn(self, features, labels, inference_outputs):
    prediction = inference_outputs["prediction"]
    y = labels["y"]
    accuracy = torch.mean(((prediction > 0.5).to(y.dtype) == y).to(y.dtype))
    mse = torch.mean((prediction - y) ** 2)
    return {"accuracy": accuracy, "mse": mse}


def make_separable_data(num_samples: int, seed: int = 0
                        ) -> Tuple[np.ndarray, np.ndarray]:
  """Deterministic linearly separable data: x uniform in [-1, 1]^3,
  y = [x . (1.5, -2, 0.5) > 0]."""
  rng = np.random.RandomState(seed)
  x = rng.uniform(-1.0, 1.0, size=(num_samples, INPUT_SIZE)).astype(
      np.float32)
  w = np.array([1.5, -2.0, 0.5], np.float32)
  y = (x @ w > 0.0).astype(np.float32)[:, None]
  return x, y


@config.configurable
class MockInputGenerator(input_generators.AbstractInputGenerator):
  """Cycles deterministically through the separable dataset."""

  def __init__(self, batch_size: int = 32, num_samples: int = 256,
               seed: int = 0):
    super().__init__(batch_size=batch_size)
    self._x, self._y = make_separable_data(num_samples, seed)

  def create_dataset(self, mode: str) -> Iterator[specs_lib.SpecStruct]:
    def _iterate():
      pos = 0
      n = self._x.shape[0]
      while True:
        idx = [(pos + i) % n for i in range(self._batch_size)]
        pos = (pos + self._batch_size) % n
        yield self._preprocessed(
            pipeline.as_tensors(SpecStruct({"x": self._x[idx]})),
            pipeline.as_tensors(SpecStruct({"y": self._y[idx]})), mode)

    return _iterate()
