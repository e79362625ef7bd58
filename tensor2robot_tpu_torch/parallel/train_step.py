"""Model state and the predict function (serving subset).

Counterpart of `tensor2robot_tpu.parallel.train_step`: `TrainState` holds
the parameters (and EMA shadow parameters when present) as flat
`state_dict`s on one device; `make_predict_fn` is the PREDICT branch.
The train and eval steps come with the training slice.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import torch

from tensor2robot_tpu_torch import modes as modes_lib

__all__ = ["TrainState", "create_train_state", "make_predict_fn"]

Params = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class TrainState:
  """Model state: step, parameters, EMA shadow parameters (or None)."""

  step: int
  params: Params
  ema_params: Optional[Params] = None

  def eval_params(self, use_ema: bool = True) -> Params:
    """Params for eval/serving: the EMA shadow when present."""
    if use_ema and self.ema_params is not None:
      return self.ema_params
    return self.params

  def replace(self, **changes) -> "TrainState":
    return dataclasses.replace(self, **changes)


def create_train_state(model, generator: torch.Generator,
                       device: torch.device) -> TrainState:
  """Fresh parameters from `generator` (drawn on the CPU, then moved),
  step 0, no EMA."""
  params = {k: v.to(device) for k, v in model.init_params(generator).items()}
  return TrainState(step=0, params=params)


def make_predict_fn(model, use_ema: bool = True) -> Callable:
  """(state, features) -> export outputs, with bfloat16 outputs cast to
  float32."""

  @torch.no_grad()
  def predict_fn(state: TrainState, features):
    params = state.eval_params(use_ema=use_ema)
    compute_features = model.cast_features_for_compute(features)
    outputs = model.inference_network_fn(params, compute_features,
                                         modes_lib.PREDICT)
    outputs = {k: v.float() if v.dtype == torch.bfloat16 else v
               for k, v in outputs.items()}
    return model.create_export_outputs_fn(features, outputs)

  return predict_fn
