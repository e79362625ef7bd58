"""How the cells drive the port's sequence policy: its model object, its
inputs in the form its entry points take them, and what its optimizer
state says of the first gradient."""

from __future__ import annotations

from typing import Dict, Mapping

import torch

from tensor2robot_tpu_torch.models import sequence_model
from tensor2robot_tpu_torch.predictors import predictors
from tensor2robot_tpu_torch.serving import session
from tensor2robot_tpu_torch.specs import SpecStruct, cast_float32_to_bfloat16


def build_model(cfg: Mapping, role: str):
  """The port's model for `role` ("train" or "serve")."""
  m = cfg["model"]
  return sequence_model.SequenceRegressionModel(
      obs_size=m["obs_size"], action_size=m["action_size"],
      sequence_length=m["sequence_length"], hidden_size=m["hidden_size"],
      num_blocks=m["num_blocks"], num_heads=m["num_heads"],
      attention_backend=m["attention_backend"],
      use_bfloat16=role == "train" and cfg["train"]["use_bfloat16"])


def make_batch(cfg: Mapping, model, batch: int, generator, device):
  """(features, labels) as the trainer hands them to the step: under the
  bfloat16 policy its device preprocessor has cast them to bfloat16.
  Each sequence's target actions are an offset of its own plus unit
  noise a step, so the sequences of a batch pull the gradient apart and
  a step over part of the batch is not the step over all of it."""
  m = cfg["model"]
  shape = (batch, m["sequence_length"])
  obs = torch.randn(shape + (m["obs_size"],), generator=generator,
                    device=device)
  action = torch.randn(shape + (m["action_size"],), generator=generator,
                       device=device)
  action += torch.randn((batch, 1, m["action_size"]), generator=generator,
                        device=device)
  features, labels = (SpecStruct({"observation": obs}),
                      SpecStruct({"action": action}))
  if model.use_bfloat16:
    features, labels = (cast_float32_to_bfloat16(features),
                        cast_float32_to_bfloat16(labels))
  return features, labels


def first_gradient(cfg: Mapping, opt_state, params0
                   ) -> Dict[str, torch.Tensor]:
  """The gradient the optimizer got in its first step: Adam's first
  moment after one step is (1 - b1) g."""
  del params0
  b1 = cfg["train"]["optimizer"]["b1"]
  return {k: mu / (1.0 - b1) for k, mu in opt_state[0]["mu"].items()}


def build_engine(cfg: Mapping, traffic: Mapping, model, params, device):
  """A `SessionEngine` serving `model` on `params` with the
  configuration's serving knobs and the traffic's tick batch."""
  serve = cfg["serve"]
  predictor = predictors.CheckpointPredictor(model=model, device=device)
  predictor.load_params(params)
  predictor.restore()
  return session.SessionEngine(
      predictor=predictor, max_sessions=serve["max_sessions"],
      max_tick_batch=traffic["max_tick_batch"],
      admission=serve["admission"], device=device)
