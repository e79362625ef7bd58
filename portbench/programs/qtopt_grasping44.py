"""How the cells drive the port's QT-Opt critic: its model object, its
inputs in the form the train step takes them, and what its optimizer
state says of the first gradient."""

from __future__ import annotations

from typing import Dict, Mapping

import torch

from tensor2robot_tpu_torch.research.qtopt import models as qtopt_models
from tensor2robot_tpu_torch.specs import SpecStruct, cast_float32_to_bfloat16


def build_model(cfg: Mapping, role: str):
  """The port's critic with the published recipe (`role` is "train")."""
  del role
  m, t = cfg["model"], cfg["train"]
  opt = t["optimizer"]
  return qtopt_models.QTOptModel(
      network=m["network"], image_size=m["image_size"],
      image_channels=m["image_channels"], action_size=m["action_size"],
      grasp_param_names={k: tuple(v) for k, v in
                         m["grasp_param_names"].items()},
      num_convs=tuple(m["num_convs"]), remat=m["remat"],
      space_to_depth=m["space_to_depth"], use_bfloat16=t["use_bfloat16"],
      use_ema=t["use_ema"], ema_decay=t["ema_decay"],
      learning_rate=opt["learning_rate"], momentum=opt["momentum"],
      lr_decay_steps=opt["decay_steps"], lr_decay_rate=opt["decay_rate"],
      l2_regularization=opt["weight_decay"])


def make_batch(cfg: Mapping, model, batch: int, generator, device):
  """(features, labels) as the trainer hands them to the step: uint8
  images, and under the bfloat16 policy bfloat16 grasp parameters and
  rewards."""
  m = cfg["model"]
  size = m["image_size"]
  image = torch.randint(0, 256, (batch, size, size, m["image_channels"]),
                        generator=generator, device=device,
                        dtype=torch.uint8)
  action = torch.randn((batch, m["action_size"]), generator=generator,
                       device=device)
  reward = (torch.rand((batch, 1), generator=generator, device=device)
            < 0.5).float()
  features = SpecStruct({"state/image": image, "action/action": action})
  labels = SpecStruct({"reward": reward})
  if model.use_bfloat16:
    features, labels = (cast_float32_to_bfloat16(features),
                        cast_float32_to_bfloat16(labels))
  return features, labels


def first_gradient(cfg: Mapping, opt_state, params0
                   ) -> Dict[str, torch.Tensor]:
  """The gradient the optimizer got in its first step: the momentum
  trace after one step is g plus the weight decay of the kernels."""
  decay = cfg["train"]["optimizer"]["weight_decay"]
  trace = opt_state[1][0]["trace"]
  return {k: t - decay * params0[k] if t.ndim > 1 else t.clone()
          for k, t in trace.items()}
