"""The flagship configuration of the QT-Opt grasping critic.

Counterpart of `tensor2robot_tpu.research.qtopt.flagship`: one
constructor, so every measurement of the critic times the same network —
reference-scale Grasping44 (the 16-conv batch-norm tower) at 472x472x3
with the named grasp-param blocks, bfloat16 compute and EMA, which
`configs/train_qtopt.gin` trains. On 'cpu' it is the small smoke critic
(GraspingCNN at 32x32, action 4, float32).
"""

from __future__ import annotations

from tensor2robot_tpu_torch.research.qtopt import models as qtopt_models

__all__ = ["IMAGE_SIZE", "ACTION_SIZE", "GRASP_PARAM_NAMES",
           "make_flagship_model"]

IMAGE_SIZE = 472
ACTION_SIZE = 5
GRASP_PARAM_NAMES = {"world_vector": (0, 3), "vertical_rotation": (3, 2)}


def make_flagship_model(device_platform: str = "gpu", remat: bool = False,
                        space_to_depth: bool = False,
                        **kwargs) -> qtopt_models.QTOptModel:
  """Grasping44 at 472, bf16, EMA on an accelerator ('gpu'); the small
  critic at 32x32 on 'cpu'. `remat` recomputes the train step's forward
  in its backward; `space_to_depth` runs the stem folded (the same math;
  the small critic has no such stem). `kwargs` override the model's
  arguments (e.g. `use_bfloat16=False`)."""
  on_device = device_platform != "cpu"
  args = dict(
      image_size=IMAGE_SIZE if on_device else 32,
      network="grasping44" if on_device else "small",
      action_size=ACTION_SIZE if on_device else 4,
      grasp_param_names=GRASP_PARAM_NAMES if on_device else None,
      space_to_depth=space_to_depth and on_device,
      use_bfloat16=on_device, use_ema=True, remat=remat)
  args.update(kwargs)
  return qtopt_models.QTOptModel(**args)
