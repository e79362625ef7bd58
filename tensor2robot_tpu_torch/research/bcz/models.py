"""BC-Z: language- or task-conditioned behavioural cloning of waypoint
trajectories.

Counterpart of `tensor2robot_tpu.research.bcz.models`:

* the action component tables (`POSE_COMPONENTS`,
  `REFERENCE_ACTION_COMPONENTS`, `normalize_components`), `huber`,
  `piecewise_scaled_huber` and `xyz_action_trajectory`;
* `BCZPreprocessor`: random crop (eval: center crop), antialiased resize
  and the photometric chain, mixup, gripper binarization. Call n draws
  from a `torch.Generator` seeded `seed + n` (the call counter is kept);
  mixup's weight is numpy's `default_rng(seed + n).beta`, the JAX
  package's own draw. Tensors stay on the device they came on;
* `BCZModel`: a FiLM-ResNet (`resnet_film`), the pipelined Berkeley
  conv stack (`pipelined_berkeley`: `vision.PipelinedBerkeleyTower` with
  the `pipeline_*` knobs, then the spatial softmax `tower_ssm`) or else
  a spatial-softmax `BerkeleyNet` trunk conditioned on a language
  embedding, a one-hot subtask id and/or a user embedding, optionally a
  GRU over past frames,
  the stop-gradient `MultiHeadMLP` waypoint decoder, a stop head on
  detached features and a 3-class stop-state head; per-component huber
  losses masked after the stop, the stop and stop-state losses, gripper
  metrics.

Module names are flax's (`resnet`, `tower`, `past_encoder`, `decoder`,
`stop_fc`, `stop_logits`, `stop_state_fc0`, `stop_state_ln0`,
`stop_state_logits`, `stop_state_rest_logits`, `user_embed`), so
`bridge.py` carries a JAX tree across.

Deviations, each forced by torch's eager parameters: the JAX network
appends `present_pose` to the decoder's input when a batch carries it at
init; here `use_present_pose` says so up front (a batch that carries it
without the flag raises). The task-embedding noise, `make_rng('dropout')`
in JAX, is drawn from a `torch.Generator` seeded `NOISE_SEED` on the
noise's device, or from `network.noise_fn` where a caller injects it.

With `network='pipelined_berkeley'` and a mesh whose `pp_axis` has more
than one rank (`set_mesh`, before the module is built) the conv stages
run the heterogeneous GPipe schedule over `pipeline_microbatches`
microbatches of this rank's rows; the spatial softmax and the heads run
data-parallel after it. The tower's `pp_stages` is then stage-local
(`stage_local_axes`). Without such a mesh, the sequential schedule.
On any mesh whose batch is split over data ranks, the losses and eval
metrics read the whole batch (each rank gathers every rank's rows over
the batch's axes, `collectives.all_gather_batch`): the masked means
normalise by the whole batch's active elements, as the JAX package's
jitted step does.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tensor2robot_tpu_torch import modes as modes_lib
from tensor2robot_tpu_torch import specs as specs_lib
from tensor2robot_tpu_torch.layers import bcz_networks, film_resnet, vision
from tensor2robot_tpu_torch.layers import flax_layers
from tensor2robot_tpu_torch.layers.spatial_softmax import SpatialSoftmax
from tensor2robot_tpu_torch.models import abstract as abstract_model
from tensor2robot_tpu_torch.ops.image_norm import normalize_image
from tensor2robot_tpu_torch.parallel import collectives
from tensor2robot_tpu_torch.preprocessors import base as preprocessors_lib
from tensor2robot_tpu_torch.preprocessors import image_ops
from tensor2robot_tpu_torch.specs import SpecStruct, TensorSpec
from tensor2robot_tpu_torch.utils import config

__all__ = ["POSE_COMPONENTS", "REFERENCE_ACTION_COMPONENTS",
           "normalize_components", "component_wire_name", "huber",
           "piecewise_scaled_huber", "xyz_action_trajectory",
           "BCZPreprocessor", "BCZModel"]

# (name, size, weight), read as non-residual; 4-tuples (name, size,
# residual, weight) give residual components.
POSE_COMPONENTS: Tuple[Tuple[str, int, float], ...] = (
    ("xyz", 3, 1.0),
    ("axis_angle", 3, 1.0),
    ("gripper", 1, 1.0),
)
# The reference's published table: residual xyz weighted 100, absolute
# quaternion 10, gripper 1.
REFERENCE_ACTION_COMPONENTS: Tuple[Tuple[str, int, bool, float], ...] = (
    ("xyz", 3, True, 100.0),
    ("quaternion", 4, False, 10.0),
    ("target_close", 1, False, 1.0),
)
STOP_KEY = "stop"
STOP_STATE_KEY = "stop_state"
NUM_STOP_STATES = 3  # continue / fail-help / success
STOP_HIDDEN = 64
STOP_STATE_HIDDEN = (100, 100)
DECODER_HIDDEN = (256, 256)
PRESENT_POSE_SIZE = 7
PAST_FRAMES_FILTERS = (16,)
LAYER_NORM_EPSILON = 1e-6  # flax's default
NOISE_SEED = 0

State = Dict[str, torch.Tensor]


def normalize_components(components) -> Tuple[Tuple[str, int, bool, float],
                                              ...]:
  """(name, size[, residual], weight) -> (name, size, residual, weight);
  residual components read and write `<name>_residual` wire features."""
  out = []
  for entry in components:
    entry = tuple(entry)
    if len(entry) == 3:
      name, size, weight = entry
      out.append((name, int(size), False, float(weight)))
    elif len(entry) == 4:
      name, size, residual, weight = entry
      out.append((name, int(size), bool(residual), float(weight)))
    else:
      raise ValueError(f"Bad action component {entry!r}")
  return tuple(out)


def component_wire_name(name: str, residual: bool) -> str:
  return name + "_residual" if residual else name


def huber(x: torch.Tensor, delta: float = 1.0) -> torch.Tensor:
  abs_x = torch.abs(x)
  return torch.where(abs_x <= delta, 0.5 * x ** 2,
                     delta * (abs_x - 0.5 * delta))


def piecewise_scaled_huber(loss: torch.Tensor, threshold: float = 0.2,
                           slope: float = 0.001) -> torch.Tensor:
  """Flattens a component loss above 1 to a shallow slope (outlier
  demonstrations)."""
  return torch.where(loss > 1.0, threshold + (loss - threshold) * slope,
                     loss)


def xyz_action_trajectory(outputs) -> torch.Tensor:
  """[xyz | rotation] trajectory [B, W, 3 + rotation] for serving,
  preferring the `<name>_absolute` outputs of residual heads."""

  def pick(name):
    if name + "_absolute" in outputs:
      return outputs[name + "_absolute"]
    return outputs[name]

  if "quaternion" in outputs:
    rotation = pick("quaternion")
  elif "axis_angle" in outputs:
    rotation = pick("axis_angle")
  else:
    raise KeyError("outputs carry neither 'quaternion' nor 'axis_angle'")
  return torch.cat([torch.as_tensor(pick("xyz")), torch.as_tensor(rotation)],
                   dim=-1)


def _is_integer(value: torch.Tensor) -> bool:
  return not (torch.is_floating_point(value) or value.dtype == torch.bool)


@config.configurable
class BCZPreprocessor(preprocessors_lib.SpecTransformationPreprocessor):
  """The wire image is larger than the model's: training crops at random
  and distorts, eval crops the center; both resize to `model_size`.
  Training with `mixup_alpha` > 0 blends every float feature and label
  with the next example's (roll by one), unless a non-image feature is
  discrete."""

  def __init__(self,
               input_size: Tuple[int, int] = (96, 96),
               crop_size: Tuple[int, int] = (80, 80),
               model_size: Tuple[int, int] = (64, 64),
               mixup_alpha: float = 0.0,
               binarize_gripper: bool = True,
               seed: int = 0,
               **kwargs):
    super().__init__(**kwargs)
    self._input_size = tuple(input_size)
    self._crop_size = tuple(crop_size)
    self._model_size = tuple(model_size)
    self._mixup_alpha = mixup_alpha
    self._binarize_gripper = binarize_gripper
    self._seed = seed
    self._calls = 0

  def update_in_spec(self, spec, key):
    if key == "image":
      return spec.replace(shape=self._input_size + (spec.shape[-1],),
                          dtype=np.uint8)
    return spec

  def draws(self, seed: int, image_shape: Tuple[int, ...],
            is_training: bool) -> image_ops.Draws:
    """One call's crop and photometric draws (CPU tensors), from a
    generator seeded `seed`; a caller may inject others by overriding."""
    return image_ops.draw_crop_resize_distort(
        torch.Generator().manual_seed(seed), image_shape, self._crop_size,
        self._model_size, is_training=is_training)

  def _preprocess_fn(self, features, labels, mode):
    features = specs_lib.flatten_spec_structure(features)
    self._calls += 1
    seed = self._seed + self._calls
    is_training = mode == modes_lib.TRAIN
    image = features["image"]
    draws = self.draws(seed, tuple(image.shape), is_training)
    features["image"] = image_ops.crop_resize_distort(
        image, self._crop_size, self._model_size, is_training=is_training,
        draws=draws)
    if labels is None or not len(labels):
      return features, labels
    labels = specs_lib.flatten_spec_structure(labels)
    if self._binarize_gripper and "gripper" in labels:
      labels["gripper"] = (labels["gripper"] > 0.5).to(torch.float32)
    discrete = any(_is_integer(features[k]) for k in features.keys()
                   if k != "image")
    if is_training and self._mixup_alpha > 0.0 and not discrete:
      # One partner for every leaf, so the conditioning stays consistent
      # with the blended labels.
      lam = float(np.random.default_rng(seed).beta(self._mixup_alpha,
                                                   self._mixup_alpha))
      batch = features["image"].shape[0]
      perm = torch.roll(torch.arange(batch), 1)
      for k in list(features.keys()):
        value = features[k]
        if torch.is_floating_point(value):
          features[k] = lam * value + (1 - lam) * value[perm.to(value.device)]
      for k in list(labels.keys()):
        value = labels[k].to(torch.float32)
        labels[k] = lam * value + (1 - lam) * value[perm.to(value.device)]
    return features, labels


class _Embed(nn.Embedding):
  """flax `nn.Embed`: the table [num, features] drawn N(0, 1/features)."""

  def initial_params(self, generator: torch.Generator
                     ) -> Dict[str, torch.Tensor]:
    weight = torch.empty_like(self.weight, device="cpu")
    nn.init.normal_(weight, std=1.0 / math.sqrt(self.embedding_dim),
                    generator=generator)
    return {"weight": weight}


class _BCZNetwork(nn.Module):
  """Trunk (FiLM-ResNet or spatial-softmax tower) -> waypoint heads, stop
  and stop-state heads."""

  def __init__(self,
               components: Tuple[Tuple[str, int, bool, float], ...] = (),
               num_waypoints: int = 10,
               network: str = "resnet_film",
               resnet_size: int = 18,
               resnet_version: int = 1,
               condition_mode: Optional[str] = None,
               condition_size: int = 0,
               num_subtasks: int = 0,
               task_embedding_noise_std: Optional[float] = None,
               ignore_task_embedding: bool = False,
               num_users: int = 0,
               user_embedding_size: int = 8,
               use_past_frames: bool = False,
               past_frames_hidden: int = 32,
               use_present_pose: bool = False,
               predict_stop: bool = True,
               predict_stop_state: bool = False,
               dtype: Optional[torch.dtype] = None,
               image_size: int = 64,
               pp_mesh=None,
               pp_axis: str = "pp",
               pp_num_microbatches: int = 4,
               pp_filters: Tuple[int, ...] = (64, 32, 32, 32),
               pp_kernel_sizes: Tuple[int, ...] = (7, 3, 3, 3),
               pp_strides: Tuple[int, ...] = (2, 1, 1, 1)):
    super().__init__()
    self.components = components
    self.num_waypoints = num_waypoints
    self.network = network
    self.condition_mode = condition_mode
    self.num_subtasks = num_subtasks
    self.task_embedding_noise_std = task_embedding_noise_std
    self.ignore_task_embedding = ignore_task_embedding
    self.num_users = num_users
    self.use_past_frames = use_past_frames
    self.use_present_pose = use_present_pose
    self.predict_stop = predict_stop
    self.predict_stop_state = predict_stop_state
    self.dtype = dtype
    self._noise_generators: Dict[str, torch.Generator] = {}
    # (shape, dtype, device) -> a unit normal draw; replace to inject.
    self.noise_fn: Callable[..., torch.Tensor] = self._draw_noise

    task_width = {"language": condition_size,
                  "onehot_taskid": num_subtasks}.get(condition_mode, 0)
    if ignore_task_embedding:
      task_width = 0
    cond_width = task_width + (user_embedding_size if num_users else 0)
    if num_users:
      self.user_embed = _Embed(num_users, user_embedding_size)
    if network == "resnet_film":
      self.resnet = film_resnet.ResNet(3, resnet_size=resnet_size,
                                       version=resnet_version,
                                       condition_size=cond_width, dtype=dtype)
      width = 2048 if resnet_size >= film_resnet.BOTTLENECK_FROM else 512
    elif network == "pipelined_berkeley":
      self.tower = vision.PipelinedBerkeleyTower(
          (image_size, image_size, 3), filters=pp_filters,
          kernel_sizes=pp_kernel_sizes, strides=pp_strides,
          condition_size=cond_width, mesh=pp_mesh, axis_name=pp_axis,
          num_microbatches=pp_num_microbatches, dtype=dtype)
      self.tower_ssm = SpatialSoftmax()
      width = 2 * pp_filters[-1]
    else:
      self.tower = vision.BerkeleyNet(3, condition_size=cond_width,
                                      dtype=dtype)
      width = 2 * 32  # spatial softmax points of the default tower
    if use_past_frames:
      self.past_encoder = bcz_networks.ConvGRUEncoder(
          3, hidden_size=past_frames_hidden, filters=PAST_FRAMES_FILTERS,
          dtype=dtype)
      width += past_frames_hidden
    if use_present_pose:
      width += PRESENT_POSE_SIZE
    action_size = sum(size for _, size, _, _ in components)
    self.decoder = bcz_networks.MultiHeadMLP(
        width, num_waypoints, action_size, hidden_sizes=DECODER_HIDDEN,
        dtype=dtype)
    if predict_stop:
      self.stop_fc = nn.Linear(width, STOP_HIDDEN)
      self.stop_logits = nn.Linear(STOP_HIDDEN, num_waypoints)
    if predict_stop_state:
      hidden = width
      for i, size in enumerate(STOP_STATE_HIDDEN):
        self.add_module(f"stop_state_fc{i}", nn.Linear(hidden, size,
                                                       bias=False))
        self.add_module(f"stop_state_ln{i}", nn.LayerNorm(size))
        hidden = size
      self.stop_state_logits = nn.Linear(hidden, NUM_STOP_STATES)
      if num_waypoints > 1:
        self.stop_state_rest_logits = nn.Linear(
            hidden, (num_waypoints - 1) * NUM_STOP_STATES)

  def _draw_noise(self, shape, dtype: torch.dtype,
                  device: torch.device) -> torch.Tensor:
    key = str(device)
    if key not in self._noise_generators:
      self._noise_generators[key] = torch.Generator(
          device=device).manual_seed(NOISE_SEED)
    return torch.randn(shape, dtype=dtype, device=device,
                       generator=self._noise_generators[key])

  def _dense(self, name: str, x: torch.Tensor) -> torch.Tensor:
    layer = getattr(self, name)
    return flax_layers.dense(x, layer.weight, layer.bias, self.dtype)

  def _conditioning(self, features, image: torch.Tensor, train: bool
                    ) -> Optional[torch.Tensor]:
    batch = image.shape[0]
    task_embedding = None
    if self.condition_mode == "language":
      task_embedding = features["condition_embedding"]
    elif self.condition_mode == "onehot_taskid":
      # jax.nn.one_hot: an id outside [0, num_subtasks) is a zero row.
      subtask = features["subtask_id"].long().reshape(batch)
      classes = torch.arange(self.num_subtasks, device=subtask.device)
      task_embedding = (subtask[:, None] == classes).to(
          torch.promote_types(image.dtype, torch.float32))
    if self.ignore_task_embedding:
      task_embedding = None
    elif (task_embedding is not None and train
          and self.task_embedding_noise_std):
      noise = self.noise_fn(tuple(task_embedding.shape),
                            torch.promote_types(task_embedding.dtype,
                                                torch.float32),
                            task_embedding.device)
      task_embedding = task_embedding + self.task_embedding_noise_std * noise
    parts = [] if task_embedding is None else [task_embedding]
    if self.num_users:
      user_id = torch.clamp(features["user_id"].long(), 0,
                            self.num_users - 1)
      parts.append(F.embedding(user_id, self.user_embed.weight).reshape(
          batch, -1))
    return torch.cat(parts, dim=-1) if parts else None

  def forward(self, features, mode: str = modes_lib.TRAIN,
              train: bool = False):
    image = normalize_image(features["image"], self.dtype)
    conditioning = self._conditioning(features, image, train)
    if self.network == "resnet_film":
      feats, _, trunk_state = self.resnet(image, conditioning, train=train)
      state = {f"resnet.{k}": v for k, v in trunk_state.items()}
    elif self.network == "pipelined_berkeley":
      fmap, state = self.tower(image, conditioning, train=train)
      feats = self.tower_ssm(fmap.permute(0, 3, 1, 2), train=train)
    else:
      feats, trunk_state = self.tower(image, conditioning, train=train)
      state = {f"tower.{k}": v for k, v in trunk_state.items()}
    if self.use_past_frames:
      past = normalize_image(features["past_frames"], self.dtype)
      history, past_state = self.past_encoder(past, train=train)
      state.update({f"past_encoder.{k}": v for k, v in past_state.items()})
      feats = torch.cat([feats, history[:, -1].to(feats.dtype)], dim=-1)
    if self.use_present_pose:
      feats = torch.cat([feats, features["present_pose"].to(feats.dtype)],
                        dim=-1)
    elif "present_pose" in features:
      raise ValueError("features carry present_pose but the network was "
                       "built without it: BCZModel(use_present_pose=True)")
    waypoints = self.decoder(feats, train=train)  # [B, W, action]
    outputs = SpecStruct()
    offset = 0
    for name, size, residual, _ in self.components:
      outputs[name] = waypoints[:, :, offset:offset + size]
      offset += size
      if residual and f"present_{name}" in features:
        # Residual heads predict deltas; serving gets delta + present.
        outputs[name + "_absolute"] = outputs[name] + features[
            f"present_{name}"].to(outputs[name].dtype)[:, None, :]
    if self.predict_stop:
      x = F.relu(self._dense("stop_fc", feats.detach()))
      outputs[STOP_KEY] = self._dense("stop_logits", x)
    if self.predict_stop_state:
      # Hidden denses without bias (the layer norm's shift replaces it);
      # only the first waypoint's logits train the trunk.
      x = feats
      for i in range(len(STOP_STATE_HIDDEN)):
        norm = getattr(self, f"stop_state_ln{i}")
        x = F.relu(flax_layers.layer_norm(
            self._dense(f"stop_state_fc{i}", x), norm.weight, norm.bias,
            LAYER_NORM_EPSILON, dim=-1))
      logits = self._dense("stop_state_logits", x)
      if self.num_waypoints > 1:
        logits = torch.cat([logits, self._dense("stop_state_rest_logits",
                                                x.detach())], dim=-1)
      outputs[STOP_STATE_KEY] = logits.reshape(
          logits.shape[0], self.num_waypoints, NUM_STOP_STATES)
    return outputs, state


@config.configurable
class BCZModel(abstract_model.T2RModel):
  """The BC-Z trajectory cloner."""

  def __init__(self,
               image_size: int = 64,
               num_waypoints: int = 10,
               components: Sequence = POSE_COMPONENTS,
               network: str = "resnet_film",
               resnet_size: int = 18,
               resnet_version: int = 1,
               condition_mode: Optional[str] = None,
               condition_size: int = 0,
               num_subtasks: int = 0,
               task_embedding_noise_std: Optional[float] = None,
               ignore_task_embedding: bool = False,
               num_users: int = 0,
               num_past_frames: int = 0,
               use_present_pose: bool = False,
               predict_stop: bool = True,
               predict_stop_state: bool = False,
               huber_delta: float = 1.0,
               loss_clip_threshold: Optional[float] = None,
               loss_clip_slope: float = 0.001,
               stop_loss_weight: float = 0.1,
               gripper_metrics_component: Optional[str] = None,
               pipeline_microbatches: int = 4,
               pipeline_filters: Sequence[int] = (64, 32, 32, 32),
               pipeline_kernel_sizes: Sequence[int] = (7, 3, 3, 3),
               pipeline_strides: Sequence[int] = (2, 1, 1, 1),
               pp_axis: str = "pp",
               **kwargs):
    kwargs.setdefault("preprocessor_cls", BCZPreprocessor)
    super().__init__(**kwargs)
    if condition_mode is None and condition_size:
      condition_mode = "language"  # condition_size alone implies it
    if condition_mode not in (None, "language", "onehot_taskid"):
      raise ValueError(f"Unknown condition_mode {condition_mode!r}")
    if condition_mode == "language" and not condition_size:
      raise ValueError("condition_mode='language' needs condition_size.")
    if condition_mode == "onehot_taskid" and not num_subtasks:
      raise ValueError("condition_mode='onehot_taskid' needs num_subtasks.")
    if task_embedding_noise_std and self.remat:
      raise ValueError("remat recomputes the forward in the backward, which "
                       "would draw the task-embedding noise twice")
    self._image_size = image_size
    self._num_waypoints = num_waypoints
    self._components = normalize_components(components)
    self._network = network
    self._resnet_size = resnet_size
    self._resnet_version = resnet_version
    self._condition_mode = condition_mode
    self._condition_size = condition_size
    self._num_subtasks = num_subtasks
    self._task_embedding_noise_std = task_embedding_noise_std
    self._ignore_task_embedding = ignore_task_embedding
    self._num_users = num_users
    self._num_past_frames = num_past_frames
    self._use_present_pose = use_present_pose
    self._predict_stop = predict_stop
    self._predict_stop_state = predict_stop_state
    self._huber_delta = huber_delta
    self._loss_clip_threshold = loss_clip_threshold
    self._loss_clip_slope = loss_clip_slope
    self._stop_loss_weight = stop_loss_weight
    self._gripper_metrics_component = gripper_metrics_component
    self._pipeline_microbatches = pipeline_microbatches
    self._pipeline_filters = tuple(pipeline_filters)
    self._pipeline_kernel_sizes = tuple(pipeline_kernel_sizes)
    self._pipeline_strides = tuple(pipeline_strides)
    self._pp_axis = pp_axis
    self._mesh = None

  def set_mesh(self, mesh) -> None:
    """Receives the training mesh. With network='pipelined_berkeley' and
    a >1 `pp_axis`, the conv trunk runs the heterogeneous GPipe schedule;
    otherwise it runs sequentially (the same function)."""

    def validate(m):
      if self._network == "pipelined_berkeley":
        self._validate_pp_stage_count(m, self._pp_axis,
                                      len(self._pipeline_filters),
                                      what="pipelined trunk")

    self._set_mesh_guarded(mesh, validate)

  def _pipelined_mesh(self):
    mesh = self._mesh
    if (mesh is not None and self._network == "pipelined_berkeley"
        and mesh.shape.get(self._pp_axis, 1) > 1):
      return mesh
    return None

  def stage_local_axes(self, name: str) -> Tuple[str, ...]:
    if self._pipelined_mesh() is not None and name == "tower.pp_stages":
      return (self._pp_axis,)
    return ()

  def get_feature_specification(self, mode):
    out = SpecStruct({
        "image": TensorSpec(
            shape=(self._image_size, self._image_size, 3),
            dtype=np.float32, name="image/encoded", data_format="jpeg"),
        "present_pose": TensorSpec(shape=(PRESENT_POSE_SIZE,),
                                   dtype=np.float32, name="present_pose",
                                   is_optional=True),
    })
    if self._condition_mode == "language":
      out["condition_embedding"] = TensorSpec(
          shape=(self._condition_size,), dtype=np.float32,
          name="condition_embedding")
    elif self._condition_mode == "onehot_taskid":
      out["subtask_id"] = TensorSpec(shape=(1,), dtype=np.int64,
                                     name="subtask_id")
    if self._gripper_metrics_component:
      out["present_gripper"] = TensorSpec(
          shape=(1,), dtype=np.float32, name="present/sensed_close",
          is_optional=True)
    for name, size, residual, _ in self._components:
      if residual:
        out[f"present_{name}"] = TensorSpec(
            shape=(size,), dtype=np.float32, name="present/" + name,
            is_optional=True)
    if self._num_users:
      out["user_id"] = TensorSpec(shape=(), dtype=np.int64, name="user_id")
    if self._num_past_frames:
      out["past_frames"] = TensorSpec(
          shape=(self._num_past_frames, self._image_size, self._image_size,
                 3), dtype=np.float32, name="past_frames")
    return out

  def get_label_specification(self, mode):
    out = SpecStruct()
    for name, size, residual, _ in self._components:
      out[name] = TensorSpec(shape=(self._num_waypoints, size),
                             dtype=np.float32,
                             name="future/" + component_wire_name(name,
                                                                  residual))
    if self._predict_stop:
      out[STOP_KEY] = TensorSpec(shape=(self._num_waypoints,),
                                 dtype=np.float32, name=STOP_KEY)
    if self._predict_stop_state:
      out[STOP_STATE_KEY] = TensorSpec(shape=(), dtype=np.int64,
                                       name="present/stop_state")
    return out

  def create_module(self) -> nn.Module:
    return _BCZNetwork(
        components=self._components, num_waypoints=self._num_waypoints,
        network=self._network, resnet_size=self._resnet_size,
        resnet_version=self._resnet_version,
        condition_mode=self._condition_mode,
        condition_size=self._condition_size,
        num_subtasks=self._num_subtasks,
        task_embedding_noise_std=self._task_embedding_noise_std,
        ignore_task_embedding=self._ignore_task_embedding,
        num_users=self._num_users,
        use_past_frames=bool(self._num_past_frames),
        use_present_pose=self._use_present_pose,
        predict_stop=self._predict_stop,
        predict_stop_state=self._predict_stop_state,
        dtype=self.compute_dtype if self.use_bfloat16 else None,
        image_size=self._image_size, pp_mesh=self._pipelined_mesh(),
        pp_axis=self._pp_axis,
        pp_num_microbatches=self._pipeline_microbatches,
        pp_filters=self._pipeline_filters,
        pp_kernel_sizes=self._pipeline_kernel_sizes,
        pp_strides=self._pipeline_strides)

  def _whole_batch(self, labels, inference_outputs):
    """The labels and the outputs the losses read, over the whole batch:
    on a data split, every rank's rows gathered (differentiably). The
    masked means normalise by the whole batch's active elements and the
    clip reads the whole batch's mean, as the global batch's loss does."""
    group = collectives.current_batch_group()
    keys = [name for name, _, _, _ in self._components] + [
        STOP_KEY, STOP_STATE_KEY]
    whole = lambda x: collectives.all_gather_batch(x, group)
    return ({k: whole(v) for k, v in labels.items()},
            {k: whole(inference_outputs[k]) for k in keys
             if k in inference_outputs})

  def model_train_fn(self, features, labels, inference_outputs, mode):
    return self._loss(*self._whole_batch(labels, inference_outputs))

  def _loss(self, labels, inference_outputs):
    scalars: Dict[str, torch.Tensor] = {}
    total = 0.0
    # No action loss after the episode stops.
    mask = None
    if self._predict_stop and STOP_KEY in labels:
      mask = (1.0 - labels[STOP_KEY])[:, :, None]
    for name, _, _, weight in self._components:
      elementwise = huber(inference_outputs[name] - labels[name],
                          self._huber_delta)
      if mask is None:
        component_loss = elementwise.mean()
      else:
        # Normalised by the active elements, so the per-step signal does
        # not depend on the episode's length.
        denom = torch.clamp((mask * torch.ones_like(elementwise)).sum(),
                            min=1.0)
        component_loss = (elementwise * mask).sum() / denom
      if self._loss_clip_threshold is not None:
        component_loss = piecewise_scaled_huber(
            component_loss, self._loss_clip_threshold, self._loss_clip_slope)
      scalars[f"loss/{name}"] = component_loss
      total = total + weight * component_loss
    if self._predict_stop and STOP_KEY in labels:
      logits = inference_outputs[STOP_KEY]
      stop = labels[STOP_KEY]
      stop_loss = torch.mean(torch.clamp(logits, min=0) - logits * stop
                             + torch.log1p(torch.exp(-torch.abs(logits))))
      scalars["loss/stop"] = stop_loss
      total = total + self._stop_loss_weight * stop_loss
    if self._predict_stop_state and STOP_STATE_KEY in labels:
      logits = inference_outputs[STOP_STATE_KEY][:, 0]  # first waypoint
      target = torch.clamp(labels[STOP_STATE_KEY].long(), 0,
                           NUM_STOP_STATES - 1)
      log_probs = torch.log_softmax(logits, dim=-1)
      state_loss = -torch.take_along_dim(log_probs, target[:, None],
                                         dim=-1).mean()
      scalars["loss/stop_state"] = state_loss
      total = total + self._stop_loss_weight * state_loss
    return total, scalars

  def _gripper_metrics(self, features, labels, inference_outputs):
    """Closing and opening accuracy, precision, recall and positive rate
    of the first waypoint's gripper change against the sensed value."""
    key = self._gripper_metrics_component
    current = features["present_gripper"][:, 0]
    predicted = inference_outputs[key][:, 0, 0]
    labeled = labels[key][:, 0, 0]
    metrics = {}
    for direction, sign in (("closing", 1.0), ("opening", -1.0)):
      pred = (sign * (predicted - current) > 0).to(torch.float32)
      label = (sign * (labeled - current) > 0).to(torch.float32)
      tp = (pred * label).sum()
      metrics[f"gripper/{direction}_accuracy"] = (
          pred == label).to(torch.float32).mean()
      metrics[f"gripper/{direction}_precision"] = tp / torch.clamp(
          pred.sum(), min=1.0)
      metrics[f"gripper/{direction}_recall"] = tp / torch.clamp(
          label.sum(), min=1.0)
      metrics[f"gripper/{direction}_pos_freq"] = label.mean()
    return metrics

  def model_eval_fn(self, features, labels, inference_outputs):
    labels, inference_outputs = self._whole_batch(labels, inference_outputs)
    loss, scalars = self._loss(labels, inference_outputs)
    metrics = {"loss": loss, **scalars}
    for name, _, _, _ in self._components:
      metrics[f"mae/{name}"] = torch.abs(inference_outputs[name]
                                         - labels[name]).mean()
    if self._predict_stop_state and STOP_STATE_KEY in labels:
      pred = torch.argmax(inference_outputs[STOP_STATE_KEY][:, 0], dim=-1)
      metrics["stop_state_accuracy"] = (
          pred == labels[STOP_STATE_KEY].to(pred.dtype)).to(
              torch.float32).mean()
    if self._gripper_metrics_component and "present_gripper" in features:
      present = collectives.all_gather_batch(
          features["present_gripper"], collectives.current_batch_group())
      metrics.update(self._gripper_metrics({"present_gripper": present},
                                           labels, inference_outputs))
    return metrics
