"""VRGripper: episode-structured behavioural cloning (MSE and MDN heads),
TEC embeddings, the domain-adaptive learned-loss model for MAML and the
Watch-Try-Learn trial and retrial models.

Counterpart of `tensor2robot_tpu.research.vrgripper.models`:

* `VRGripperPreprocessor`: crop, resize and photometric distortion of
  [B, T, H, W, C] episode image stacks. Call n draws from a
  `torch.Generator` seeded `seed + n` (`draws`, which a test may
  override to inject the JAX package's); tensors stay on their device;
* `VRGripperRegressionModel`: a per-frame spatial-softmax `BerkeleyNet`
  torso, then an MSE head (`fc`, `action`) or an MDN head (`mdn`) over
  [B, T] frames; `WTLTrialModel` adds its optional trial specs;
* `VRGripperTECModel`: a demo episode embedded by `EmbedEpisode` and a
  frame -> action head, with the triplet loss on an optional `task_id`;
* `VRGripperDomainAdaptiveModel`: `inner=True` (MAML's
  `inner_loop_forward_kwargs`) conditions on video only (the pose zeroed
  or predicted by `pose_fc`/`pose_ln`/`pose_out`); `inner_loop_loss_fn`
  is the learned loss, a conv1d stack over the episode (`ll_conv_{i}`,
  kernel 10, TF 'SAME' padding: 4 before and 5 after, no bias;
  `ll_ln_{i}`; `ll_conv_out`);
* `WTLStateTrialModel` and `WTLVisionTrialModel` over the meta layout,
  and the numpy helpers `make_fixed_length`, `pack_wtl_meta_features`,
  `episode_to_transitions` (copies of the JAX package's), with
  `discretize_actions` / `undiscretize_actions`.

Module names are flax's, so `bridge.py` carries a JAX tree across. MDN
parameters travel in the output dict as `mdn_params/logits`, `/means` and
`/scales` (`layers.mdn.as_outputs`); `model_train_fn` rebuilds them.

Deviation forced by torch's eager parameters: the JAX episode network
appends `gripper_pose` to the head's input whenever a batch carries it
(the feature is optional, and the random input generator makes none);
here `use_gripper_pose` says so up front, and a batch that disagrees with
it raises.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tensor2robot_tpu_torch import modes as modes_lib
from tensor2robot_tpu_torch import specs as specs_lib
from tensor2robot_tpu_torch.layers import flax_layers
from tensor2robot_tpu_torch.layers import mdn as mdn_lib
from tensor2robot_tpu_torch.layers import tec as tec_lib
from tensor2robot_tpu_torch.layers import vision
from tensor2robot_tpu_torch.meta_learning import batch_utils
from tensor2robot_tpu_torch.meta_learning import maml as maml_lib
from tensor2robot_tpu_torch.meta_learning import preprocessors as meta_pre
from tensor2robot_tpu_torch.models import abstract as abstract_model
from tensor2robot_tpu_torch.parallel import collectives
from tensor2robot_tpu_torch.ops.image_norm import normalize_image
from tensor2robot_tpu_torch.preprocessors import base as preprocessors_lib
from tensor2robot_tpu_torch.preprocessors import image_ops
from tensor2robot_tpu_torch.specs import SpecStruct, TensorSpec
from tensor2robot_tpu_torch.utils import config

__all__ = ["VRGripperPreprocessor", "VRGripperRegressionModel",
           "VRGripperDomainAdaptiveModel", "VRGripperTECModel",
           "WTLTrialModel", "WTLStateTrialModel", "WTLVisionTrialModel",
           "pack_wtl_meta_features", "make_fixed_length",
           "discretize_actions", "undiscretize_actions",
           "episode_to_transitions"]

LAYER_NORM_EPSILON = 1e-6  # flax's default
POSE_SIZE = 7
HIDDEN = 128               # the episode and TEC action heads
WTL_HIDDEN = 100           # the WTL heads' fc1
POSE_HIDDEN = 40           # the condition-pose head
LL_KERNEL = 10             # the learned loss's conv1d width


def _dense(x: torch.Tensor, layer: nn.Linear) -> torch.Tensor:
  """flax `nn.Dense`: in the promoted dtype of input and weights."""
  return flax_layers.dense(x, layer.weight, layer.bias)


def _layer_norm(x: torch.Tensor, norm: nn.LayerNorm) -> torch.Tensor:
  return flax_layers.layer_norm(x, norm.weight, norm.bias,
                                LAYER_NORM_EPSILON, dim=-1)


def _frames(net: nn.Module, images: torch.Tensor, train: bool
            ) -> torch.Tensor:
  """A per-image tower over the dims before [H, W, C]. The towers here
  use layer norm, so they return no new state."""
  return batch_utils.multi_batch_apply(
      lambda flat: net(flat, train=train)[0], images.ndim - 3, images)


def _episode_torso(num_feature_points: int,
                   dtype: Optional[torch.dtype]) -> vision.BerkeleyNet:
  return vision.BerkeleyNet(3, filters=(num_feature_points,),
                            kernel_sizes=(5,), strides=(2,), dtype=dtype)


def _mdn_outputs(params: mdn_lib.MDNParams) -> SpecStruct:
  outputs = SpecStruct(mdn_lib.as_outputs(params))
  outputs["action"] = mdn_lib.mdn_approximate_mode(params)
  return outputs


@config.configurable
class VRGripperPreprocessor(preprocessors_lib.SpecTransformationPreprocessor):
  """Crop/resize/distort over episode image stacks: the wire image is
  uint8 at `input_size`; training crops at random (at `input_size`, so
  the offset is 0) and distorts, eval crops the center; both resize to
  `model_size`."""

  def __init__(self, input_size: Tuple[int, int] = (64, 64),
               model_size: Tuple[int, int] = (48, 48), seed: int = 0,
               **kwargs):
    super().__init__(**kwargs)
    self._input_size = tuple(input_size)
    self._model_size = tuple(model_size)
    self._seed = seed
    self._calls = 0

  def update_in_spec(self, spec, key):
    if key == "image":
      return spec.replace(shape=spec.shape[:1] + self._input_size
                          + (spec.shape[-1],), dtype=np.uint8)
    return spec

  def draws(self, seed: int, image_shape: Tuple[int, ...],
            is_training: bool) -> image_ops.Draws:
    """One call's draws for the [B * T, H, W, C] frames (CPU tensors),
    from a generator seeded `seed`."""
    return image_ops.draw_crop_resize_distort(
        torch.Generator().manual_seed(seed), image_shape, self._input_size,
        self._model_size, is_training=is_training)

  def _preprocess_fn(self, features, labels, mode):
    features = specs_lib.flatten_spec_structure(features)
    self._calls += 1
    is_training = mode == modes_lib.TRAIN
    image = features["image"]  # [B, T, H, W, C]
    b, t = image.shape[:2]
    flat = image.reshape((b * t,) + tuple(image.shape[2:]))
    out = image_ops.crop_resize_distort(
        flat, self._input_size, self._model_size, is_training=is_training,
        draws=self.draws(self._seed + self._calls, tuple(flat.shape),
                         is_training))
    features["image"] = out.reshape((b, t) + tuple(out.shape[1:])).to(
        torch.float32)
    return features, labels


class _EpisodeRegressionNet(nn.Module):
  """Per-frame spatial-softmax torso -> action head (MDN or MSE)."""

  def __init__(self, action_size: int = 7, num_mixture_components: int = 0,
               num_feature_points: int = 32, use_gripper_pose: bool = False,
               dtype: Optional[torch.dtype] = None):
    super().__init__()
    self.num_mixture_components = num_mixture_components
    self.use_gripper_pose = use_gripper_pose
    self.dtype = dtype
    self.torso = _episode_torso(num_feature_points, dtype)
    width = 2 * num_feature_points + (POSE_SIZE if use_gripper_pose else 0)
    if num_mixture_components:
      self.mdn = mdn_lib.MDNHead(width, num_mixture_components, action_size)
    else:
      self.fc = nn.Linear(width, HIDDEN)
      self.action = nn.Linear(HIDDEN, action_size)

  def forward(self, features, mode: str = modes_lib.TRAIN,
              train: bool = False):
    image = normalize_image(features["image"], self.dtype)  # [B,T,H,W,C]
    x = _frames(self.torso, image, train)
    if ("gripper_pose" in features) != self.use_gripper_pose:
      raise ValueError(
          f"the network was built with use_gripper_pose="
          f"{self.use_gripper_pose}, and the batch "
          f"{'carries' if 'gripper_pose' in features else 'lacks'} "
          "gripper_pose")
    if self.use_gripper_pose:
      x = torch.cat([x, features["gripper_pose"].to(x.dtype)], dim=-1)
    if self.num_mixture_components:
      outputs = _mdn_outputs(self.mdn(x))
    else:
      outputs = SpecStruct({"action": _dense(
          F.relu(_dense(x, self.fc)), self.action)})
    outputs["inference_output"] = outputs["action"]
    return outputs, {}


@config.configurable
class VRGripperRegressionModel(abstract_model.T2RModel):
  """Episode BC: [B, T] frames -> [B, T] actions, MSE or MDN likelihood."""

  def __init__(self, episode_length: int = 8, image_size: int = 48,
               action_size: int = 7, num_mixture_components: int = 0,
               use_gripper_pose: bool = False, **kwargs):
    kwargs.setdefault("preprocessor_cls", None)
    super().__init__(**kwargs)
    self._episode_length = episode_length
    self._image_size = image_size
    self._action_size = action_size
    self._num_mixture_components = num_mixture_components
    self._use_gripper_pose = use_gripper_pose

  def get_feature_specification(self, mode):
    return SpecStruct({
        "image": TensorSpec(
            shape=(self._episode_length, self._image_size,
                   self._image_size, 3),
            dtype=np.float32, name="image", data_format="jpeg",
            is_sequence=False),
        "gripper_pose": TensorSpec(
            shape=(self._episode_length, POSE_SIZE), dtype=np.float32,
            name="gripper_pose", is_optional=True),
    })

  def get_label_specification(self, mode):
    return SpecStruct({
        "action": TensorSpec(shape=(self._episode_length,
                                    self._action_size),
                             dtype=np.float32, name="action"),
    })

  def create_module(self):
    return _EpisodeRegressionNet(
        action_size=self._action_size,
        num_mixture_components=self._num_mixture_components,
        use_gripper_pose=self._use_gripper_pose,
        dtype=self.compute_dtype if self.use_bfloat16 else None)

  def model_train_fn(self, features, labels, inference_outputs, mode):
    target = labels["action"]
    if self._num_mixture_components:
      params = mdn_lib.from_outputs(inference_outputs)
      loss = -mdn_lib.mdn_log_prob(params, target).mean()
      return loss, {"nll": loss}
    loss = torch.mean((inference_outputs["action"] - target) ** 2)
    return loss, {"mse": loss}

  def model_eval_fn(self, features, labels, inference_outputs):
    loss, scalars = self.model_train_fn(
        features, labels, inference_outputs, modes_lib.EVAL)
    mae = torch.abs(inference_outputs["action"] - labels["action"]).mean()
    return {"loss": loss, "mae": mae, **scalars}


class _TECNetwork(nn.Module):
  """Demo episode -> task embedding; frame + embedding -> action."""

  def __init__(self, obs_size: int, action_size: int = 7,
               embedding_size: int = 32):
    super().__init__()
    self.embed = tec_lib.EmbedEpisode(obs_size, embedding_size=embedding_size)
    self.fc1 = nn.Linear(obs_size + embedding_size, HIDDEN)
    self.action = nn.Linear(HIDDEN, action_size)

  def forward(self, features, mode: str = modes_lib.TRAIN,
              train: bool = False):
    embedding = self.embed(features["demo_frames"], train=train)  # [B, E]
    x = torch.cat([features["observation"], embedding], dim=-1)
    action = _dense(F.relu(_dense(x, self.fc1)), self.action)
    return SpecStruct({"action": action, "inference_output": action,
                       "task_embedding": embedding}), {}


@config.configurable
class VRGripperTECModel(abstract_model.T2RModel):
  """Task-embedded control: demo-conditioned BC with a triplet loss on
  the embedding where the labels carry a `task_id`."""

  def __init__(self, demo_length: int = 8, obs_size: int = 16,
               action_size: int = 7, embedding_size: int = 32,
               embedding_loss_weight: float = 0.1, **kwargs):
    super().__init__(**kwargs)
    self._demo_length = demo_length
    self._obs_size = obs_size
    self._action_size = action_size
    self._embedding_size = embedding_size
    self._embedding_loss_weight = embedding_loss_weight

  def get_feature_specification(self, mode):
    return SpecStruct({
        "demo_frames": TensorSpec(shape=(self._demo_length,
                                         self._obs_size),
                                  dtype=np.float32, name="demo_frames"),
        "observation": TensorSpec(shape=(self._obs_size,),
                                  dtype=np.float32, name="observation"),
    })

  def get_label_specification(self, mode):
    return SpecStruct({
        "action": TensorSpec(shape=(self._action_size,), dtype=np.float32,
                             name="action"),
        "task_id": TensorSpec(shape=(), dtype=np.int64, name="task_id",
                              is_optional=True),
    })

  def create_module(self):
    return _TECNetwork(self._obs_size, action_size=self._action_size,
                       embedding_size=self._embedding_size)

  def model_train_fn(self, features, labels, inference_outputs, mode):
    bc = torch.mean((inference_outputs["action"] - labels["action"]) ** 2)
    scalars = {"bc_mse": bc}
    loss = bc
    if "task_id" in labels and labels["task_id"] is not None:
      # Semihard mining compares every row with every other, so on a data
      # split the triplet term reads the whole batch (gathered
      # differentiably), as the global batch's loss does; the BC term is
      # a mean over equal blocks.
      group = collectives.current_batch_group()
      emb_loss = tec_lib.triplet_semihard_loss(
          collectives.all_gather_batch(inference_outputs["task_embedding"],
                                       group),
          collectives.all_gather_batch(labels["task_id"].to(torch.int32),
                                       group))
      scalars["embedding_triplet"] = emb_loss
      loss = loss + self._embedding_loss_weight * emb_loss
    return loss, scalars


@config.configurable
class WTLTrialModel(VRGripperRegressionModel):
  """Watch-Try-Learn trial policy's specs: the episode model plus the
  prior trial's optional frames and rewards."""

  def __init__(self, trial_length: int = 8, **kwargs):
    super().__init__(**kwargs)
    self._trial_length = trial_length

  def get_feature_specification(self, mode):
    out = super().get_feature_specification(mode)
    out["trial_frames"] = TensorSpec(
        shape=(self._trial_length, self._image_size, self._image_size, 3),
        dtype=np.float32, name="trial_frames", is_optional=True)
    out["trial_rewards"] = TensorSpec(
        shape=(self._trial_length, 1), dtype=np.float32,
        name="trial_rewards", is_optional=True)
    return out


class _DANetwork(nn.Module):
  """Domain-adaptive imitation net with a learned inner-loop loss.

  `forward(..., inner=True)` is the adaptation forward: the pose input is
  zeroed (or predicted from the feature points with
  `predict_con_gripper_pose`); the outer forward sees the real pose. The
  condition-pose head's parameters exist either way. The learned loss
  runs a conv1d stack over the episode on [ll_action, feature points,
  action]: the mean over the batch of the sum over (time, channels) of
  its squared output."""

  def __init__(self, action_size: int = 7, num_feature_points: int = 32,
               predict_con_gripper_pose: bool = False,
               learned_loss_conv1d_layers: Optional[Sequence[int]]
               = (10, 10, 6),
               dtype: Optional[torch.dtype] = None):
    super().__init__()
    self.predict_con_gripper_pose = predict_con_gripper_pose
    self.learned_loss_conv1d_layers = (
        None if learned_loss_conv1d_layers is None
        else tuple(learned_loss_conv1d_layers))
    self.dtype = dtype
    points = 2 * num_feature_points
    self.torso = _episode_torso(num_feature_points, dtype)
    self.pose_fc = nn.Linear(points, POSE_HIDDEN, bias=False)
    self.pose_ln = nn.LayerNorm(POSE_HIDDEN)
    self.pose_out = nn.Linear(POSE_HIDDEN, POSE_SIZE)
    self.fc = nn.Linear(points + POSE_SIZE, HIDDEN)
    self.action = nn.Linear(HIDDEN, action_size)
    self.ll_fc = nn.Linear(points, HIDDEN)
    self.ll_action = nn.Linear(HIDDEN, action_size)
    if self.learned_loss_conv1d_layers is not None:
      width = 2 * action_size + points
      for i, filters in enumerate(self.learned_loss_conv1d_layers[:-1]):
        self.add_module(f"ll_conv_{i}", nn.Conv1d(width, filters, LL_KERNEL,
                                                  bias=False))
        self.add_module(f"ll_ln_{i}", nn.LayerNorm(filters))
        width = filters
      self.ll_conv_out = nn.Conv1d(width,
                                   self.learned_loss_conv1d_layers[-1], 1)

  def forward(self, features, mode: str = modes_lib.TRAIN,
              train: bool = False, inner: bool = False):
    image = normalize_image(features["image"], self.dtype)  # [B,T,H,W,C]
    pose = features["gripper_pose"]
    feature_points = _frames(self.torso, image, train)
    pred = _layer_norm(F.relu(_dense(feature_points, self.pose_fc)),
                       self.pose_ln)
    predicted_pose = _dense(pred, self.pose_out)
    if inner:
      used_pose = (predicted_pose if self.predict_con_gripper_pose
                   else torch.zeros_like(pose))
    else:
      used_pose = pose
    x = torch.cat([feature_points, used_pose.to(feature_points.dtype)],
                  dim=-1)
    action = _dense(F.relu(_dense(x, self.fc)), self.action)
    ll_action = _dense(F.relu(_dense(feature_points, self.ll_fc)),
                       self.ll_action)
    if self.learned_loss_conv1d_layers is None:
      learned_loss = torch.mean((ll_action - action) ** 2)
    else:
      net = torch.cat([ll_action, feature_points, action], dim=-1)
      for i in range(len(self.learned_loss_conv1d_layers) - 1):
        net = flax_layers.conv1d_same(net,
                                      getattr(self, f"ll_conv_{i}").weight)
        net = _layer_norm(F.relu(net), getattr(self, f"ll_ln_{i}"))
      net = flax_layers.conv1d_same(net, self.ll_conv_out.weight,
                                    self.ll_conv_out.bias)
      learned_loss = torch.mean(torch.sum(torch.square(net), dim=(-2, -1)))
    return SpecStruct({
        "action": action,
        "inference_output": action,
        "feature_points": feature_points,
        "predicted_pose": predicted_pose,
        "learned_loss": learned_loss,
    }), {}


@config.configurable
class VRGripperDomainAdaptiveModel(VRGripperRegressionModel):
  """Learned-loss domain-adaptive imitation, to sit under `MAMLModel`:
  the inner loop runs the forward with `inner=True` (video only) and
  adapts against `inner_loop_loss_fn` (the learned loss, no labels); the
  outer loop's BC loss on the real pose meta-trains the learned loss."""

  def __init__(self, predict_con_gripper_pose: bool = False,
               learned_loss_conv1d_layers: Optional[Tuple[int, ...]]
               = (10, 10, 6),
               outer_loss_multiplier: float = 1.0, **kwargs):
    kwargs.setdefault("num_mixture_components", 0)
    super().__init__(**kwargs)
    self._predict_con_gripper_pose = predict_con_gripper_pose
    self._learned_loss_conv1d_layers = learned_loss_conv1d_layers
    self._outer_loss_multiplier = outer_loss_multiplier

  def get_feature_specification(self, mode):
    out = super().get_feature_specification(mode)
    # The condition-pose path needs the pose feature present (zeroed in
    # the inner loop), so it is required here.
    out["gripper_pose"] = out["gripper_pose"].replace(is_optional=False)
    return out

  def create_module(self):
    return _DANetwork(
        action_size=self._action_size,
        predict_con_gripper_pose=self._predict_con_gripper_pose,
        learned_loss_conv1d_layers=self._learned_loss_conv1d_layers,
        dtype=self.compute_dtype if self.use_bfloat16 else None)

  # -- MAML hooks (meta_learning/maml.py) ------------------------------------

  @property
  def inner_loop_forward_kwargs(self):
    return {"inner": True}

  def inner_loop_loss_fn(self, features, labels, inference_outputs, mode):
    del features, labels, mode
    return inference_outputs["learned_loss"]

  def model_train_fn(self, features, labels, inference_outputs, mode):
    loss = torch.mean((inference_outputs["action"] - labels["action"]) ** 2)
    loss = self._outer_loss_multiplier * loss
    return loss, {"bc_mse": loss}


# -- Watch-Try-Learn -----------------------------------------------------------


def _wtl_head_outputs(owner: nn.Module, fc_inputs: torch.Tensor
                      ) -> SpecStruct:
  """The shared WTL head over [B, I, T, D] inputs: the module's own
  `fc1`, `ln1` and `mdn` or `action` (flax names them at the network's
  top level)."""
  h = _layer_norm(F.relu(_dense(fc_inputs, owner.fc1)), owner.ln1)
  if owner.num_mixture_components > 1:
    outputs = _mdn_outputs(owner.mdn(h))
  else:
    outputs = SpecStruct({"action": _dense(h, owner.action)})
  outputs["inference_output"] = outputs["action"]
  return outputs


def _add_wtl_head(owner: nn.Module, in_features: int, action_size: int,
                  num_mixture_components: int) -> None:
  owner.num_mixture_components = num_mixture_components
  owner.fc1 = nn.Linear(in_features, WTL_HIDDEN)
  owner.ln1 = nn.LayerNorm(WTL_HIDDEN)
  if num_mixture_components > 1:
    owner.mdn = mdn_lib.MDNHead(WTL_HIDDEN, num_mixture_components,
                                action_size)
  else:
    owner.action = nn.Linear(WTL_HIDDEN, action_size)


class _WTLStateTrialNetwork(nn.Module):
  """Low-dim WTL trial/retrial policy net over the meta layout:
  condition/{features,labels} with a per-task episode dim E (1 trial, 2
  retrial: demo and prior trial) and inference/features with episode dim
  I. The demo is embedded by a learned temporal reduction ('temporal',
  `demo_embedding`) or its final frame ('final'; 'mean' is the
  reference's name for it). The retrial path embeds the prior trial with
  its success labels and the tiled demo embedding ('temporal':
  `trial_embedding`; 'final': per-frame Dense `trial_embedding_fc`, relu,
  mean over time) and feeds the trial success sequence to the head."""

  def __init__(self, obs_size: int, action_size: int = 7,
               fc_embed_size: int = 32, num_mixture_components: int = 1,
               retrial: bool = False, ignore_embedding: bool = False,
               embed_type: str = "temporal"):
    super().__init__()
    self.retrial = retrial
    self.ignore_embedding = ignore_embedding
    self.embed_type = embed_type
    kind = "final" if embed_type == "mean" else embed_type
    if kind not in ("temporal", "final"):
      raise ValueError(f"Invalid embed_type: {embed_type!r}")
    self._kind = kind
    if kind == "temporal":
      self.demo_embedding = tec_lib.TemporalConvEmbedding(obs_size,
                                                          fc_embed_size)
      demo_width = fc_embed_size
    else:
      demo_width = obs_size
    embedding_width = demo_width
    if retrial:
      con_width = obs_size + 1 + demo_width
      if kind == "final":
        self.trial_embedding_fc = nn.Linear(con_width, fc_embed_size)
      else:
        self.trial_embedding = tec_lib.TemporalConvEmbedding(con_width,
                                                             fc_embed_size)
      embedding_width += fc_embed_size
    width = obs_size
    if not ignore_embedding:
      width += embedding_width + (1 if retrial else 0)
    _add_wtl_head(self, width, action_size, num_mixture_components)

  def forward(self, features, mode: str = modes_lib.TRAIN,
              train: bool = False):
    con_state = features["condition/features/full_state_pose"]  # [B,E,T,D]
    con_success = 2.0 * features["condition/labels/success"] - 1.0
    inf_state = features["inference/features/full_state_pose"]  # [B,I,T,D]
    b, num_inference, t = inf_state.shape[:3]
    if self.retrial and con_state.shape[1] != 2:
      raise ValueError(
          f"retrial expects 2 condition episodes, got {con_state.shape[1]}")
    demo = con_state[:, 0]  # [B, T, D]
    if self._kind == "temporal":
      demo_emb = self.demo_embedding(demo)
    else:
      demo_emb = demo[:, -1]
    fc_embedding = demo_emb
    if self.retrial:
      trial = con_state[:, 1]            # [B, T, D]
      trial_success = con_success[:, 1]  # [B, T, 1]
      demo_tiled = demo_emb[:, None, :].expand(b, t, demo_emb.shape[-1])
      con_input = torch.cat([trial, trial_success, demo_tiled], dim=-1)
      if self._kind == "final":
        trial_emb = F.relu(_dense(con_input, self.trial_embedding_fc)).mean(
            dim=-2)
      else:
        trial_emb = self.trial_embedding(con_input)
      fc_embedding = torch.cat([demo_emb, trial_emb], dim=-1)
    emb_tiled = fc_embedding[:, None, None, :].expand(
        b, num_inference, t, fc_embedding.shape[-1])
    if self.ignore_embedding:
      fc_inputs = inf_state
    else:
      parts = [inf_state, emb_tiled]
      if self.retrial:
        parts.append(con_success[:, 1][:, None].expand(b, num_inference, t,
                                                      1))
      fc_inputs = torch.cat(parts, dim=-1)
    return _wtl_head_outputs(self, fc_inputs), {}


class _WTLVisionTrialNetwork(nn.Module):
  """Vision WTL trial/retrial policy net: the condition frames (demo and
  trial) share one `EmbedConditionImages` tower (`image_embedding`: conv
  tower, spatial softmax, fc head `embed_fc_layers`); the inference
  frames have a separate `BerkeleyNet` (`state_features`). The demo's
  per-frame features and pose reduce to a task embedding
  (`fc_demo_reduce`); with 2+ condition episodes the prior trial, its
  success and the demo embedding reduce to a second (`fc_trial_reduce`)."""

  def __init__(self, action_size: int = 7, fc_embed_size: int = 32,
               num_feature_points: int = 32,
               embed_fc_layers: Optional[Sequence[int]] = (100, 64),
               num_mixture_components: int = 1,
               num_condition_episodes: int = 1,
               ignore_embedding: bool = False, pose_size: int = POSE_SIZE,
               dtype: Optional[torch.dtype] = None):
    super().__init__()
    self.num_condition_episodes = num_condition_episodes
    self.ignore_embedding = ignore_embedding
    self.dtype = dtype
    conv_filters = (64, 32, num_feature_points)
    self.image_embedding = tec_lib.EmbedConditionImages(
        3, fc_layers=embed_fc_layers, filters=conv_filters, dtype=dtype)
    self.state_features = vision.BerkeleyNet(3, filters=conv_filters,
                                             dtype=dtype)
    cond_width = (embed_fc_layers[-1] if embed_fc_layers
                  else 2 * num_feature_points)
    self.fc_demo_reduce = tec_lib.TemporalConvEmbedding(
        cond_width + pose_size, fc_embed_size)
    embedding_width = fc_embed_size
    if num_condition_episodes > 1:
      self.fc_trial_reduce = tec_lib.TemporalConvEmbedding(
          cond_width + pose_size + 1 + fc_embed_size, fc_embed_size)
      embedding_width += fc_embed_size
    width = 2 * num_feature_points + pose_size
    if not ignore_embedding:
      width += embedding_width
    _add_wtl_head(self, width, action_size, num_mixture_components)

  def forward(self, features, mode: str = modes_lib.TRAIN,
              train: bool = False):
    con_images = features["condition/features/image"]  # [B,E,T,H,W,C]
    con_pose = features["condition/features/gripper_pose"]  # [B,E,T,P]
    con_success = 2.0 * features["condition/labels/success"] - 1.0
    inf_images = features["inference/features/image"]  # [B,I,T,H,W,C]
    inf_pose = features["inference/features/gripper_pose"]
    con_images = normalize_image(con_images, self.dtype)
    inf_images = normalize_image(inf_images, self.dtype)
    b, num_inference, t = inf_images.shape[:3]

    demo_fp = _frames(self.image_embedding, con_images[:, 0], train)
    demo_in = torch.cat([demo_fp, con_pose[:, 0].to(demo_fp.dtype)], dim=-1)
    embedding = self.fc_demo_reduce(demo_in)
    if self.num_condition_episodes > 1:
      trial_fp = _frames(self.image_embedding, con_images[:, 1], train)
      demo_tiled = embedding[:, None, :].expand(b, t, embedding.shape[-1])
      trial_in = torch.cat([
          trial_fp, con_pose[:, 1].to(trial_fp.dtype),
          con_success[:, 1].to(trial_fp.dtype), demo_tiled], dim=-1)
      embedding = torch.cat([embedding, self.fc_trial_reduce(trial_in)],
                            dim=-1)
    state_features = _frames(self.state_features, inf_images, train)
    emb_tiled = embedding[:, None, None, :].expand(
        b, num_inference, t, embedding.shape[-1])
    parts = [state_features, inf_pose.to(state_features.dtype)]
    if not self.ignore_embedding:
      parts.append(emb_tiled.to(state_features.dtype))
    return _wtl_head_outputs(self, torch.cat(parts, dim=-1)), {}


class _WTLModelBase(abstract_model.T2RModel):
  """Shared spec and loss scaffolding of the WTL trial and retrial
  models: model inputs are the meta layout (`create_maml_feature_spec`
  over the episode specs); the wire format is `<prefix>_ep<i>/` columns,
  which the model's preprocessor (`FixedLenMetaExamplePreprocessor`)
  stacks."""

  def __init__(self, action_size: int = 7, episode_length: int = 8,
               fc_embed_size: int = 32, num_mixture_components: int = 1,
               num_condition_episodes: int = 1, ignore_embedding: bool = False,
               **kwargs):
    kwargs.setdefault("preprocessor_cls", None)
    super().__init__(**kwargs)
    self._action_size = action_size
    self._episode_length = episode_length
    self._fc_embed_size = fc_embed_size
    self._num_mixture_components = num_mixture_components
    self._num_condition_episodes = num_condition_episodes
    self._ignore_embedding = ignore_embedding

  def _episode_feature_specification(self, mode) -> SpecStruct:
    raise NotImplementedError

  def _episode_label_specification(self, mode) -> SpecStruct:
    return SpecStruct({
        "action": TensorSpec(
            shape=(self._episode_length, self._action_size),
            dtype=np.float32, name="action"),
        "success": TensorSpec(
            shape=(self._episode_length, 1), dtype=np.float32,
            name="success"),
    })

  @property
  def num_condition_episodes(self) -> int:
    return self._num_condition_episodes

  @property
  def preprocessor(self):
    """ep-column wire format -> meta layout."""
    if self._preprocessor is None:
      base = preprocessors_lib.NoOpPreprocessor(
          model_feature_specification_fn=self._episode_feature_specification,
          model_label_specification_fn=self._episode_label_specification)
      preprocessor = meta_pre.FixedLenMetaExamplePreprocessor(
          base_preprocessor=base,
          num_condition_episodes=self._num_condition_episodes)
      if self._use_bfloat16:
        preprocessor = preprocessors_lib.Bfloat16DevicePolicy(preprocessor)
      self._preprocessor = preprocessor
    return self._preprocessor

  def get_feature_specification(self, mode):
    return maml_lib.create_maml_feature_spec(
        self._episode_feature_specification(mode),
        self._episode_label_specification(mode),
        num_condition_samples=self._num_condition_episodes,
        num_inference_samples=1)

  def get_label_specification(self, mode):
    return maml_lib.create_maml_label_spec(
        self._episode_label_specification(mode), num_inference_samples=1)

  def model_train_fn(self, features, labels, inference_outputs, mode):
    target = labels["action"]
    if self._num_mixture_components > 1:
      params = mdn_lib.from_outputs(inference_outputs)
      bc_loss = -mdn_lib.mdn_log_prob(params, target).mean()
      return bc_loss, {"bc_nll": bc_loss}
    bc_loss = torch.mean((inference_outputs["action"] - target) ** 2)
    return bc_loss, {"bc_mse": bc_loss}

  def model_eval_fn(self, features, labels, inference_outputs):
    loss, scalars = self.model_train_fn(
        features, labels, inference_outputs, modes_lib.EVAL)
    mae = torch.abs(inference_outputs["action"] - labels["action"]).mean()
    return {"loss": loss, "mae": mae, **scalars}

  def pack_features(self, state, prev_episode_data, timestep):
    raise NotImplementedError


@config.configurable
class WTLStateTrialModel(_WTLModelBase):
  """WTL low-dim trial (retrial=False) / retrial (retrial=True) model."""

  def __init__(self, obs_size: int = 32, retrial: bool = False,
               embed_type: str = "temporal", **kwargs):
    if retrial:
      kwargs["num_condition_episodes"] = 2
    super().__init__(**kwargs)
    self._obs_size = obs_size
    self._retrial = retrial
    self._embed_type = embed_type

  def _episode_feature_specification(self, mode):
    del mode
    return SpecStruct({
        "full_state_pose": TensorSpec(
            shape=(self._episode_length, self._obs_size),
            dtype=np.float32, name="full_state_pose"),
    })

  def create_module(self):
    return _WTLStateTrialNetwork(
        self._obs_size, action_size=self._action_size,
        fc_embed_size=self._fc_embed_size,
        num_mixture_components=self._num_mixture_components,
        retrial=self._retrial, ignore_embedding=self._ignore_embedding,
        embed_type=self._embed_type)

  def pack_features(self, state, prev_episode_data, timestep):
    return pack_wtl_meta_features(
        state, prev_episode_data, timestep, self._episode_length,
        self._num_condition_episodes, vision=False)


@config.configurable
class WTLVisionTrialModel(_WTLModelBase):
  """WTL vision trial/retrial model; retrial behaviour turns on with
  num_condition_episodes > 1."""

  def __init__(self, image_size: int = 48, pose_size: int = POSE_SIZE,
               num_feature_points: int = 32,
               embed_fc_layers: Optional[Tuple[int, ...]] = (100, 64),
               **kwargs):
    super().__init__(**kwargs)
    self._image_size = image_size
    self._pose_size = pose_size
    self._num_feature_points = num_feature_points
    self._embed_fc_layers = embed_fc_layers

  def _episode_feature_specification(self, mode):
    del mode
    return SpecStruct({
        "image": TensorSpec(
            shape=(self._episode_length, self._image_size,
                   self._image_size, 3),
            dtype=np.float32, name="image", data_format="jpeg"),
        "gripper_pose": TensorSpec(
            shape=(self._episode_length, self._pose_size),
            dtype=np.float32, name="gripper_pose"),
    })

  def create_module(self):
    return _WTLVisionTrialNetwork(
        action_size=self._action_size,
        fc_embed_size=self._fc_embed_size,
        num_feature_points=self._num_feature_points,
        embed_fc_layers=self._embed_fc_layers,
        num_mixture_components=self._num_mixture_components,
        num_condition_episodes=self._num_condition_episodes,
        ignore_embedding=self._ignore_embedding, pose_size=self._pose_size,
        dtype=self.compute_dtype if self.use_bfloat16 else None)

  def pack_features(self, state, prev_episode_data, timestep):
    return pack_wtl_meta_features(
        state, prev_episode_data, timestep, self._episode_length,
        self._num_condition_episodes, vision=True)


def make_fixed_length(episode_data, fixed_length: int,
                      randomized: bool = False, rng=None):
  """Subsamples/pads a list of per-step transition tuples to
  fixed_length."""
  n = len(episode_data)
  if n == 0:
    raise ValueError("episode_data is empty")
  if n == fixed_length:
    return list(episode_data)
  if randomized:
    rng = rng or np.random
    if n > fixed_length:
      idx = np.sort(rng.choice(n, size=fixed_length, replace=False))
    else:
      idx = np.sort(rng.choice(n, size=fixed_length, replace=True))
  else:
    idx = np.linspace(0, n - 1, fixed_length).round().astype(int)
  return [episode_data[i] for i in idx]


def pack_wtl_meta_features(state, prev_episode_data, timestep,
                           fixed_length: int,
                           num_condition_episodes: int,
                           vision: bool = False,
                           deterministic_condition: bool = True
                           ) -> SpecStruct:
  """Packs the current observation and prior episodes into the meta
  layout (numpy).

  `state` carries `.image`/`.pose` (vision) or `.full_state_pose`;
  `prev_episode_data` is a list of episodes, each a list of (obs,
  action, reward, ...) transition tuples: episode 0 the demo, episode 1
  the first trial. Every leaf has leading [1 (task), E or I,
  fixed_length] dims, the models' input layout, fed through a
  predictor's `predict_preprocessed` (WTLPolicy does this)."""
  del timestep
  if len(prev_episode_data) < 1:
    raise ValueError(
        "prev_episode_data should at least contain one (demo) episode.")
  out = SpecStruct()

  def _as_image(x):
    """uint8 camera frames -> the [0, 1] float32 range the models train
    on."""
    x = np.asarray(x)
    if np.issubdtype(x.dtype, np.integer):
      return x.astype(np.float32) / 255.0
    return x.astype(np.float32)

  def _tile_inference(x):
    return np.tile(np.asarray(x), [fixed_length] + [1] * np.ndim(x))

  if vision:
    out["inference/features/image"] = _as_image(
        _tile_inference(state.image))[None, None]
    out["inference/features/gripper_pose"] = _tile_inference(
        state.pose)[None, None].astype(np.float32)
  else:
    out["inference/features/full_state_pose"] = _tile_inference(
        state.full_state_pose)[None, None].astype(np.float32)

  con_obs, con_pose, con_actions, con_success = [], [], [], []
  for i in range(num_condition_episodes):
    episode = prev_episode_data[i % len(prev_episode_data)]
    episode = make_fixed_length(
        episode, fixed_length, randomized=not deterministic_condition)
    if vision:
      con_obs.append(np.stack([t[0].image for t in episode]))
      con_pose.append(np.stack([t[0].pose for t in episode]))
    else:
      con_obs.append(np.stack([t[0].full_state_pose for t in episode]))
    con_actions.append(np.stack([np.asarray(t[1], np.float32)
                                 for t in episode]))
    cumulative_return = float(np.sum([t[2] for t in episode]))
    con_success.append(
        float(cumulative_return > 0) * np.ones((fixed_length, 1),
                                               np.float32))
  if vision:
    out["condition/features/image"] = _as_image(np.stack(con_obs))[None]
    out["condition/features/gripper_pose"] = np.stack(con_pose)[None].astype(
        np.float32)
  else:
    out["condition/features/full_state_pose"] = np.stack(
        con_obs)[None].astype(np.float32)
  out["condition/labels/action"] = np.stack(con_actions)[None]
  out["condition/labels/success"] = np.stack(con_success)[None]
  return out


# -- discrete action binning ---------------------------------------------------


def discretize_actions(actions: torch.Tensor, num_bins: int,
                       low: float = -1.0, high: float = 1.0) -> torch.Tensor:
  """Continuous [low, high] actions -> int32 bin ids."""
  clipped = torch.clamp(actions, low, high)
  scaled = (clipped - low) / (high - low)
  return torch.clamp((scaled * num_bins).to(torch.int32), max=num_bins - 1)


def undiscretize_actions(bins: torch.Tensor, num_bins: int,
                         low: float = -1.0, high: float = 1.0
                         ) -> torch.Tensor:
  """Bin ids -> bin-center continuous values (float32)."""
  return low + (bins.to(torch.float32) + 0.5) / num_bins * (high - low)


def episode_to_transitions(episode, episode_length: int):
  """A fixed-length [T, ...] training example from one episode: frames
  and actions padded (last step repeated) or clipped to
  episode_length."""
  frames = np.stack([step["obs"]["image"] for step in episode])
  actions = np.stack([np.asarray(step["action"], np.float32)
                      for step in episode])
  t = frames.shape[0]
  if t >= episode_length:
    frames, actions = frames[:episode_length], actions[:episode_length]
  else:
    pad = episode_length - t
    frames = np.concatenate(
        [frames, np.repeat(frames[-1:], pad, axis=0)])
    actions = np.concatenate(
        [actions, np.repeat(actions[-1:], pad, axis=0)])
  return {"image": frames, "action": actions}
