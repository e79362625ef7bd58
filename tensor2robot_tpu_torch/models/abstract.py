"""Model protocol: specs, preprocessor, network, loss, optimizer, and the
session-decode seam.

Counterpart of `tensor2robot_tpu.models.abstract`. A model provides
feature/label specs, `create_module()`, an `nn.Module` whose
`forward(features, mode, train)` returns (inference outputs, new mutable
state), `model_train_fn` (loss and scalars) and `create_optimizer()` (a
`models.optimizers.GradientTransformation`; Adam at 1e-4 by default). The
module's own parameters and buffers only give the structure: every
forward runs on a parameter dict and a mutable-state dict (both
`state_dict`-named) through `torch.func.functional_call`, so a predictor
can swap them without touching the module, as the JAX package applies one
flax module to any variable tree. The mutable state is the module's
buffers (batch-norm running statistics, flax's `batch_stats`); a module
returns its new values when `train` is true and {} otherwise.

bfloat16 policy: with `use_bfloat16`, the preprocessor is wrapped in
`Bfloat16DevicePolicy`, features are cast to bfloat16, and
`params_for_compute` casts the float32 parameters to bfloat16 for the
forward (the JAX package's `inference_network_fn` casts its whole
`params` collection the same way; the mutable state stays float32).
"""

from __future__ import annotations

import abc
import math
import threading
from typing import Callable, Dict, Mapping, Optional, Tuple

import torch
from torch import nn

from tensor2robot_tpu_torch import modes as modes_lib
from tensor2robot_tpu_torch import specs as specs_lib
from tensor2robot_tpu_torch.layers import flax_layers
from tensor2robot_tpu_torch.models import optimizers as optimizers_lib
from tensor2robot_tpu_torch.preprocessors import base as preprocessors_lib

__all__ = ["T2RModel", "lecun_normal_"]

Params = Dict[str, torch.Tensor]


def lecun_normal_(weight: torch.Tensor, generator: torch.Generator) -> None:
  """flax's default Dense and Conv kernel init: variance_scaling(1,
  fan_in, truncated_normal), i.e. a normal truncated at two standard
  deviations and rescaled to variance 1/fan_in. `weight` is torch's
  [out, in] or [out, in, kh, kw]: fan_in is in * kh * kw."""
  fan_in = weight[0].numel()
  std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
  nn.init.trunc_normal_(weight, std=std, a=-2 * std, b=2 * std,
                        generator=generator)


class T2RModel(abc.ABC):
  """Base model: specs + network module + loss/optimizer + session-decode
  seam.

  `use_ema` keeps EMA shadow parameters in the train state, updated as
  `e * ema_decay + (1 - ema_decay) * p` after every applied update.
  `remat` recomputes the train step's forward in its backward instead of
  keeping its activations (`torch.utils.checkpoint`). With
  `gradient_accumulation_steps=k` the optimizer is wrapped in
  `optimizers.multi_steps`: gradients are averaged over k micro-batch
  steps and applied on every k-th, so k steps at batch B train like one
  step at batch kB (for a model without batch norm) without holding kB
  activations.

  `init_checkpoint` warm-starts a fresh run (never a resumed one): a
  checkpoint step directory or an export bundle whose same-named,
  same-shaped parameters replace the fresh ones
  (`checkpoints.warm_start_params`). `init_checkpoint_filter(name)`
  returns False for a parameter that stays fresh; it sees the port's
  flat `state_dict` names (`tower.conv1.weight`), not JAX key paths.
  """

  def __init__(self, preprocessor_cls: Optional[Callable] = None,
               optimizer_fn: Optional[Callable] = None,
               use_bfloat16: bool = False,
               use_ema: bool = False,
               ema_decay: float = 0.9999,
               remat: bool = False,
               gradient_accumulation_steps: int = 1,
               init_checkpoint: Optional[str] = None,
               init_checkpoint_filter: Optional[Callable[[str], bool]] = None):
    if gradient_accumulation_steps < 1:
      raise ValueError("gradient_accumulation_steps must be >= 1, got "
                       f"{gradient_accumulation_steps}")
    self._remat = bool(remat)
    self._gradient_accumulation_steps = int(gradient_accumulation_steps)
    self._preprocessor_cls = preprocessor_cls
    self._optimizer_fn = optimizer_fn
    self._use_bfloat16 = use_bfloat16
    self._use_ema = use_ema
    self._ema_decay = ema_decay
    self._init_checkpoint = init_checkpoint
    self._init_checkpoint_filter = init_checkpoint_filter
    self._preprocessor: Optional[preprocessors_lib.AbstractPreprocessor] = None
    self._module: Optional[nn.Module] = None
    # `functional_call` swaps the given tensors into the one module for
    # the call and swaps its own back after: two threads in a forward at
    # once (a batcher's worker and a bypassing CEM sweep) would run on
    # each other's, or the module's own, parameters.
    self._module_lock = threading.RLock()

  @property
  def use_bfloat16(self) -> bool:
    return self._use_bfloat16

  @property
  def use_ema(self) -> bool:
    return self._use_ema

  @property
  def ema_decay(self) -> float:
    return self._ema_decay

  @property
  def remat(self) -> bool:
    return self._remat

  @property
  def gradient_accumulation_steps(self) -> int:
    return self._gradient_accumulation_steps

  @property
  def init_checkpoint(self) -> Optional[str]:
    return self._init_checkpoint

  @property
  def init_checkpoint_filter(self) -> Optional[Callable[[str], bool]]:
    return self._init_checkpoint_filter

  @property
  def preprocessor(self) -> preprocessors_lib.AbstractPreprocessor:
    """Preprocessor wired to this model's specs; bfloat16-wrapped under
    the bfloat16 policy."""
    if self._preprocessor is None:
      cls = self._preprocessor_cls or preprocessors_lib.NoOpPreprocessor
      preprocessor = cls(
          model_feature_specification_fn=self.get_feature_specification,
          model_label_specification_fn=self.get_label_specification)
      if self._use_bfloat16:
        preprocessor = preprocessors_lib.Bfloat16DevicePolicy(preprocessor)
      self._preprocessor = preprocessor
    return self._preprocessor

  @property
  def module(self) -> nn.Module:
    if self._module is not None:  # built: a compiled graph reads it here
      return self._module
    with self._module_lock:
      if self._module is None:
        self._module = self.create_module()
      return self._module

  def _set_mesh_guarded(self, mesh, validate=None) -> None:
    """The shared `set_mesh` plumbing: the module is built for one mesh,
    so a different mesh after it is built raises; `validate(mesh)` runs
    the model's own checks; the mesh is kept on `self._mesh`."""
    if self._module is not None and getattr(self, "_mesh", None) is not mesh:
      raise ValueError("set_mesh must be called before the module is "
                       "built (create_train_state / first forward).")
    if mesh is not None and validate is not None:
      validate(mesh)
    self._mesh = mesh

  @staticmethod
  def _validate_pp_stage_count(mesh, pp_axis: str, num_stages: int,
                               what: str = "trunk",
                               num_virtual_stages: int = 1) -> None:
    """A >1 `pp_axis` must match the pipelined trunk's stage count: the
    schedules place `num_virtual_stages` chunks on each pp rank (one for
    GPipe, v for interleaved 1F1B)."""
    if pp_axis in mesh.shape and mesh.shape[pp_axis] > 1 \
        and mesh.shape[pp_axis] * num_virtual_stages != num_stages:
      raise ValueError(
          f"mesh axis {pp_axis!r} has size {mesh.shape[pp_axis]} and "
          f"num_virtual_stages={num_virtual_stages} but the {what} has "
          f"{num_stages} stages; stages must match ranks x virtual "
          "chunks.")

  def stage_local_axes(self, name: str) -> Tuple[str, ...]:
    """The mesh axes over which the module takes parameter `name` as
    this rank's block, as a mesh state holds it: the train step never
    gathers such a leaf (`parallel.train_step`). () for a parameter the
    module takes whole: every parameter, unless a model says otherwise
    (a pipelined trunk's stage stack, an all-to-all expert stack)."""
    del name
    return ()

  # -- abstract model surface ----------------------------------------------

  @abc.abstractmethod
  def get_feature_specification(self, mode: str) -> specs_lib.SpecStruct:
    ...

  @abc.abstractmethod
  def get_label_specification(self, mode: str) -> specs_lib.SpecStruct:
    ...

  @abc.abstractmethod
  def create_module(self) -> nn.Module:
    """The network; `forward(features, mode, train)` returns (a mapping of
    inference outputs, the new mutable state)."""

  @abc.abstractmethod
  def model_train_fn(self, features, labels, inference_outputs, mode: str
                     ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(loss, scalars) of one batch; outputs arrive in float32."""

  def model_eval_fn(self, features, labels, inference_outputs
                    ) -> Dict[str, torch.Tensor]:
    """Eval metric scalars; defaults to the train loss."""
    loss, scalars = self.model_train_fn(features, labels, inference_outputs,
                                        modes_lib.EVAL)
    return {"loss": loss, **scalars}

  def create_export_outputs_fn(self, features, inference_outputs
                               ) -> Dict[str, torch.Tensor]:
    """Serving outputs; defaults to all inference outputs."""
    if isinstance(inference_outputs, Mapping):
      return dict(inference_outputs.items())
    return {"output": inference_outputs}

  def create_optimizer(self) -> optimizers_lib.GradientTransformation:
    """The optimizer; a configured `optimizer_fn` wins over Adam at 1e-4.
    Subclasses may override; the train step calls `build_optimizer`."""
    fn = self._optimizer_fn or optimizers_lib.create_adam_optimizer
    return fn()

  def build_optimizer(self) -> optimizers_lib.GradientTransformation:
    """`create_optimizer` plus framework wrappers (`multi_steps` when
    `gradient_accumulation_steps > 1`) — the method the train step
    calls. Override `create_optimizer`, not this one, or the wrappers
    are lost."""
    optimizer = self.create_optimizer()
    if self._gradient_accumulation_steps > 1:
      optimizer = optimizers_lib.multi_steps(
          optimizer, self._gradient_accumulation_steps)
    return optimizer

  # -- parameters and forward -----------------------------------------------

  def init_params(self, generator: torch.Generator) -> Params:
    """Fresh parameters with flax's default initializers, drawn from
    `generator` on the CPU: a layer with an `initial_params(generator)`
    method (the LSTM cell, the vision layers) its own parameters (its
    direct ones: its children are visited in turn); else Dense and Conv
    kernels lecun normal (or the layer's own `kernel_init(weight,
    generator)` where the module sets one), zero biases; LayerNorm and
    BatchNorm scale 1, bias 0."""
    params: Params = {}
    for name, module in self.module.named_modules():
      prefix = f"{name}." if name else ""
      if hasattr(module, "initial_params"):  # a layer with its own init
        params.update({prefix + k: v for k, v in
                       module.initial_params(generator).items()})
      elif isinstance(module, (nn.Linear, nn.Conv1d, nn.Conv2d)):
        weight = torch.empty_like(module.weight, device="cpu")
        getattr(module, "kernel_init", lecun_normal_)(weight, generator)
        params[prefix + "weight"] = weight
        if module.bias is not None:
          params[prefix + "bias"] = torch.zeros_like(module.bias,
                                                     device="cpu")
      elif isinstance(module, (nn.LayerNorm, flax_layers.BatchNorm)):
        if module.weight is not None:
          params[prefix + "weight"] = torch.ones_like(module.weight,
                                                      device="cpu")
        params[prefix + "bias"] = torch.zeros_like(module.bias, device="cpu")
    missing = set(dict(self.module.named_parameters())) - set(params)
    if missing:
      raise NotImplementedError(
          f"no initializer for parameters {sorted(missing)}")
    return params

  def init_mutable_state(self) -> Params:
    """The module's buffers at their initial values, on the CPU: batch
    norm's running mean 0 and running variance 1 (flax's batch_stats
    init); {} for a module without buffers."""
    return {k: v.detach().to("cpu", copy=True)
            for k, v in self.module.named_buffers()}

  def params_for_compute(self, params: Params) -> Params:
    """The parameters the forward runs on. Under the bfloat16 policy every
    float32 parameter is cast to bfloat16, so each product runs in bf16
    like the activations (flax promotes a layer to its widest input
    dtype, and the JAX package's `inference_network_fn` casts the whole
    `params` collection); gradients flow back through the cast to the f32
    masters. A model whose layers should see other dtypes overrides
    this."""
    if not self._use_bfloat16:
      return params
    return {k: v.to(self.compute_dtype) if v.dtype == torch.float32 else v
            for k, v in params.items()}

  def inference_network_fn(self, params: Params, mutable_state: Params,
                           features, mode: str, train: bool = False,
                           **module_kwargs
                           ) -> Tuple[Mapping[str, torch.Tensor], Params]:
    """Pure forward pass of the module on `params` and `mutable_state`;
    returns (outputs, new mutable state). With `train`, batch norm
    normalises by the batch and the new state holds its updated running
    statistics; otherwise it uses the running statistics and the new
    state is {} (the JAX package's `inference_network_fn`). Extra
    `module_kwargs` go to the module's forward (a static flag such as the
    domain-adaptive model's `inner`). Forwards of one model from several
    threads run one at a time."""
    variables = {**self.params_for_compute(params), **mutable_state}
    kwargs = {"mode": mode, "train": train, **module_kwargs}
    if torch.compiler.is_compiling():
      # Traced into a compiled graph: the graph takes `variables` as its
      # inputs and never swaps them into the module, so there is nothing
      # to guard (and a lock cannot be traced).
      return torch.func.functional_call(self.module, variables, (features,),
                                        kwargs, strict=True)
    with self._module_lock:
      return torch.func.functional_call(self.module, variables, (features,),
                                        kwargs, strict=True)

  @property
  def compute_dtype(self) -> torch.dtype:
    return torch.bfloat16 if self._use_bfloat16 else torch.float32

  def cast_features_for_compute(self, features):
    """float32 -> bfloat16 on the way into the network under the bfloat16
    policy."""
    if not self._use_bfloat16:
      return features
    return specs_lib.cast_float32_to_bfloat16(features)

  # -- session-decode seam ---------------------------------------------------

  @property
  def supports_sessions(self) -> bool:
    """True when the model has `init_session_state` / `decode_step_fn`."""
    return False

  def init_session_state(self, batch_size: int, device=None):
    raise NotImplementedError(
        f"{type(self).__name__} has no session-decode seam.")

  def decode_step_fn(self):
    """A pure `fn(state, session_state, features) -> (new_session_state,
    outputs)` advancing every session row one tick."""
    raise NotImplementedError(
        f"{type(self).__name__} has no session-decode seam.")

  @property
  def supports_decode_kernel(self) -> bool:
    """True when the model has `decode_arena_step_fn`."""
    return False

  def decode_arena_step_fn(self):
    """A `fn(state, arena, slots, features, mask) -> (arena, outputs)`
    advancing the masked lanes one tick against the whole session arena
    (leaves [max_sessions + 1, ...], slot 0 the null slot), IN PLACE."""
    raise NotImplementedError(
        f"{type(self).__name__} has no fused-arena decode seam.")
