"""MAML: model-agnostic meta-learning over any base T2RModel.

Counterpart of `tensor2robot_tpu.meta_learning.maml`. The JAX package
runs `jax.value_and_grad` of the base model's loss inside `jax.vmap` over
tasks; here the inner loop is `torch.func.grad_and_value` of a function
of the base's flat parameter dict (the base model's
`inference_network_fn`, a `functional_call`) inside `torch.func.vmap`
over tasks. The outer gradient goes through it by the train step's own
`torch.autograd.grad`, second order unless `first_order` detaches the
inner gradients (the JAX package's `stop_gradient`). Inner forwards run
with `train=False`, so batch statistics stay frozen. `torch.func.grad`
ignores an outer `torch.no_grad`, so the adapted predict runs under the
predictor's `no_grad` (never under `torch.inference_mode`).

Spec layout: features carry `condition/{features,labels}` and
`inference/features` subtrees, each leaf with a leading per-task samples
dim; labels are the inference split's labels. The train step's batch dim
is the task dim.

Parameters: without `learn_inner_lr` they are the base model's, by the
same names. With it, the module nests the base under `base` and learned
per-parameter inner learning rates (scalars, initialised at
`inner_learning_rate`) under `inner_lr` by the same names
(`base.torso.conv_0.weight`, `inner_lr.torso.conv_0.weight`), the flat
form of the JAX package's `{"base": ..., "inner_lr": ...}` tree
(`bridge.py` maps it); the base's buffers are then under `base.` too.
`gradient_accumulation_steps` defaults to the base model's, so
`multi_steps` wraps the outer optimizer (the base's unwrapped
`create_optimizer`) only.
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import torch
from torch import nn

from tensor2robot_tpu_torch import modes as modes_lib
from tensor2robot_tpu_torch import specs as specs_lib
from tensor2robot_tpu_torch.meta_learning import batch_utils
from tensor2robot_tpu_torch.models import abstract as abstract_model
from tensor2robot_tpu_torch.parallel import collectives
from tensor2robot_tpu_torch.utils import config

__all__ = ["MAMLModel", "create_maml_feature_spec",
           "create_maml_label_spec"]

Params = Dict[str, torch.Tensor]

BASE = "base."
INNER_LR = "inner_lr."


def create_maml_feature_spec(feature_spec, label_spec,
                             num_condition_samples: int = 1,
                             num_inference_samples: int = 1
                             ) -> specs_lib.SpecStruct:
  """condition/{features,labels} + inference/features, each with a
  per-task samples dim."""
  out = specs_lib.SpecStruct()
  for key, spec in specs_lib.flatten_spec_structure(feature_spec).items():
    out["condition/features/" + key] = spec.with_batch(
        num_condition_samples)
    out["inference/features/" + key] = spec.with_batch(
        num_inference_samples)
  for key, spec in specs_lib.flatten_spec_structure(label_spec).items():
    out["condition/labels/" + key] = spec.with_batch(num_condition_samples)
  return out


def create_maml_label_spec(label_spec,
                           num_inference_samples: int = 1
                           ) -> specs_lib.SpecStruct:
  out = specs_lib.SpecStruct()
  for key, spec in specs_lib.flatten_spec_structure(label_spec).items():
    out[key] = spec.with_batch(num_inference_samples)
  return out


class _Mirror(nn.Module):
  """One scalar parameter per parameter of `module`, at the same path."""

  def __init__(self, module: nn.Module):
    super().__init__()
    for name, _ in module.named_parameters():
      *path, leaf = name.split(".")
      node = self
      for part in path:
        if not hasattr(node, part):
          node.add_module(part, nn.Module())
        node = getattr(node, part)
      node.register_parameter(leaf, nn.Parameter(torch.zeros(())))


class _MAMLModule(nn.Module):
  """The base module under `base`, learned inner rates under
  `inner_lr`. It only names the parameters: MAMLModel runs the base
  model's functional forward."""

  def __init__(self, base: nn.Module):
    super().__init__()
    self.base = base
    self.inner_lr = _Mirror(base)

  def forward(self, *args, **kwargs):
    raise TypeError("the MAML module is not called: MAMLModel runs the "
                    "base model on the split parameters")


def _plain(tree) -> Dict[str, torch.Tensor]:
  """A flat dict of a (sub)tree: the form `torch.func` maps over."""
  return dict(specs_lib.flatten_spec_structure(tree).items())


def _float32(outputs) -> Dict[str, torch.Tensor]:
  return {k: v.float() if v.dtype == torch.bfloat16 else v
          for k, v in _plain(outputs).items()}


@config.configurable
class MAMLModel(abstract_model.T2RModel):
  """Wraps a base model with a per-task adapted inner loop."""

  def __init__(self,
               base_model=None,
               num_inner_loop_steps: int = 1,
               inner_learning_rate: float = 0.1,
               learn_inner_lr: bool = False,
               first_order: bool = False,
               num_condition_samples_per_task: int = 1,
               num_inference_samples_per_task: int = 1,
               **kwargs):
    if base_model is None:
      raise ValueError("base_model is required.")
    # The outer loop owns the real optimizer, so the base model's
    # accumulation carries over (create_optimizer delegates to the base's
    # unwrapped factory).
    kwargs.setdefault("gradient_accumulation_steps",
                      base_model.gradient_accumulation_steps)
    super().__init__(**kwargs)
    self._base_model = base_model
    self._num_inner_loop_steps = num_inner_loop_steps
    self._inner_learning_rate = inner_learning_rate
    self._learn_inner_lr = learn_inner_lr
    self._first_order = first_order
    self._num_condition = num_condition_samples_per_task
    self._num_inference = num_inference_samples_per_task

  @property
  def base_model(self):
    return self._base_model

  # -- specs ----------------------------------------------------------------

  def get_feature_specification(self, mode):
    return create_maml_feature_spec(
        self._base_model.get_feature_specification(mode),
        self._base_model.get_label_specification(mode),
        self._num_condition, self._num_inference)

  def get_label_specification(self, mode):
    return create_maml_label_spec(
        self._base_model.get_label_specification(mode),
        self._num_inference)

  def create_module(self) -> nn.Module:
    if self._learn_inner_lr:
      return _MAMLModule(self._base_model.module)
    return self._base_model.module

  # -- init -----------------------------------------------------------------

  def init_params(self, generator: torch.Generator) -> Params:
    """The base model's fresh parameters, plus (with `learn_inner_lr`)
    one inner learning rate per parameter at `inner_learning_rate`."""
    base = self._base_model.init_params(generator)
    if not self._learn_inner_lr:
      return base
    params = {BASE + k: v for k, v in base.items()}
    params.update({INNER_LR + k: torch.tensor(self._inner_learning_rate,
                                              dtype=torch.float32)
                   for k in base})
    return params

  def _split(self, tree: Mapping[str, torch.Tensor], prefix: str) -> Params:
    if not self._learn_inner_lr:
      return dict(tree)
    return {k[len(prefix):]: v for k, v in tree.items()
            if k.startswith(prefix)}

  # -- the meta forward pass ------------------------------------------------

  def inference_network_fn(self, params: Params, mutable_state: Params,
                           features, mode: str, train: bool = False,
                           **module_kwargs
                           ) -> Tuple[specs_lib.SpecStruct, Params]:
    """Per task: adapt the base parameters on the condition split, then
    run the inference split on the adapted (`conditioned_output`) and
    the unadapted (`unconditioned_output`) parameters; `inner_losses`
    [task, steps + 1] holds the condition loss before each step and after
    the last. The new mutable state is {} (`train` is not used: the
    inner loop keeps batch statistics frozen).

    A base model may customise the adaptation: its
    `inner_loop_forward_kwargs` (module kwargs, updated by the caller's
    `module_kwargs`) go to the condition-split forwards only, the
    inference forwards get the caller's `module_kwargs` alone; its
    `inner_loop_loss_fn(features, labels, outputs, mode)` replaces
    `model_train_fn` as the adaptation objective."""
    del train
    base = self._base_model
    inner_fwd_kwargs = dict(
        getattr(base, "inner_loop_forward_kwargs", None) or {})
    inner_fwd_kwargs.update(module_kwargs)
    base.module  # built here: a module built inside vmap draws its init
    base_params = self._split(params, BASE)
    lrs = self._split(params, INNER_LR) if self._learn_inner_lr else None
    base_state = self._split(mutable_state, BASE)
    features = specs_lib.flatten_spec_structure(features)
    custom_inner_loss = getattr(base, "inner_loop_loss_fn", None)
    steps = self._num_inner_loop_steps

    def base_forward(p: Params, task_features,
                     kwargs=module_kwargs) -> Dict[str, torch.Tensor]:
      outputs, _ = base.inference_network_fn(p, base_state, task_features,
                                             mode, train=False, **kwargs)
      return _float32(outputs)

    def inner_loss(p: Params, task_features, task_labels) -> torch.Tensor:
      outputs = base_forward(p, task_features, inner_fwd_kwargs)
      if custom_inner_loss is not None:
        return custom_inner_loss(task_features, task_labels, outputs, mode)
      loss, _ = base.model_train_fn(task_features, task_labels, outputs,
                                    mode)
      return loss

    def task_learn(cond_f, cond_l, inf_f):
      adapted = base_params
      losses = []
      for _ in range(steps):
        grads, loss = torch.func.grad_and_value(inner_loss)(adapted, cond_f,
                                                            cond_l)
        if self._first_order:
          grads = {k: g.detach() for k, g in grads.items()}
        losses.append(loss)
        adapted = {k: p - (self._inner_learning_rate if lrs is None
                           else lrs[k]) * grads[k]
                   for k, p in adapted.items()}
      losses.append(inner_loss(adapted, cond_f, cond_l))
      return (base_forward(adapted, inf_f), base_forward(base_params, inf_f),
              torch.stack(losses))

    # Each task adapts on its own condition rows: a loss that would read
    # the whole batch on a data split (TEC's triplet term) stays inside
    # the task here, as under the JAX package's vmap over tasks.
    with collectives.batch_group(None):
      conditioned, unconditioned, inner_losses = torch.func.vmap(
          task_learn)(
              _plain(features["condition/features"]),
              _plain(features["condition/labels"]),
              _plain(features["inference/features"]))
    out = specs_lib.SpecStruct()
    out["conditioned_output"] = conditioned
    out["unconditioned_output"] = unconditioned
    out["inner_losses"] = inner_losses
    return out, {}

  # -- outer loss -----------------------------------------------------------

  @staticmethod
  def _flatten_outputs(outputs):
    """Merges [task, samples] dims; per-task scalars (rank < 2) pass
    through unflattened."""
    return batch_utils.map_leaves(
        lambda x: batch_utils.flatten_batch_examples(x) if x.ndim >= 2
        else x, outputs)

  def _inference_split(self, features, labels):
    features = specs_lib.flatten_spec_structure(features)
    return (batch_utils.flatten_batch_examples(
                features["inference/features"]),
            batch_utils.flatten_batch_examples(
                specs_lib.flatten_spec_structure(labels)))

  def model_train_fn(self, features, labels, inference_outputs, mode):
    """Outer loss: the base model's train fn on the flattened inference
    split and its conditioned outputs."""
    outputs = specs_lib.flatten_spec_structure(inference_outputs)
    flat_features, flat_labels = self._inference_split(features, labels)
    loss, scalars = self._base_model.model_train_fn(
        flat_features, flat_labels,
        self._flatten_outputs(outputs["conditioned_output"]), mode)
    inner = outputs["inner_losses"]
    scalars = dict(scalars)
    scalars["inner_loss_initial"] = inner[:, 0].mean()
    scalars["inner_loss_final"] = inner[:, -1].mean()
    return loss, scalars

  def model_eval_fn(self, features, labels, inference_outputs):
    base = self._base_model
    outputs = specs_lib.flatten_spec_structure(inference_outputs)
    flat_features, flat_labels = self._inference_split(features, labels)
    flat_cond = self._flatten_outputs(outputs["conditioned_output"])
    flat_uncond = self._flatten_outputs(outputs["unconditioned_output"])
    metrics = {f"conditioned/{k}": v for k, v in base.model_eval_fn(
        flat_features, flat_labels, flat_cond).items()}
    metrics.update({f"unconditioned/{k}": v for k, v in base.model_eval_fn(
        flat_features, flat_labels, flat_uncond).items()})
    if "conditioned/loss" in metrics:
      metrics["loss"] = metrics["conditioned/loss"]
    else:
      loss, _ = base.model_train_fn(flat_features, flat_labels, flat_cond,
                                    modes_lib.EVAL)
      metrics["loss"] = loss
    return metrics

  def create_optimizer(self):
    if self._optimizer_fn is not None:
      return super().create_optimizer()
    return self._base_model.create_optimizer()
