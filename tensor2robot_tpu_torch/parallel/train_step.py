"""Train state, the train step, the K-step train loop, the eval step and
loop, and the predict function.

Counterpart of `tensor2robot_tpu.parallel.train_step` on one device.
`TrainState` holds the step, the parameters as a flat `state_dict`, the
optimizer state (`models.optimizers` layout), the EMA shadow parameters
(or None) and the mutable state (batch-norm running statistics, flax's
`batch_stats`; {} for a model without). The JAX package jits a pure step
over a mesh; here the step runs eagerly on the parameters' device and
returns a new state: the state it was given is left as it was, unless
the step donates it (below).

The step's new mutable state comes from the forward on the pre-update
parameters; the EMA covers parameters only, and eval and predict run the
EMA parameters (when kept) with the live mutable state.

The step follows the model's knobs as the JAX package's does:

* `remat`: the forward runs under `torch.utils.checkpoint` (non-reentrant)
  and is recomputed in the backward. The forward draws no randomness and
  writes no buffer (batch norm returns its new statistics), so the
  recompute reproduces it and updates nothing twice;
* `gradient_accumulation_steps > 1`: the optimizer is `multi_steps`, and
  the EMA moves only on a step whose update was applied;
* `use_pcgrad` (with `model_task_losses_fn`): one forward, one gradient
  per task loss in sorted name order, combined by `ops.pcgrad`; the loss
  is the sum of the task losses and the scalars are `task_loss/<name>`.

On a mesh (`parallel.mesh`: one process per rank), the step is ZeRO-3
written out by hand. The state's leaves are this rank's blocks, by
`state_shardings`: a leaf the partition rules shard (`fsdp_rules()`:
the largest dim, where the fsdp axis divides it) keeps 1/F of it on each
of the F fsdp ranks, and the optimizer moments and the EMA shadow follow
their parameter; everything else is replicated. Each step

1. gathers the full parameters (all-gather over each leaf's axes);
2. runs the forward and backward on this rank's block of the batch
   (`batch_spec`: ('data',), or ('data', 'sp') for a sequence split),
   batch norm's statistics over the whole sharded batch;
3. reduces each gradient to the global batch's: a sum over the ranks
   outside the leaf's axes, a reduce-scatter over its axes, then divided
   by the mesh size. The loss is a mean over equal blocks, so the mean
   over every rank is the global mean: the data ranks' means average,
   the sp ranks' partial gradients (each a mean over its T block, the
   cotangents of the other blocks' K/V sent back by the collectives'
   backward) add up, and the fsdp peers, which see the same batch,
   average to one copy. A loss that compares rows across the batch
   gathers them (`collectives.all_gather_batch` over
   `collectives.current_batch_group()`), so every data rank's loss is the
   global one and their mean is too;
   A STAGE-LOCAL leaf (`T2RModel.stage_local_axes`: a pipeline's
   `pp`-sharded stage stack, the all-to-all expert stack sharded over the
   token axis, which the partition rules must shard over exactly those
   axes) is handed to the model as this rank's block: it is never
   gathered and never reduce-scattered, and its gradient, which the
   block's own collectives' backward already carries from every rank of
   its axes, is summed over the ranks that hold the same block and
   divided by the mesh size like every other;
4. updates this rank's blocks: the optimizer is elementwise, and its
   global-norm clip reads the norm over all blocks
   (`optimizers.sharded_norms`);
5. with `donate` (the default on a mesh), updates the state in place:
   the optimizer writes its new moments and the parameters' update into
   the state's own tensors leaf by leaf (`optimizers.in_place`), and the
   EMA its shadow, so the update holds one state where the functional
   one holds two; the bits are the functional update's. The batch-norm
   statistics are replaced.

Metrics are the means over the ranks, the same on every rank. The
state's `torch.distributed` groups come from the mesh, and every
collective goes through `parallel.collectives`.
"""

from __future__ import annotations

import contextlib
import dataclasses
import re
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch
import torch.utils.checkpoint

from tensor2robot_tpu_torch import modes as modes_lib
from tensor2robot_tpu_torch.models import optimizers as optimizers_lib
from tensor2robot_tpu_torch.obs import trace as obs_trace
from tensor2robot_tpu_torch.ops import pcgrad as pcgrad_lib
from tensor2robot_tpu_torch.parallel import collectives
from tensor2robot_tpu_torch.parallel import mesh as mesh_lib

__all__ = ["TrainState", "init_train_state", "create_train_state",
           "loss_and_grads", "task_losses_and_grads", "make_train_step",
           "make_train_loop", "make_eval_step", "make_eval_loop",
           "make_predict_fn", "eval_outputs", "map_tensors", "fsdp_rules",
           "state_shardings", "shard_state", "gather_state",
           "loop_batch_spec", "make_grad_fn", "place_state"]

PartitionRules = Sequence[Tuple[str, Any]]

Params = Dict[str, torch.Tensor]


def map_tensors(fn: Callable[[torch.Tensor], torch.Tensor], tree: Any) -> Any:
  """Applies `fn` to every tensor of a tree of dicts, tuples and lists;
  other leaves (counts, None) are kept."""
  if isinstance(tree, torch.Tensor):
    return fn(tree)
  if isinstance(tree, dict):
    return {k: map_tensors(fn, v) for k, v in tree.items()}
  if isinstance(tree, (tuple, list)):
    return type(tree)(map_tensors(fn, v) for v in tree)
  return tree


@dataclasses.dataclass(frozen=True)
class TrainState:
  """Model state: step, parameters, EMA shadow parameters (or None),
  optimizer state (or None for a serving-only state) and mutable state
  (the module's buffers by name; {} for a module without)."""

  step: int
  params: Params
  ema_params: Optional[Params] = None
  opt_state: Any = None
  mutable_state: Params = dataclasses.field(default_factory=dict)

  def eval_params(self, use_ema: bool = True) -> Params:
    """Params for eval/serving: the EMA shadow when present."""
    if use_ema and self.ema_params is not None:
      return self.ema_params
    return self.params

  def replace(self, **changes) -> "TrainState":
    return dataclasses.replace(self, **changes)

  def to(self, device) -> "TrainState":
    """The same state with every tensor on `device`."""
    move = lambda x: x.to(device)
    return self.replace(params=map_tensors(move, self.params),
                        ema_params=map_tensors(move, self.ema_params),
                        opt_state=map_tensors(move, self.opt_state),
                        mutable_state=map_tensors(move, self.mutable_state))


def init_train_state(model, params: Params, step: int = 0) -> TrainState:
  """The state a run starts from on `params`: the model's optimizer
  state, the EMA shadow as a copy of the parameters when the model uses
  EMA (a copy, not an alias: the step replaces params, never the
  shadow's storage), and the model's initial mutable state on the
  parameters' device."""
  ema = ({k: v.clone() for k, v in params.items()} if model.use_ema
         else None)
  device = next(iter(params.values())).device
  mutable_state = {k: v.to(device)
                   for k, v in model.init_mutable_state().items()}
  return TrainState(step=int(step), params=params, ema_params=ema,
                    opt_state=model.build_optimizer().init(params),
                    mutable_state=mutable_state)


def fsdp_rules(axis: str = "fsdp") -> PartitionRules:
  """Default FSDP rules: shard the largest dim of every >=2-D leaf over
  the fsdp axis (only where it divides that dim)."""
  return ((r".*", ("__largest__", axis)),)


def _flax_order(path: str, ndim: int) -> Tuple[int, ...]:
  """The port's dims in the order of the JAX package's layout of the
  same leaf (`bridge.py`): a Dense weight [out, in] is flax's kernel [in,
  out], a 1-D Conv's [out, in, k] its [k, in, out], a Conv's OIHW its
  HWIO; every other leaf keeps its order. `__largest__` breaks ties in
  this order, so both packages shard the same logical dim."""
  if path.endswith(".weight"):
    return {2: (1, 0), 3: (2, 1, 0), 4: (2, 3, 1, 0)}.get(
        ndim, tuple(range(ndim)))
  return tuple(range(ndim))


def _leaf_partition(path: str, shape: Tuple[int, ...],
                    rules: Optional[PartitionRules],
                    mesh) -> mesh_lib.PartitionSpec:
  """The partition spec the first rule whose regex matches `path` gives a
  leaf of `shape` (positional over the port's dims); replicated when no
  rule matches, the rule's rank differs, or `__largest__` finds its axis
  of size 1, a leaf under 2-D, or a largest dim the axis does not
  divide."""
  if rules is None or len(shape) < 1:
    return mesh_lib.PartitionSpec()
  for pattern, spec in rules:
    if re.search(pattern, path):
      if spec and spec[0] == "__largest__":
        axis_name = spec[1]
        axis_size = mesh.shape[axis_name]
        if axis_size <= 1 or len(shape) < 2:
          return mesh_lib.PartitionSpec()
        largest = max(_flax_order(path, len(shape)), key=lambda i: shape[i])
        if shape[largest] % axis_size:
          return mesh_lib.PartitionSpec()
        out = [None] * len(shape)
        out[largest] = axis_name
        return mesh_lib.PartitionSpec(*out)
      if len(spec) != len(shape):
        return mesh_lib.PartitionSpec()
      return mesh_lib.PartitionSpec(*spec)
  return mesh_lib.PartitionSpec()


def _path_str(path: Sequence[Any]) -> str:
  return "/".join(str(entry) for entry in path)


def _map_path(fn: Callable, tree: Any, path: Tuple = ()) -> Any:
  """`fn(path, leaf)` over a tree of dicts, tuples and lists."""
  if isinstance(tree, dict):
    return {k: _map_path(fn, v, path + (k,)) for k, v in tree.items()}
  if isinstance(tree, (tuple, list)):
    return type(tree)(_map_path(fn, v, path + (i,))
                      for i, v in enumerate(tree))
  return fn(path, tree)


def _zip_map(fn: Callable, tree: Any, shardings: Any) -> Any:
  """`fn(leaf, sharding)` over a tree and its sharding tree."""
  if isinstance(tree, dict):
    return {k: _zip_map(fn, v, shardings[k]) for k, v in tree.items()}
  if isinstance(tree, (tuple, list)):
    return type(tree)(_zip_map(fn, v, sh) for v, sh in zip(tree, shardings))
  return fn(tree, shardings)


def state_shardings(state: TrainState, mesh,
                    rules: Optional[PartitionRules] = None) -> TrainState:
  """A `TrainState` of `mesh.NamedSharding`s, one per leaf of the FULL
  `state`: parameters by the partition rules over their paths
  (`params/<state_dict name>`); the EMA shadow and every optimizer
  moment (a param-shaped leaf under its parameter's name) follow their
  parameter; everything else replicated."""
  params = {name: _leaf_partition(f"params/{name}", tuple(value.shape),
                                  rules, mesh)
            for name, value in state.params.items()}
  replicated = mesh_lib.NamedSharding(mesh, mesh_lib.PartitionSpec())

  def follow(path, leaf):
    name = path[-1] if path else None
    if (isinstance(leaf, torch.Tensor) and name in params
        and tuple(leaf.shape) == tuple(state.params[name].shape)):
      return mesh_lib.NamedSharding(mesh, params[name])
    return replicated

  return TrainState(
      step=replicated,
      params={k: mesh_lib.NamedSharding(mesh, v) for k, v in params.items()},
      ema_params=_map_path(follow, state.ema_params),
      opt_state=_map_path(follow, state.opt_state),
      mutable_state=_map_path(lambda path, leaf: replicated,
                              state.mutable_state))


# The state fields that hold tensors.
_STATE_FIELDS = ("params", "ema_params", "opt_state", "mutable_state")


def shard_state(state: TrainState, shardings: TrainState) -> TrainState:
  """This rank's blocks of a full `state`, every tensor a copy: the full
  tensors can be freed, and a step that donates the result never writes
  into the caller's."""

  def cut(leaf, sharding):
    if not isinstance(leaf, torch.Tensor):
      return leaf
    return mesh_lib.shard(leaf, sharding.mesh, sharding.spec).clone()

  return state.replace(**{f: _zip_map(cut, getattr(state, f),
                                      getattr(shardings, f))
                          for f in _STATE_FIELDS})


def gather_state(state: TrainState, shardings: TrainState) -> TrainState:
  """The full state from every rank's blocks (collective: every rank of
  the mesh calls it)."""

  def gather(leaf, sharding):
    if not isinstance(leaf, torch.Tensor) or not sharding.spec:
      return leaf
    return mesh_lib.unshard(leaf, sharding.mesh, sharding.spec)

  return state.replace(**{f: _zip_map(gather, getattr(state, f),
                                      getattr(shardings, f))
                          for f in _STATE_FIELDS})


def place_state(state: TrainState, mesh, rules: Optional[PartitionRules] = None):
  """(this rank's blocks of the full `state` on `mesh.device`, the
  shardings) by `state_shardings(state, mesh, rules)`."""
  shardings = state_shardings(state, mesh, rules)
  return shard_state(state, shardings).to(mesh.device), shardings


def create_train_state(model, generator: torch.Generator,
                       device: torch.device, mesh=None,
                       rules: Optional[PartitionRules] = None):
  """Fresh parameters from `generator` (drawn on the CPU, then moved),
  step 0, fresh optimizer state, EMA as a copy when the model uses it, the
  initial mutable state.

  With a `mesh`, returns (state, shardings) as the JAX package does: the
  state is built on the CPU, then cut into this rank's blocks on the
  mesh's device (`place_state`)."""
  if mesh is None:
    params = {k: v.to(device)
              for k, v in model.init_params(generator).items()}
    return init_train_state(model, params)
  return place_state(init_train_state(model, model.init_params(generator)),
                     mesh, rules)


def _float32_outputs(outputs) -> Dict[str, torch.Tensor]:
  return {k: v.float() if v.dtype == torch.bfloat16 else v
          for k, v in outputs.items()}


def _train_forward(model, leaves: Params, features, mutable_state):
  """Train-mode outputs (bfloat16 cast to float32) and the new mutable
  state of the forward on `leaves`; under `model.remat` its activations
  are recomputed in the backward instead of kept."""
  compute_features = model.cast_features_for_compute(features)

  def forward(leaves):
    outputs, new_mutable = model.inference_network_fn(
        leaves, mutable_state or {}, compute_features, modes_lib.TRAIN,
        train=True)
    return _float32_outputs(outputs), new_mutable

  if getattr(model, "remat", False):
    return torch.utils.checkpoint.checkpoint(forward, leaves,
                                             use_reentrant=False)
  return forward(leaves)


def _leaves(params: Params) -> Params:
  return {k: v.detach().requires_grad_(True) for k, v in params.items()}


def forward_loss(model, leaves: Params, features, labels,
                 mutable_state: Optional[Params] = None):
  """(loss, scalars, new mutable state) of `model.model_train_fn` on the
  train-mode forward over `leaves`: the region of the step that
  `obs.xray` compiles (its backward is compiled with it, by
  AOTAutograd)."""
  outputs, new_mutable = _train_forward(model, leaves, features,
                                        mutable_state)
  loss, scalars = model.model_train_fn(features, labels, outputs,
                                       modes_lib.TRAIN)
  return loss, scalars, new_mutable


def loss_and_grads(model, params: Params, features, labels,
                   mutable_state: Optional[Params] = None,
                   forward_loss_fn: Optional[Callable] = None):
  """(loss, scalars, grads, new mutable state) of `model.model_train_fn`
  on one batch, the forward in train mode on `params` and
  `mutable_state` (default {}), the gradients taken with respect to
  `params` (f32 masters: under the bfloat16 policy the forward casts them
  to bf16 and the gradients flow back through the cast). loss and scalars
  are detached; the new mutable state is {} for a model without one. A
  parameter the loss does not reach (the domain-adaptive model's learned
  loss outside MAML) gets a zero gradient, as `jax.grad` gives it.
  `forward_loss_fn(leaves, features, labels, mutable_state)` replaces
  `forward_loss` (a compiled copy of it)."""
  names = list(params)
  leaves = _leaves(params)
  if forward_loss_fn is None:
    loss, scalars, new_mutable = forward_loss(model, leaves, features, labels,
                                              mutable_state)
  else:
    loss, scalars, new_mutable = forward_loss_fn(leaves, features, labels,
                                                 mutable_state)
  grads = dict(zip(names, torch.autograd.grad(
      loss, [leaves[k] for k in names], allow_unused=True,
      materialize_grads=True)))
  return (loss.detach(), {k: v.detach() for k, v in scalars.items()},
          grads, new_mutable)


def task_losses_and_grads(model, params: Params, features, labels,
                          mutable_state: Optional[Params] = None):
  """({task: loss}, [grads per task in sorted task order], new mutable
  state) of `model.model_task_losses_fn` on one forward: one
  `torch.autograd.grad` per task loss, the graph kept for all but the
  last (the JAX package's `jax.jacrev` over the stacked task losses)."""
  names = list(params)
  leaves = _leaves(params)
  outputs, new_mutable = _train_forward(model, leaves, features,
                                        mutable_state)
  losses = model.model_task_losses_fn(features, labels, outputs,
                                      modes_lib.TRAIN)
  tasks = sorted(losses)
  task_grads = []
  for i, task in enumerate(tasks):
    grads = torch.autograd.grad(losses[task], [leaves[k] for k in names],
                                retain_graph=i < len(tasks) - 1)
    task_grads.append(dict(zip(names, grads)))
  return ({k: v.detach() for k, v in losses.items()}, task_grads,
          new_mutable)


def _uses_pcgrad(model) -> bool:
  return bool(getattr(model, "use_pcgrad", False)) and (
      getattr(model, "model_task_losses_fn", None) is not None)


class _MeshOps:
  """The collectives of the step on a mesh, for one state layout."""

  def __init__(self, mesh, shardings: TrainState, batch_axis: str,
               batch_spec, model=None):
    self.mesh = mesh
    self.specs = {k: v.spec for k, v in shardings.params.items()}
    # The leaves the model takes as this rank's block (module docstring).
    local_axes = getattr(model, "stage_local_axes", lambda name: ())
    self.local = {k for k in self.specs if local_axes(k)}
    for k in self.local:
      if set(self._axes(k)) != set(local_axes(k)):
        raise ValueError(
            f"the model takes {k!r} as this rank's block over "
            f"{tuple(local_axes(k))}: the partition rules must shard it "
            f"over exactly those axes, not {self.specs[k]}")
    spec = tuple(batch_spec) if batch_spec is not None else (batch_axis,)
    # Batch norm's statistics cover the axes the batch is split over.
    self.batch_group = mesh.group(
        tuple(a for entry in spec for a in mesh_lib._spec_axes(entry)))
    self.world = mesh.group(mesh.axis_names)

  def _axes(self, name: str) -> Tuple[str, ...]:
    return tuple(a for entry in self.specs[name]
                 for a in mesh_lib._spec_axes(entry))

  def gather(self, params: Params) -> Params:
    """The parameters the model runs on: the full ones from this rank's
    blocks, a stage-local leaf's block as it is."""
    return {k: v if k in self.local else mesh_lib.unshard(v, self.mesh,
                                                          self.specs[k])
            for k, v in params.items()}

  def reduce(self, grads: Params) -> Params:
    """Each full gradient of this rank's loss -> this rank's block of the
    global batch's gradient (module docstring, step 3). The sums over
    the ranks outside a leaf's axes go in one flat all-reduce per set of
    axes."""
    buckets: Dict[Tuple[str, ...], list] = {}
    for name in grads:
      outside = tuple(a for a in self.mesh.axis_names
                      if a not in self._axes(name))
      buckets.setdefault(outside, []).append(name)
    summed = {}
    for outside, names in buckets.items():
      flat = torch.cat([grads[k].reshape(-1) for k in names])
      flat = collectives.all_reduce(flat, self.mesh.group(outside))
      for k, piece in zip(names, flat.split([grads[k].numel()
                                            for k in names])):
        summed[k] = piece.view_as(grads[k])
    out = {}
    for name, g in summed.items():
      for dim, entry in enumerate(() if name in self.local
                                  else self.specs[name]):
        axes = mesh_lib._spec_axes(entry)
        if axes:
          g = collectives.reduce_scatter(g, self.mesh.group(axes), dim=dim)
      out[name] = g / self.mesh.size
    return out

  def sum_of_squares(self, tree: Params) -> torch.Tensor:
    """The sum of squares of the full tensors whose blocks `tree` holds
    (keyed by parameter name)."""
    by_axes: Dict[Tuple[str, ...], torch.Tensor] = {}
    for name, value in tree.items():
      axes = self._axes(name) if name in self.specs else ()
      square = torch.sum(value.float() * value.float())
      by_axes[axes] = by_axes[axes] + square if axes in by_axes else square
    total = None
    for axes, square in by_axes.items():
      square = collectives.all_reduce(square, self.mesh.group(axes))
      total = square if total is None else total + square
    return total

  def mean(self, values: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Each scalar's mean over the mesh's ranks, in one all-reduce."""
    if not values:
      return values
    names = list(values)
    stacked = torch.stack([values[k].detach().float().reshape(())
                           for k in names])
    stacked = collectives.all_reduce(stacked, self.world) / self.mesh.size
    return {k: stacked[i].to(values[k].dtype) for i, k in enumerate(names)}


def _gradients_fn(model, ops: Optional[_MeshOps],
                  forward_loss_fn: Optional[Callable] = None) -> Callable:
  """(state, features, labels) -> (loss, scalars, gradients, new mutable
  state) of the step; on a mesh the gradients are this rank's blocks of
  the global batch's. `forward_loss_fn` goes to `loss_and_grads` (PCGrad's
  per-task gradients stay eager)."""
  use_pcgrad = _uses_pcgrad(model)
  mesh = ops.mesh if ops is not None else None

  def gradients(state: TrainState, features, labels):
    params = state.params if ops is None else ops.gather(state.params)
    if use_pcgrad:
      task_losses, task_grads, new_mutable = task_losses_and_grads(
          model, params, features, labels, state.mutable_state)
      if ops is not None:
        # The projection is not linear: combine the global batch's task
        # gradients, then keep this rank's blocks.
        task_grads = [{k: collectives.all_reduce(g, ops.world) / mesh.size
                       for k, g in grads.items()} for grads in task_grads]
      grads = pcgrad_lib.pcgrad_combine(
          task_grads,
          use_flat_projection=getattr(model, "pcgrad_flat_projection",
                                      False),
          allowlist=getattr(model, "pcgrad_allowlist", None),
          denylist=getattr(model, "pcgrad_denylist", None))
      if ops is not None:
        grads = {k: mesh_lib.shard(g, mesh, ops.specs[k])
                 for k, g in grads.items()}
      loss = sum(task_losses.values())
      scalars = {f"task_loss/{k}": v for k, v in task_losses.items()}
    else:
      loss, scalars, grads, new_mutable = loss_and_grads(
          model, params, features, labels, state.mutable_state,
          forward_loss_fn)
      if ops is not None:
        grads = ops.reduce(grads)
    return loss, scalars, grads, new_mutable

  return gradients


def make_grad_fn(model, mesh, shardings: TrainState,
                 batch_axis: str = "data", batch_spec=None) -> Callable:
  """(state, features, labels) -> (loss, gradients) of the train step on
  a mesh, without the update: the loss the mean over the ranks, the
  gradients this rank's blocks of the global batch's (gather them with
  `gather_state`'s layout: `mesh.unshard` by `shardings.params`)."""
  ops = _MeshOps(mesh, shardings, batch_axis, batch_spec, model)
  gradients = _gradients_fn(model, ops)

  def grad_fn(state: TrainState, features, labels):
    with collectives.batch_group(ops.batch_group):
      loss, _, grads, _ = gradients(state, features, labels)
    return ops.mean({"loss": loss})["loss"], grads

  return grad_fn


class CompilableStep:
  """A train step (or K-step loop) that runs eagerly when called, and
  that `obs.xray.analyze_jit` compiles region by region:
  `compile_with(compile)` returns the same step with `forward_loss`
  (forward, loss and, through AOTAutograd, their backward) compiled by
  `compile`. The gradients are taken by `torch.autograd.grad` between the
  compiled forward and the optimizer's update, which stays eager (its
  counts are Python numbers a graph would specialize on). The compiled
  step carries its compiled region as `forward_loss`, which goes to
  `loss_and_grads(forward_loss_fn=...)`."""

  def __init__(self, build: Callable, model):
    self.build = build
    self._model = model
    self._eager = build(None)

  def __call__(self, state: TrainState, features, labels):
    return self._eager(state, features, labels)

  def _region_fn(self) -> Callable:
    model = self._model

    def region(leaves, features, labels, mutable_state):
      return forward_loss(model, leaves, features, labels, mutable_state)

    return region

  def region(self, state: TrainState, features, labels):
    """(function, args): the region `compile_with` compiles and the
    arguments the step's first call on (state, features, labels) hands
    it, without running it (`analysis.graph_audit` traces this; one
    device, where the step's gradients are `loss_and_grads`')."""
    return self._region_fn(), (_leaves(state.params), features, labels,
                               state.mutable_state)

  def compile_with(self, compile_fn: Callable) -> Callable:
    compiled = compile_fn(self._region_fn())
    step = self.build(compiled)
    step.forward_loss = compiled
    return step


def make_train_step(model, mesh=None, shardings: Optional[TrainState] = None,
                    batch_axis: str = "data", batch_spec=None,
                    donate: Optional[bool] = None) -> Callable:
  """The train step: (state, features, labels) -> (new_state, metrics).

  `loss_and_grads` (or, under PCGrad, `task_losses_and_grads` and
  `pcgrad_combine`; its forward also gives the new mutable state, from
  the pre-update parameters), then the optimizer update, then the EMA
  `e * d + (1 - d) * p` on the new parameters when the update was
  applied. Metrics: `loss`, `global_gradient_norm` of the gradients the
  optimizer gets (the micro-batch's under accumulation, the combined ones
  under PCGrad), and the model's scalars, as 0-dim tensors on the device
  (reading them syncs).

  With a `mesh` and the `shardings` of `create_train_state(mesh=...)`,
  the state holds this rank's blocks and features and labels are this
  rank's block of the batch by `batch_spec` (default: the leading dim
  over `batch_axis`): the ZeRO-3 step of the module docstring. `donate`
  (default: True on a mesh, as the JAX package's default; False without
  one, where the port's single-device step has always left the state it
  was given as it was) updates the state's tensors in place (module
  docstring): the caller's old state then holds the new values.

  Each call is a `train/step` span (`obs.trace`, recorded while the
  tracer is on) tiled by `train/gradients` (forward, loss and their
  gradients) and `train/update` (the optimizer, the EMA, the metrics)."""
  optimizer = model.build_optimizer()
  ema_decay = model.ema_decay
  if mesh is not None and shardings is None:
    raise ValueError("a train step on a mesh needs the state's shardings")
  ops = (_MeshOps(mesh, shardings, batch_axis, batch_spec, model)
         if mesh is not None else None)
  if donate is None:
    donate = mesh is not None

  def build(forward_loss_fn: Optional[Callable]) -> Callable:
    gradients = _gradients_fn(model, ops, forward_loss_fn)

    def step_fn(state: TrainState, features, labels):
      phases = obs_trace.phases("train/step", "train/gradients",
                                cat="train")
      try:
        if ops is None:
          loss, scalars, grads, new_mutable = gradients(state, features,
                                                        labels)
        else:
          with collectives.batch_group(ops.batch_group):
            loss, scalars, grads, new_mutable = gradients(state, features,
                                                          labels)
        phases.next("train/update")
        with torch.no_grad(), (
            optimizers_lib.sharded_norms(ops.sum_of_squares)
            if ops is not None else contextlib.nullcontext()), \
            optimizers_lib.in_place(donate):
          updates, opt_state = optimizer.update(grads, state.opt_state,
                                                state.params)
          applied = optimizers_lib.has_updated(opt_state)
          params = (optimizers_lib.apply_updates(state.params, updates)
                    if applied else state.params)
          ema = state.ema_params
          if ema is not None and applied:
            if donate:
              for k, e in ema.items():
                e.mul_(ema_decay).add_((1.0 - ema_decay) * params[k])
            else:
              ema = {k: e * ema_decay + (1.0 - ema_decay) * params[k]
                     for k, e in ema.items()}
          metrics = {
              "loss": loss,
              "global_gradient_norm": optimizers_lib.global_norm(grads),
              **scalars}
          if ops is not None:
            norm = metrics.pop("global_gradient_norm")
            metrics = ops.mean(metrics)
            metrics["global_gradient_norm"] = norm
          new_mutable = new_mutable or state.mutable_state
        return state.replace(step=state.step + 1, params=params,
                             opt_state=opt_state, ema_params=ema,
                             mutable_state=new_mutable), metrics
      finally:
        phases.end()

    return step_fn

  return CompilableStep(build, model)


def loop_batch_spec(batch_spec=None, batch_axis: str = "data"
                    ) -> mesh_lib.PartitionSpec:
  """The partition spec of a staged [K, B, ...] loop batch: the step's
  batch spec with the leading K axis whole."""
  return mesh_lib.PartitionSpec(
      None, *(batch_spec if batch_spec is not None else (batch_axis,)))


def make_train_loop(model, num_steps: int, mesh=None,
                    shardings: Optional[TrainState] = None,
                    batch_axis: str = "data", batch_spec=None,
                    donate: Optional[bool] = None) -> Callable:
  """K train steps per call: (state, features, labels) -> (state, stacked
  metrics), with features and labels carrying a leading `num_steps` axis
  of batches (on a mesh, this rank's blocks by `loop_batch_spec`). The
  same math as K calls of `make_train_step`; each metric comes back
  stacked on a leading axis."""
  if num_steps < 1:
    raise ValueError(f"num_steps must be >= 1, got {num_steps}")
  step = make_train_step(model, mesh=mesh, shardings=shardings,
                         batch_axis=batch_axis, batch_spec=batch_spec,
                         donate=donate)

  def build(forward_loss_fn: Optional[Callable]) -> Callable:
    step_fn = step.build(forward_loss_fn)

    def loop_fn(state: TrainState, features, labels):
      history = []
      for i in range(num_steps):
        state, metrics = step_fn(state,
                                 {k: v[i] for k, v in features.items()},
                                 {k: v[i] for k, v in labels.items()})
        history.append(metrics)
      return state, {k: torch.stack([m[k] for m in history])
                     for k in history[0]}

    return loop_fn

  return CompilableStep(build, model)


def eval_outputs(model, state: TrainState, features, mode: str,
                  use_ema: bool):
  """Eval-mode outputs (running statistics, no update) of the EMA
  parameters when kept, with the live mutable state; bfloat16 outputs
  cast to float32."""
  outputs, _ = model.inference_network_fn(
      state.eval_params(use_ema=use_ema), state.mutable_state,
      model.cast_features_for_compute(features), mode, train=False)
  return _float32_outputs(outputs)


def _eval_state(state: TrainState, ops: Optional[_MeshOps],
                use_ema: bool) -> TrainState:
  """The state eval and predict run: on a mesh, with the full parameters
  they read gathered from this rank's blocks."""
  if ops is None:
    return state
  if use_ema and state.ema_params is not None:
    return state.replace(ema_params=ops.gather(state.ema_params))
  return state.replace(params=ops.gather(state.params))


def make_eval_step(model, use_ema: bool = True, mesh=None,
                   shardings: Optional[TrainState] = None,
                   batch_axis: str = "data", batch_spec=None) -> Callable:
  """(state, features, labels) -> the model's eval metric scalars, as
  0-dim tensors on the device. On a mesh (as `make_train_step`), each
  metric is the mean over the ranks of their blocks' metrics."""
  ops = (_MeshOps(mesh, shardings, batch_axis, batch_spec, model)
         if mesh is not None else None)

  @torch.no_grad()
  def eval_fn(state: TrainState, features, labels):
    if ops is None:
      outputs = eval_outputs(model, state, features, modes_lib.EVAL, use_ema)
      return model.model_eval_fn(features, labels, outputs)
    with collectives.batch_group(ops.batch_group):
      outputs = eval_outputs(model, _eval_state(state, ops, use_ema),
                             features, modes_lib.EVAL, use_ema)
      return ops.mean(model.model_eval_fn(features, labels, outputs))

  return eval_fn


def make_eval_loop(model, num_steps: int, use_ema: bool = True, mesh=None,
                   shardings: Optional[TrainState] = None,
                   batch_axis: str = "data", batch_spec=None) -> Callable:
  """K eval batches per call: (state, features, labels) -> metric scalars
  SUMMED over the K batches (divide by K for the mean), with features and
  labels carrying a leading `num_steps` axis of batches."""
  if num_steps < 1:
    raise ValueError(f"num_steps must be >= 1, got {num_steps}")
  eval_fn = make_eval_step(model, use_ema=use_ema, mesh=mesh,
                           shardings=shardings, batch_axis=batch_axis,
                           batch_spec=batch_spec)

  def loop_fn(state: TrainState, features, labels):
    totals: Dict[str, torch.Tensor] = {}
    for i in range(num_steps):
      metrics = eval_fn(state, {k: v[i] for k, v in features.items()},
                        {k: v[i] for k, v in labels.items()})
      for key, value in metrics.items():
        totals[key] = totals[key] + value if key in totals else value
    return totals

  return loop_fn


def make_predict_fn(model, use_ema: bool = True, mesh=None,
                    shardings: Optional[TrainState] = None) -> Callable:
  """(state, features) -> export outputs of the eval-mode forward, with
  bfloat16 outputs cast to float32. On a mesh the parameters are
  gathered first and `features` are a whole batch: every rank predicts
  it (a sequence-parallel model predicts its T block of it)."""
  ops = (_MeshOps(mesh, shardings, "data", None, model)
         if mesh is not None else None)

  @torch.no_grad()
  def predict_fn(state: TrainState, features):
    outputs = eval_outputs(model, _eval_state(state, ops, use_ema),
                           features, modes_lib.PREDICT, use_ema)
    return model.create_export_outputs_fn(features, outputs)

  return predict_fn
