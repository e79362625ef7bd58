"""Pipeline parallelism: GPipe and interleaved-1F1B schedules over a mesh
axis, one process per rank.

Counterpart of `tensor2robot_tpu.parallel.pipeline_parallel`. Stage
parameters carry a leading stage dim sharded over the `pp` axis: each pp
rank holds the [v] block of chunks it runs. Microbatches flow through a
loop of ticks; on every tick every rank runs one stage chunk and one
`ppermute` hop, so activations move stage to stage while every stage
works on a different microbatch.

Two SCHEDULES share one tick skeleton (`_tick_plan`), as in the JAX
package:

* GPipe fill/drain (`num_virtual_stages == 1`): one stage per rank;
  bubble fraction (S-1)/(M+S-1).
* Interleaved 1F1B (`num_virtual_stages == v > 1`): each rank holds v
  chunks, microbatches stream around the ring v times in groups of S,
  and the fill is paid once: bubble (S-1)/(v*ceil(M/S)*S + S-1).

`schedule_accounting` prices any (S, M, v) in pure Python, and every
pipelined apply sets it as the `pp/*` gauges of `obs.metrics`.

Two PARAM LAYOUTS feed the same schedules:

* `pipelined_apply`: one shape-preserving stage function, every leaf
  stacked with a leading [S*v] dim;
* `pipelined_apply_heterogeneous`: a function per stage, each stage's
  parameters raveled to a flat vector in flax's key order and shapes
  (`ravel_stage_stack`), zero-padded to the widest, stacked [S*v, P_max];
  activations travel as zero-padded flat [mb, A_max] buffers. The plan's
  layer index is a Python int here, so a rank calls the one stage
  function it runs (JAX switches over all of them).

Interleaved placement: rank r holds layers {r, S+r, ..., (v-1)S+r};
stack position r*v + j holds layer j*S + r (`interleave_order`). Stacks
in depth order (`params_layout="layer"`) are permuted here; pre-permuted
ones (`"interleaved"`, the checkpoint layout of the pipelined model) are
used as they are.

How the schedule runs in the port. JAX scans the ticks and lets autodiff
transpose the scan; the port runs the ticks in an eager loop inside one
`torch.autograd.Function`, whose backward replays the schedule in
reverse. Two things follow:

* lockstep: every rank calls `ppermute` on every tick, forward and
  backward, fill, drain and padding ticks included (the ring would hang
  otherwise). An idle slot skips its compute: its output is zeros on the
  wire, as JAX masks it;
* the boundaries are the transposes of the multi-rank program, as
  `collectives.all_reduce_sum` is. The output is the psum over the pp
  ranks of the last rank's outputs, and its backward is the psum of the
  cotangents; the microbatches are read by rank 0 alone, so only rank 0's
  copy gets a cotangent. Each rank's gradients are therefore those of the
  SUM of every rank's loss: when all S pp ranks compute the same loss
  from the replicated output, a rank's stage block gets S times its
  share, and rank 0's microbatches S times theirs. The mesh train step
  divides every gradient by the mesh size after summing it over the
  ranks that hold the same block (`parallel.train_step`), which gives the
  global batch's gradient; a caller of the apply alone divides by S.

The microbatches a rank passes are its own: under PP x DP they are this
rank's rows of each microbatch (`batch_axis` names that axis, as in
JAX, and is checked, not used to move data).

`make_pipelined_train_step` holds this rank's blocks, so with v > 1 it
needs the interleaved layout (the JAX step permutes a depth-ordered stack
across devices in every step; the port's ranks hold blocks, not the
stack). Its `audit_name` (and its `cache`) wrap the step in
`obs.xray.XrayedFunction`, as the JAX package's `audit_name` does; the
X-ray's mesh gate keeps a step of more than one rank eager
(`cache/skipped_mesh`).
"""

from __future__ import annotations

import logging
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from tensor2robot_tpu_torch.models import optimizers as optimizers_lib
from tensor2robot_tpu_torch.obs import metrics as metrics_lib
from tensor2robot_tpu_torch.parallel import collectives

__all__ = ["pipelined_apply", "stack_stage_params",
           "shard_pipeline_tree", "make_pipelined_train_step",
           "ravel_stage_stack", "pipelined_apply_heterogeneous",
           "sequential_apply_heterogeneous", "schedule_accounting",
           "interleave_order", "interleave_stage_stack"]

_log = logging.getLogger(__name__)


# ---------------------------------------------------------------------------
# Static schedule accounting (pure Python).
# ---------------------------------------------------------------------------


def schedule_accounting(num_stages: int, num_micro: int,
                        num_virtual_stages: int = 1) -> Dict[str, Any]:
  """Prices a pipeline schedule from its static structure: `schedule`,
  `total_ticks`, `busy_ticks_per_rank`, `idle_ticks_per_rank`,
  `bubble_fraction` and `padded_microbatches` (an interleaved schedule
  admits microbatches in groups of S; a ragged last group pays idle
  slots). Every tick every rank runs one stage chunk and one hop."""
  s, m, v = int(num_stages), int(num_micro), int(num_virtual_stages)
  if s < 1 or m < 1 or v < 1:
    raise ValueError(
        f"schedule_accounting needs num_stages >= 1, num_micro >= 1, "
        f"num_virtual_stages >= 1; got ({s}, {m}, {v})")
  if v == 1:
    total = m + s - 1
    padded = 0
  else:
    groups = -(-m // s)
    total = groups * s * v + s - 1
    padded = groups * s - m
  busy = m * v
  return {
      "schedule": "gpipe" if v == 1 else "interleaved-1f1b",
      "num_stages": s,
      "num_micro": m,
      "num_virtual_stages": v,
      "total_ticks": total,
      "busy_ticks_per_rank": busy,
      "idle_ticks_per_rank": total - busy,
      "bubble_fraction": (total - busy) / total,
      "padded_microbatches": padded,
  }


def interleave_order(num_stages: int, num_virtual_stages: int) -> np.ndarray:
  """Permutation mapping sharded-stack position -> depth-order layer:
  position r*v + j holds layer j*S + r. Identity for v == 1."""
  s, v = int(num_stages), int(num_virtual_stages)
  return np.array([(k % v) * s + k // v for k in range(s * v)])


def _tree_map(fn: Callable, tree: Any) -> Any:
  if isinstance(tree, dict):
    return {k: _tree_map(fn, v) for k, v in tree.items()}
  return fn(tree)


def _leaves(tree: Any) -> List[Tuple[Tuple[str, ...], Any]]:
  """(path, leaf) pairs of a tree of dicts in sorted key order: the
  order of `jax.tree_util` and of `ravel_pytree`."""
  if isinstance(tree, dict):
    return [(((k,) + path), leaf) for k in sorted(tree)
            for path, leaf in _leaves(tree[k])]
  return [((), tree)]


def _rebuild(paths: Sequence[Tuple[str, ...]], values: Sequence[Any]) -> Any:
  if len(paths) == 1 and paths[0] == ():
    return values[0]
  out: Dict[str, Any] = {}
  for path, value in zip(paths, values):
    node = out
    for key in path[:-1]:
      node = node.setdefault(key, {})
    node[path[-1]] = value
  return out


def interleave_stage_stack(stacked: Any, num_stages: int,
                           num_virtual_stages: int) -> Any:
  """Permutes depth-ordered stacked stage params (leading [S*v] dim on
  every leaf) into the interleaved sharded layout (`interleave_order`)."""
  perm = torch.as_tensor(interleave_order(num_stages, num_virtual_stages))
  return _tree_map(lambda leaf: leaf[perm.to(leaf.device)], stacked)


def _validate_and_account(num_stages: int, num_micro: int,
                          num_virtual_stages: int,
                          batch_axis: Optional[str]) -> Dict[str, Any]:
  """Validation and the `pp/*` telemetry both apply paths share."""
  if num_micro < 1:
    raise ValueError(f"num_micro must be >= 1, got {num_micro}")
  if num_virtual_stages < 1:
    raise ValueError(
        f"num_virtual_stages must be >= 1, got {num_virtual_stages}")
  if batch_axis is not None and not isinstance(batch_axis, str):
    raise TypeError(f"batch_axis must be a mesh-axis name or None, "
                    f"got {batch_axis!r}")
  accounting = schedule_accounting(num_stages, num_micro,
                                   num_virtual_stages)
  reg = metrics_lib.get_registry()
  if num_micro < num_stages:
    # M < S leaves the ring more than half idle under GPipe.
    reg.counter("pp/degenerate_microbatching").inc()
    _log.warning(
        "pipeline schedule is bubble-dominated: num_micro=%d < "
        "num_stages=%d gives bubble fraction %.2f — raise the "
        "microbatch count (or num_virtual_stages) to fill the ring",
        num_micro, num_stages, accounting["bubble_fraction"])
  reg.gauge("pp/bubble_fraction").set(accounting["bubble_fraction"])
  reg.gauge("pp/total_ticks").set(float(accounting["total_ticks"]))
  reg.gauge("pp/num_virtual_stages").set(float(num_virtual_stages))
  return accounting


def _tick_plan(num_stages: int, num_micro: int, num_virtual_stages: int):
  """The static tick schedule: (total_ticks, out_ticks, plan), `plan(t,
  idx)` -> (valid, microbatch, chunk) for tick `t` on pp rank `idx`, all
  Python ints.

  Work item u = t - idx enumerates rank 0's injection order. GPipe: u is
  the microbatch. Interleaved: groups of S microbatches stream around the
  ring v times back to back (u = g*S*v + j*S + i -> microbatch g*S + i,
  chunk j); the group stride S*v matches the ring latency S, so loop
  j+1's item is back at rank 0 on the tick it is scheduled.
  `out_ticks[m]` is the tick whose rank-(S-1) output is microbatch m's
  final-layer result."""
  s, m_count, v = num_stages, num_micro, num_virtual_stages
  if v == 1:
    span = m_count
    out_ticks = [m + s - 1 for m in range(m_count)]
  else:
    groups = -(-m_count // s)
    span = groups * s * v
    out_ticks = [(m // s) * (s * v) + (v - 1) * s + (m % s) + s - 1
                 for m in range(m_count)]
  total_ticks = span + s - 1

  def plan(t: int, idx: int) -> Tuple[bool, int, int]:
    u = t - idx
    valid = 0 <= u < span
    u = min(max(u, 0), span - 1)
    if v == 1:
      micro_index, chunk = u, 0
    else:
      within = u % (s * v)
      chunk = within // s
      micro_index = (u // (s * v)) * s + within % s
      valid = valid and micro_index < m_count
    return valid, min(micro_index, m_count - 1), chunk

  return total_ticks, out_ticks, plan


def stack_stage_params(params_list):
  """Stacks per-stage param trees (dicts of tensors) into leading-[S]
  tensors, in depth order."""
  paths = [path for path, _ in _leaves(params_list[0])]
  columns = zip(*[[leaf for _, leaf in _leaves(p)] for p in params_list])
  return _rebuild(paths, [torch.stack(list(c)) for c in columns])


def _hop(tensor: torch.Tensor, group, perm) -> torch.Tensor:
  """One ring hop (no autograd: the schedule's backward makes its own).
  Over gloo a CUDA tensor's hop is staged, and `collectives.staged_calls`
  counts it."""
  if group.size == 1:
    return tensor
  return collectives._ppermute(tensor, group, perm)


class _Schedule:
  """One pipelined call's static parts: `stage(chunk, params, x)` runs
  this rank's chunk on a [mb, ...] activation, params being the chunk's
  slice of each block tensor, in order."""

  def __init__(self, stage, num_stages: int, num_micro: int, v: int,
               group):
    self.stage = stage
    self.group = group
    self.index = index = group.index
    self.total_ticks, out_ticks, self.plan = _tick_plan(num_stages,
                                                        num_micro, v)
    self.out_of_tick = {t: m for m, t in enumerate(out_ticks)}
    self.is_last = index == num_stages - 1
    self.perm = [(i, (i + 1) % num_stages) for i in range(num_stages)]
    self.inverse = [(dst, src) for src, dst in self.perm]

  def forward(self, micro: torch.Tensor, blocks: Sequence[torch.Tensor],
              keep_graph: bool):
    """(per-microbatch outputs of this rank, tick records for the
    backward)."""
    carry = torch.zeros_like(micro[0])
    outs = torch.zeros_like(micro)
    records = []
    leaves = ([[b[j].detach().requires_grad_(True) for b in blocks]
               for j in range(blocks[0].shape[0])] if keep_graph else None)
    for t in range(self.total_ticks):
      valid, m, chunk = self.plan(t, self.index)
      inject = self.index == 0 and valid and chunk == 0
      x = micro[m] if inject else carry
      record = None
      if not valid:
        y = torch.zeros_like(x)
      elif keep_graph:
        with torch.enable_grad():
          x_leaf = x.detach().requires_grad_(True)
          y = self.stage(chunk, leaves[chunk], x_leaf)
        record = (x_leaf, y, chunk, inject, m)
      else:
        y = self.stage(chunk, [b[chunk] for b in blocks], x)
      records.append(record)
      if self.is_last and t in self.out_of_tick:
        outs[self.out_of_tick[t]] = y.detach()
      carry = _hop(y.detach(), self.group, self.perm)
    return outs, (records, leaves)

  def backward(self, g_outs: torch.Tensor, saved, blocks, micro):
    """The reverse schedule: (cotangent of the microbatches, of each
    block)."""
    records, leaves = saved
    g_blocks = [torch.zeros_like(b) for b in blocks]
    g_micro = torch.zeros_like(micro)
    g_carry = torch.zeros_like(micro[0])
    for t in reversed(range(self.total_ticks)):
      # Rank r+1's cotangent of its carry is this rank's of y_t.
      g_y = _hop(g_carry, self.group, self.inverse)
      if self.is_last and t in self.out_of_tick:
        g_y = g_y + g_outs[self.out_of_tick[t]]
      record = records[t]
      g_carry = torch.zeros_like(g_carry)
      if record is None:
        continue
      x_leaf, y, chunk, inject, m = record
      grads = torch.autograd.grad(y, [x_leaf] + leaves[chunk], g_y,
                                  allow_unused=True)
      for i, g in enumerate(grads[1:]):
        if g is not None:
          g_blocks[i][chunk] += g
      if grads[0] is not None:
        if inject:
          g_micro[m] += grads[0]
        else:
          g_carry = grads[0]
    return g_micro, g_blocks


class _Pipeline(torch.autograd.Function):
  """The schedule as one differentiable op: (micro, *blocks) -> this
  rank's outputs, psum'd over the pp ranks (module docstring)."""

  @staticmethod
  def forward(ctx, schedule, micro, *blocks):
    outs, saved = schedule.forward(micro, blocks, keep_graph=True)
    ctx.schedule, ctx.saved = schedule, saved
    ctx.save_for_backward(micro, *blocks)
    return collectives.all_reduce(outs, schedule.group)

  @staticmethod
  def backward(ctx, g_out):
    micro, *blocks = ctx.saved_tensors
    schedule = ctx.schedule
    g_outs = collectives.all_reduce(g_out.contiguous(), schedule.group)
    g_micro, g_blocks = schedule.backward(g_outs, ctx.saved, blocks, micro)
    ctx.saved = None
    return (None, g_micro, *g_blocks)


def _run(schedule: _Schedule, micro: torch.Tensor,
         blocks: Sequence[torch.Tensor]) -> torch.Tensor:
  if torch.is_grad_enabled() and (micro.requires_grad or any(
      b.requires_grad for b in blocks)):
    return _Pipeline.apply(schedule, micro, *blocks)
  with torch.no_grad():
    outs, _ = schedule.forward(micro, blocks, keep_graph=False)
    return collectives.all_reduce(outs, schedule.group)


def _rank_blocks(stage_params: Any, group, v: int, params_layout: str,
                 local: bool, num_layers: int) -> Any:
  """This rank's [v] block of every leaf: the stack permuted to the
  interleaved layout (a depth-ordered one) and cut, or, with `local`,
  the block as given."""
  if params_layout not in ("layer", "interleaved"):
    raise ValueError(f"params_layout must be 'layer' or 'interleaved', "
                     f"got {params_layout!r}")
  leading = _leaves(stage_params)[0][1].shape[0]
  if local:
    if leading != v:
      raise ValueError(f"a rank's stage block has leading dim {leading}, "
                       f"want num_virtual_stages {v}")
    if v > 1 and params_layout == "layer" and group.size > 1:
      raise ValueError("a rank's block of a depth-ordered stack does not "
                       "hold its interleaved chunks: pass the interleaved "
                       "layout (interleave_stage_stack)")
    return stage_params
  if leading != num_layers:
    raise ValueError(
        f"stage_params leading dim {leading} != num_stages {group.size} "
        f"* num_virtual_stages {v}")
  if v > 1 and params_layout == "layer":
    stage_params = interleave_stage_stack(stage_params, group.size, v)
  return _tree_map(lambda leaf: leaf[group.index * v:(group.index + 1) * v],
                   stage_params)


def pipelined_apply(stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
                    stage_params: Any,
                    microbatches: torch.Tensor,
                    mesh,
                    axis_name: str = "pp",
                    batch_axis: Optional[str] = None,
                    num_virtual_stages: int = 1,
                    params_layout: str = "layer",
                    local: bool = False) -> torch.Tensor:
  """Runs microbatches through a pipeline of homogeneous stages.

  Args:
    stage_fn: (one stage chunk's params, activation [mb, ...]) ->
      activation of the same shape.
    stage_params: a tensor or dict of tensors, each with leading
      [num_stages * num_virtual_stages] dim (the whole stack); with
      `local`, this rank's [num_virtual_stages] block of the interleaved
      layout (what the mesh train step hands a `pp`-sharded leaf).
    microbatches: [num_microbatches, mb, ...], this rank's rows.
    mesh: a `parallel.mesh.Mesh` with `axis_name`; its size S is the pp
      rank count.
    batch_axis: the mesh axis the mb dim is split over, or None.
    num_virtual_stages: chunks per rank (v): 1 = GPipe, >1 = 1F1B.
    params_layout: "layer" (depth order) or "interleaved".

  Returns:
    [num_microbatches, mb, ...] outputs, the same on every pp rank.
  """
  group = mesh.group(axis_name)
  num_stages, v = group.size, int(num_virtual_stages)
  blocks = _rank_blocks(stage_params, group, v, params_layout, local,
                        num_stages * v)
  num_micro = microbatches.shape[0]
  _validate_and_account(num_stages, num_micro, v, batch_axis)
  paths = [path for path, _ in _leaves(blocks)]
  tensors = [leaf for _, leaf in _leaves(blocks)]

  def stage(chunk, params, x):
    return stage_fn(_rebuild(paths, params), x)

  schedule = _Schedule(stage, num_stages, num_micro, v, group)
  return _run(schedule, microbatches, tensors)


def make_pipelined_train_step(
    stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
    loss_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    optimizer,
    mesh,
    axis_name: str = "pp",
    batch_axis: Optional[str] = None,
    num_virtual_stages: int = 1,
    params_layout: str = "layer",
    donate: bool = True,
    audit_name: Optional[str] = None,
    cache=None) -> Callable:
  """A training step over the pipelined schedule: (stage_params,
  opt_state, microbatches, targets) -> (stage_params, opt_state, loss).

  `stage_params` and `opt_state` are this rank's blocks
  (`shard_pipeline_tree`; a dict of stacked tensors and the
  `models.optimizers` state over it); `microbatches` and `targets` this
  rank's [M, mb, ...] rows. `loss_fn(outputs, targets)` is the mean loss
  over the microbatches. Each block's gradient is summed over the ranks
  that hold the same block and divided by the mesh size (module
  docstring), so the update is the global batch's. With `donate` the
  optimizer writes the state's own tensors (`optimizers.in_place`). The
  loss returned is the mean over the mesh's ranks.

  `audit_name` wraps the step in `obs.xray.XrayedFunction(audit_name,
  ...)`, as the JAX package's does (graftlint's `pp-schedule-unaudited`
  asks every call site for one), with `cache` (an `obs.excache` cache or
  directory) as its cache; a `cache` alone X-rays the step under the name
  `pipelined_train_step`. On a mesh of more than one rank the X-ray does
  not compile the step (`cache/skipped_mesh`): it runs eagerly."""
  v = int(num_virtual_stages)
  if v > 1 and params_layout == "layer" and mesh.group(axis_name).size > 1:
    raise ValueError(
        "make_pipelined_train_step holds each rank's block of the stack: "
        "with num_virtual_stages > 1 place the interleaved stack "
        "(interleave_stage_stack) and pass params_layout='interleaved'")
  outside = mesh.group(tuple(a for a in mesh.axis_names if a != axis_name))
  world = mesh.group(mesh.axis_names)

  def step(stage_params, opt_state, microbatches, targets):
    leaves = _tree_map(lambda p: p.detach().requires_grad_(True),
                       stage_params)
    outputs = pipelined_apply(stage_fn, leaves, microbatches, mesh,
                              axis_name=axis_name, batch_axis=batch_axis,
                              num_virtual_stages=v,
                              params_layout=params_layout, local=True)
    loss = loss_fn(outputs, targets)
    flat = _leaves(leaves)
    grads = torch.autograd.grad(loss, [leaf for _, leaf in flat])
    grads = [collectives.all_reduce(g, outside) / mesh.size for g in grads]
    grads = _rebuild([path for path, _ in flat], grads)
    with torch.no_grad(), optimizers_lib.in_place(donate):
      updates, opt_state = optimizer.update(grads, opt_state, stage_params)
      stage_params = optimizers_lib.apply_updates(stage_params, updates)
    mean = collectives.all_reduce(loss.detach().reshape(()), world)
    return stage_params, opt_state, mean / mesh.size

  if audit_name is not None or cache is not None:
    from tensor2robot_tpu_torch.obs import xray as xray_lib

    return xray_lib.XrayedFunction(audit_name or "pipelined_train_step",
                                   step, cache=cache, mesh=mesh,
                                   donate_argnums=(0, 1) if donate else ())
  return step


def ravel_stage_stack(stage_params_list: Sequence[Any]):
  """Packs heterogeneous per-stage param trees into one [S, P_max]
  tensor, in depth order: each tree raveled in sorted key order (flax's)
  with its own shapes, zero-padded to the widest. Returns (stacked,
  unravel_fns, sizes): `unravel_fns[s]` rebuilds stage s's tree from
  `stacked[s, :sizes[s]]` (views, so gradients flow to the vector)."""
  flats, unravels = [], []
  for params in stage_params_list:
    pairs = _leaves(params)
    paths = [path for path, _ in pairs]
    shapes = [tuple(leaf.shape) for _, leaf in pairs]
    flats.append(torch.cat([torch.as_tensor(leaf).reshape(-1)
                            for _, leaf in pairs]))

    def unravel(vec, paths=paths, shapes=shapes):
      pieces, offset = [], 0
      for shape in shapes:
        count = int(np.prod(shape))
        pieces.append(vec[offset:offset + count].reshape(shape))
        offset += count
      return _rebuild(paths, pieces)

    unravels.append(unravel)
  sizes = [int(f.numel()) for f in flats]
  p_max = max(sizes)
  stacked = torch.stack([torch.nn.functional.pad(f, (0, p_max - f.numel()))
                         for f in flats])
  return stacked, unravels, sizes


def _padded(y: torch.Tensor, a_max: int) -> torch.Tensor:
  return torch.nn.functional.pad(y, (0, a_max - y.shape[-1]))


def pipelined_apply_heterogeneous(
    stage_fns: Sequence[Callable[[Any, torch.Tensor], torch.Tensor]],
    unravel_fns: Sequence[Callable[[torch.Tensor], Any]],
    param_sizes: Sequence[int],
    stacked_params: torch.Tensor,
    microbatches: torch.Tensor,
    mesh,
    axis_name: str = "pp",
    batch_axis: Optional[str] = None,
    num_virtual_stages: int = 1,
    params_layout: str = "layer",
    local: bool = False) -> torch.Tensor:
  """Pipelines stages with different functions, params and activation
  shapes.

  Args:
    stage_fns: per-stage (params tree, flat activation [mb, A_max]) ->
      flat activation [mb, out_size_s], out_size_s <= A_max, in depth
      order; len == S * v. Padding back to A_max happens here.
    unravel_fns / param_sizes: from `ravel_stage_stack`, depth order.
    stacked_params: [S * v, P_max] (or, with `local`, this rank's [v,
      P_max] block of the interleaved layout).
    microbatches: [num_micro, mb, A_max], stage 0's inputs, this rank's
      rows.
    mesh / axis_name / batch_axis / num_virtual_stages / params_layout:
      as in `pipelined_apply`.

  Returns:
    [num_micro, mb, A_max] final-stage outputs (zero-padded), the same
    on every pp rank.
  """
  num_layers = len(stage_fns)
  v = int(num_virtual_stages)
  group = mesh.group(axis_name)
  num_stages = group.size
  if num_stages * v != num_layers:
    raise ValueError(
        f"mesh axis {axis_name!r} has size {num_stages} and "
        f"num_virtual_stages={v}, but {num_layers} stage functions were "
        f"given (want num_stages * num_virtual_stages stage functions)")
  block = _rank_blocks(stacked_params, group, v, params_layout, local,
                       num_layers)
  num_micro, _, a_max = microbatches.shape
  _validate_and_account(num_stages, num_micro, v, batch_axis)

  def stage(chunk, params, x):
    # Loop `chunk`'s visit to this rank is layer chunk*S + index.
    layer = chunk * num_stages + group.index
    vec = params[0]
    y = stage_fns[layer](unravel_fns[layer](vec[:param_sizes[layer]]), x)
    return _padded(y, a_max)

  schedule = _Schedule(stage, num_stages, num_micro, v, group)
  return _run(schedule, microbatches, [block])


def sequential_apply_heterogeneous(
    stage_fns: Sequence[Callable[[Any, torch.Tensor], torch.Tensor]],
    unravel_fns: Sequence[Callable[[torch.Tensor], Any]],
    param_sizes: Sequence[int],
    stacked_params: torch.Tensor,
    microbatches: torch.Tensor) -> torch.Tensor:
  """The same function without a mesh: every microbatch through every
  stage in depth order (the schedules are execution orders, not other
  functions). `stacked_params` is the depth-ordered stack."""
  num_micro, _, a_max = microbatches.shape
  outs = []
  for m in range(num_micro):
    x = microbatches[m]
    for s, fn in enumerate(stage_fns):
      y = fn(unravel_fns[s](stacked_params[s, :param_sizes[s]]), x)
      x = _padded(y, a_max)
    outs.append(x)
  return torch.stack(outs)


def shard_pipeline_tree(tree: Any, mesh, axis_name: str = "pp",
                        num_virtual_stages: int = 1) -> Any:
  """This rank's blocks of a tree for pipeline training: a tensor whose
  leading dim is a positive multiple of the `axis_name` rank count (a
  stage stack, for any chunk factor) is cut to this rank's contiguous
  block; everything else (counts, scalars) is kept whole. Tuples and
  lists (an optimizer chain's state) are walked."""
  del num_virtual_stages  # any rank-count multiple is a stage stack
  group = mesh.group(axis_name)

  def place(x):
    if isinstance(x, dict):
      return {k: place(v) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
      return type(x)(place(v) for v in x)
    if not isinstance(x, torch.Tensor) or x.ndim < 1:
      return x
    dim0 = x.shape[0]
    if dim0 >= group.size and dim0 % group.size == 0:
      size = dim0 // group.size
      return x[group.index * size:(group.index + 1) * size].clone()
    return x

  return place(tree)
