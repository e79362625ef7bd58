"""The collectives of `shard_map` over a mesh axis group, for the port's
one-process-per-rank model.

Counterpart of what the JAX package's `shard_map` regions call
(`jax.lax.all_to_all`, `ppermute`, `psum`, `axis_index`), on a
`parallel.mesh.AxisGroup`. Every function is the identity on a group of
one rank (no process group is touched), so a mesh of size 1 runs the
single-device math. Differentiable ones:

* `all_to_all` — split dim 0 into `group.size` chunks, chunk j to the
  group's rank j, received chunks stacked in source order; its own
  transpose (`AllToAll`).
* `ppermute` — send to `perm`'s destination, receive from its source,
  as `batch_isend_irecv` (P2P has no autograd); its backward is the
  inverse permutation (`PPermute`).
* `all_reduce_sum` — its backward is the same sum of the cotangents
  (`AllReduceSum`); batch norm's statistics over a sharded batch use it.
* `all_gather_batch` — the whole batch from each rank's rows; its
  backward hands each rank the sum of every rank's cotangent of its
  block, a reduce-scatter (`AllGather`); a loss that compares rows
  across the batch (Grasp2Vec's npairs) uses it.

Not differentiable: `all_reduce` (sum or max), `all_gather` and
`reduce_scatter` along a dim, `broadcast`, `barrier`.

The transport: NCCL takes the card's tensors directly. Several ranks on
ONE card cannot use NCCL (it refuses two ranks on one device), so they
share a gloo group. gloo takes the card's tensors in all-reduce,
all-gather, reduce-scatter, all-to-all and broadcast (it copies them
through the host itself), but not in P2P: a CUDA tensor in
`batch_isend_irecv` fails ("writev ... Bad address" on an H100). So
`ppermute` over a gloo group stages a CUDA tensor through page-locked
host memory: copied to the host, sent and received there, the result
copied back to the card. The choice is made from the group's backend and
the tensor's device, never by catching an error; the compute stays on
the card. `host_staging(True)` forces the staged path for CPU tensors
too (the CPU tests cover it that way). `staged_calls` counts staged
`ppermute`s.
"""

from __future__ import annotations

import contextlib
import threading
from typing import List, Sequence, Tuple

import torch
import torch.distributed as dist

__all__ = ["all_to_all", "ppermute", "all_reduce_sum", "all_reduce",
           "all_gather", "reduce_scatter", "broadcast", "barrier",
           "axis_index", "host_staging", "batch_group", "current_batch_group",
           "all_gather_batch", "AllToAll", "PPermute", "AllReduceSum",
           "AllGather", "staged_calls"]

_state = threading.local()
staged_calls = {"count": 0}


@contextlib.contextmanager
def host_staging(force: bool = True):
  """Within the block, `ppermute` over a gloo group stages its tensors
  through host buffers, CPU tensors included."""
  previous = getattr(_state, "force_staging", False)
  _state.force_staging = force
  try:
    yield
  finally:
    _state.force_staging = previous


@contextlib.contextmanager
def batch_group(group):
  """Within the block, batch statistics (batch norm's moments) are taken
  over the whole batch sharded across `group` (an `AxisGroup`, or None
  for this rank's rows alone)."""
  previous = getattr(_state, "batch_group", None)
  _state.batch_group = group
  try:
    yield
  finally:
    _state.batch_group = previous


def current_batch_group():
  """The `AxisGroup` of the enclosing `batch_group` block, or None."""
  group = getattr(_state, "batch_group", None)
  return group if group is not None and group.size > 1 else None


def axis_index(mesh, axis: str) -> int:
  """This rank's coordinate on `axis` (`jax.lax.axis_index`)."""
  return mesh.axis_index(axis)


def _staged(group, tensor: torch.Tensor) -> bool:
  if dist.get_backend(group.group) != "gloo":
    return False
  return tensor.is_cuda or getattr(_state, "force_staging", False)


def _to_host(tensor: torch.Tensor) -> torch.Tensor:
  """A host copy of `tensor`: page-locked for a CUDA tensor, so the copy
  is a DMA; a plain clone for a CPU one (the forced path)."""
  if tensor.is_cuda:
    host = torch.empty(tensor.shape, dtype=tensor.dtype, pin_memory=True)
    host.copy_(tensor)
    return host
  return tensor.clone()


def _host_buffer(like: torch.Tensor, shape) -> torch.Tensor:
  return torch.empty(shape, dtype=like.dtype, pin_memory=like.is_cuda)


def _run(group, tensor: torch.Tensor, out_shape, fn,
         p2p: bool = False) -> torch.Tensor:
  """Runs `fn(out, inp)` (a collective writing `out` from `inp`) on
  `tensor`, through host buffers when the transport of a P2P exchange
  needs them, and returns `out` on `tensor`'s device."""
  tensor = tensor.contiguous()
  if p2p and _staged(group, tensor):
    staged_calls["count"] += 1
    host_in = _to_host(tensor)
    host_out = _host_buffer(tensor, out_shape)
    fn(host_out, host_in)
    return host_out.to(tensor.device, non_blocking=False)
  out = torch.empty(out_shape, dtype=tensor.dtype, device=tensor.device)
  fn(out, tensor)
  return out


def all_reduce(tensor: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
  """The elementwise sum (or max) over the group's ranks, as a new
  tensor."""
  if group.size == 1:
    return tensor.clone()
  reduce_op = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]

  def fn(out, inp):
    out.copy_(inp)
    dist.all_reduce(out, op=reduce_op, group=group.group)

  return _run(group, tensor, tensor.shape, fn)


def all_gather(tensor: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
  """The group's blocks concatenated along `dim`, in group order."""
  if group.size == 1:
    return tensor
  moved = tensor.movedim(dim, 0)
  shape = (group.size * moved.shape[0],) + tuple(moved.shape[1:])

  def fn(out, inp):
    dist.all_gather_into_tensor(out, inp, group=group.group)

  return _run(group, moved, shape, fn).movedim(0, dim)


def reduce_scatter(tensor: torch.Tensor, group, dim: int = 0
                   ) -> torch.Tensor:
  """This rank's block along `dim` of the elementwise sum over the
  group's ranks."""
  if group.size == 1:
    return tensor
  moved = tensor.movedim(dim, 0)
  if moved.shape[0] % group.size:
    raise ValueError(f"dim of size {moved.shape[0]} does not split over "
                     f"{group.size} ranks")
  shape = (moved.shape[0] // group.size,) + tuple(moved.shape[1:])
  # torch 2.13 renamed the collective; the card's torch may predate that.
  scatter = getattr(dist, "reduce_scatter_single", None) \
      or dist.reduce_scatter_tensor

  def fn(out, inp):
    scatter(out, inp, group=group.group)

  return _run(group, moved, shape, fn).movedim(0, dim)


def broadcast(tensor: torch.Tensor, group, src_index: int = 0
              ) -> torch.Tensor:
  """The group's rank `src_index`'s `tensor` on every rank."""
  if group.size == 1:
    return tensor

  def fn(out, inp):
    out.copy_(inp)
    dist.broadcast(out, src=group.ranks[src_index], group=group.group)

  return _run(group, tensor, tensor.shape, fn)


def barrier(group) -> None:
  if group.size > 1:
    dist.barrier(group=group.group)


def _all_to_all(tensor: torch.Tensor, group) -> torch.Tensor:
  if tensor.shape[0] != group.size:
    raise ValueError(f"all_to_all takes [{group.size}, ...] (one chunk per "
                     f"rank), got {tuple(tensor.shape)}")

  def fn(out, inp):
    dist.all_to_all_single(out, inp, group=group.group)

  return _run(group, tensor, tensor.shape, fn)


def _ppermute(tensor: torch.Tensor, group,
              perm: Sequence[Tuple[int, int]]) -> torch.Tensor:
  """Sends `tensor` to the destination of this rank's pair in `perm`
  ((source, destination) group indices) and returns what its source
  sent; a rank no pair sends to gets zeros."""
  me = group.index
  send_to = [dst for src, dst in perm if src == me]
  recv_from = [src for src, dst in perm if dst == me]

  def fn(out, inp):
    ops: List[dist.P2POp] = []
    for dst in send_to:
      ops.append(dist.P2POp(dist.isend, inp, group.ranks[dst],
                            group=group.group))
    for src in recv_from:
      ops.append(dist.P2POp(dist.irecv, out, group.ranks[src],
                            group=group.group))
    if not recv_from:
      out.zero_()
    if ops:
      for request in dist.batch_isend_irecv(ops):
        request.wait()

  return _run(group, tensor, tensor.shape, fn, p2p=True)


class AllToAll(torch.autograd.Function):
  """`all_to_all` with its own transpose as its backward."""

  @staticmethod
  def forward(ctx, tensor, group):
    ctx.group = group
    return _all_to_all(tensor, group)

  @staticmethod
  def backward(ctx, grad):
    return _all_to_all(grad, ctx.group), None


class PPermute(torch.autograd.Function):
  """`ppermute`; its backward sends each cotangent back along the inverse
  permutation."""

  @staticmethod
  def forward(ctx, tensor, group, perm):
    ctx.group, ctx.perm = group, tuple(perm)
    return _ppermute(tensor, group, perm)

  @staticmethod
  def backward(ctx, grad):
    inverse = [(dst, src) for src, dst in ctx.perm]
    return _ppermute(grad, ctx.group, inverse), None, None


class AllReduceSum(torch.autograd.Function):
  """The sum over the group; the cotangent of every rank's copy of the
  sum flows back to every rank's addend, so the backward is the same
  sum."""

  @staticmethod
  def forward(ctx, tensor, group):
    ctx.group = group
    return all_reduce(tensor, group)

  @staticmethod
  def backward(ctx, grad):
    return all_reduce(grad, ctx.group), None


class AllGather(torch.autograd.Function):
  """`all_gather` over dim 0; every rank's copy of the gathered batch
  sends its cotangent back, so a rank's block receives their sum."""

  @staticmethod
  def forward(ctx, tensor, group):
    ctx.group = group
    return all_gather(tensor, group)

  @staticmethod
  def backward(ctx, grad):
    return reduce_scatter(grad.contiguous(), ctx.group), None


def all_to_all(tensor: torch.Tensor, group) -> torch.Tensor:
  """Differentiable all_to_all over dim 0 of [group.size, ...]."""
  if group.size == 1:
    return tensor
  return AllToAll.apply(tensor, group)


def ppermute(tensor: torch.Tensor, group,
             perm: Sequence[Tuple[int, int]]) -> torch.Tensor:
  """Differentiable `jax.lax.ppermute` over the group's indices."""
  if group.size == 1:
    return tensor
  return PPermute.apply(tensor, group, tuple(perm))


def all_reduce_sum(tensor: torch.Tensor, group) -> torch.Tensor:
  """Differentiable sum over the group (`jax.lax.psum`)."""
  if group is None or group.size == 1:
    return tensor
  return AllReduceSum.apply(tensor, group)


def all_gather_batch(tensor: torch.Tensor, group) -> torch.Tensor:
  """Differentiable: the whole batch from this rank's rows, the group's
  equal blocks concatenated on dim 0 in group order (None or a group of
  one: `tensor`)."""
  if group is None or group.size == 1:
    return tensor
  return AllGather.apply(tensor, group)
