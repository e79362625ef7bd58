"""The mesh, batch placement (`put_host_batch`, `place_batch`,
`DevicePrefetcher`), multi-host init, and the serving fleet's device
carve-out (`replica_device_groups`).

Counterpart of `tensor2robot_tpu.parallel.mesh`. The model of execution
differs from the JAX package's one controller over many devices: the
port runs ONE PROCESS PER RANK of a `torch.distributed` world, each on
its own device (several ranks may share one card).

* `create_mesh` lays the world's ranks out row-major over the named
  axes (the order of `mesh_shape`, as `jax.experimental.mesh_utils`
  lays CPU devices out), and creates, with every rank taking part, one
  process group for each set of axes whose ranks must talk (every
  subset of the axes larger than one rank). A process with no process
  group gets a mesh of size 1 and no groups, so every single-device
  caller keeps working unchanged. `Mesh.shape` is the JAX mesh's
  `{axis: size}`; `Mesh.devices` the array of ranks.
* A partition spec is a tuple with one entry per dim: a mesh axis name,
  a tuple of names (the dim split over their product, the first name
  major), or None; `()` replicates. `shard(x, mesh, spec)` is this
  rank's block of a full tensor; `unshard` gathers the blocks back.
* A batch is sharded by `batch_spec` (default: the leading dim over
  'data'; a sequence batch ('data', 'sp') also splits T): every rank
  reads the same GLOBAL host batch and keeps its block
  (`put_host_batch`), or, with `process_local=True`, is handed its own
  rows already (a multi-host input pipeline). The train step then runs
  on local blocks.
* `initialize_multihost` brings the world up from a coordinator address:
  NCCL for CUDA ranks, gloo for the CPU, or the `backend` named. Several
  ranks on one card need gloo (NCCL refuses two ranks on one device);
  gloo takes the card's tensors in its collectives, and
  `parallel.collectives` stages them through page-locked host memory
  for P2P, which gloo refuses on the card.

`place_batch(device, batch)` keeps the single-device placement inline,
and `DevicePrefetcher(dataset, device_or_mesh)` keeps `depth` batches
already on the device, placed by background threads while the device
runs the step.

On a CUDA device the prefetcher copies the way the card copies fastest
and overlaps: each host batch is first copied (a host memcpy, off the
consumer's thread) into a ring of `depth + 1` page-locked buffers per
leaf, then to the device with `non_blocking=True` on a side
`torch.cuda.Stream`, which runs beside the step's kernels. An event
recorded after each batch's copies is waited on by the consumer's
stream before the step reads the batch; the device tensors are
`record_stream`ed on the consumer's stream, so the allocator does not
hand their memory to the next copy while the step still reads it; and a
page-locked buffer is reused only after its last copy's event has
fired. From pageable memory the same copy would be staged by the driver
and run synchronously with the host.

On a CPU device the same threads and queue run with no page-locked
buffers and no copy: a choice by device, not a fallback.
"""

from __future__ import annotations

import collections
import dataclasses
import itertools
import logging
import math
import queue
import socket
import threading
import time
import weakref
from typing import Any, Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from tensor2robot_tpu_torch import specs as specs_lib
from tensor2robot_tpu_torch.obs import metrics as obs_metrics
from tensor2robot_tpu_torch.utils import device as device_lib

__all__ = ["DEFAULT_AXES", "Mesh", "AxisGroup", "PartitionSpec",
           "NamedSharding", "create_mesh", "data_sharding", "replicated",
           "local_batch_size", "shard", "unshard", "put_host_batch",
           "place_batch", "DevicePrefetcher", "replica_device_groups",
           "initialize_multihost"]

_log = logging.getLogger(__name__)

DEFAULT_AXES = ("data", "fsdp", "model")

# Copy timings kept for `copy_ms()` (the newest ones).
_TIMED_COPIES = 64


class PartitionSpec(tuple):
  """A partition spec: one entry per dim, a mesh axis name, a tuple of
  names or None; `PartitionSpec()` replicates. A tuple, with
  `jax.sharding.PartitionSpec`'s constructor."""

  def __new__(cls, *axes):
    return super().__new__(cls, axes)

  def __repr__(self) -> str:
    return f"PartitionSpec{tuple(self)!r}"


def _spec_axes(entry) -> Tuple[str, ...]:
  if entry is None:
    return ()
  return (entry,) if isinstance(entry, str) else tuple(entry)


@dataclasses.dataclass(frozen=True)
class AxisGroup:
  """The ranks of this rank's group over a set of mesh axes: `ranks` in
  group order (the axes' coordinates row-major, which is ascending global
  rank), this rank's `index` in it, and the process group (None when the
  group is this rank alone)."""

  axes: Tuple[str, ...]
  ranks: Tuple[int, ...]
  index: int
  group: Any = None

  @property
  def size(self) -> int:
    return len(self.ranks)


class Mesh:
  """Named axes over the ranks of the process group (module docstring).

  `shape` ({axis: size}, in axis order), `axis_names`, `devices` (the
  numpy array of global ranks, shaped like the mesh), `size`, `rank`
  (this process's global rank), `device` (where this rank computes),
  `axis_index(axis)`, `axis_size(axis)`, `group(axes)` (the
  `AxisGroup` of this rank over those axes) and `agree(*flags)` (host
  flags agreed over the ranks). `is_primary` is rank 0, the one that
  writes files."""

  def __init__(self, devices: np.ndarray, axis_names: Sequence[str],
               device: torch.device, dcn_data_parallelism: int = 1):
    self.devices = np.asarray(devices)
    self.axis_names = tuple(axis_names)
    self.shape = collections.OrderedDict(
        (name, int(size)) for name, size in zip(self.axis_names,
                                                self.devices.shape))
    self.device = torch.device(device)
    self.dcn_data_parallelism = int(dcn_data_parallelism)
    self.rank = dist.get_rank() if _world_size() > 1 else 0
    where = np.argwhere(self.devices == self.rank)
    self.in_mesh = len(where) == 1
    self._coords = tuple(int(c) for c in where[0]) if self.in_mesh else None
    self._groups: Dict[Tuple[str, ...], AxisGroup] = {}
    # Every rank of the world takes part in creating every group, in the
    # same order, so each axis subset's groups exist on all ranks before
    # any rank can talk over them.
    for count in range(1, len(self.axis_names) + 1):
      for axes in itertools.combinations(self.axis_names, count):
        self._create_groups(axes)
    # Host flags travel over gloo on CPU tensors, whatever the world's
    # backend: agreeing on them never waits for the device.
    self._host_group = (dist.new_group(sorted(int(r) for r in
                                              self.devices.flat),
                                       backend="gloo")
                        if self.size > 1 else None)

  @property
  def size(self) -> int:
    return int(self.devices.size)

  @property
  def is_primary(self) -> bool:
    return self.rank == 0

  def axis_size(self, axis: str) -> int:
    return self.shape[axis]

  def axis_index(self, axis: str) -> int:
    """This rank's coordinate on `axis` (`jax.lax.axis_index`)."""
    if self._coords is None:
      raise ValueError(f"rank {self.rank} is not in this mesh")
    return self._coords[self.axis_names.index(axis)]

  def _normalized(self, axes) -> Tuple[str, ...]:
    axes = _spec_axes(axes)
    unknown = [a for a in axes if a not in self.shape]
    if unknown:
      raise KeyError(f"mesh has no axes {unknown}; it has "
                     f"{dict(self.shape)}")
    return tuple(a for a in self.axis_names if a in axes)

  def _members(self, axes: Tuple[str, ...]) -> List[Tuple[int, ...]]:
    """All groups over `axes`: the ranks varying along `axes` with the
    other coordinates fixed, each list in row-major order of `axes`."""
    moved = np.moveaxis(self.devices,
                        [self.axis_names.index(a) for a in axes],
                        list(range(-len(axes), 0)))
    flat = moved.reshape(-1, math.prod(self.shape[a] for a in axes))
    return [tuple(int(r) for r in row) for row in flat]

  def _create_groups(self, axes: Tuple[str, ...]) -> None:
    members = self._members(axes)
    size = len(members[0])
    mine = next((m for m in members if self.rank in m), None)
    group = None
    if size > 1:
      for ranks in members:
        created = dist.new_group(list(ranks))
        if ranks == mine:
          group = created
    if mine is not None:
      self._groups[axes] = AxisGroup(axes=axes, ranks=mine,
                                     index=mine.index(self.rank),
                                     group=group)

  def agree(self, *flags: bool) -> Tuple[bool, ...]:
    """Each flag, True when it is set on any rank of the mesh: one
    all-reduce (max) of a CPU tensor over a gloo group, so it costs a
    host round trip and no device sync (collective)."""
    if self.size == 1:
      return tuple(bool(f) for f in flags)
    values = torch.tensor([1 if f else 0 for f in flags], dtype=torch.int32)
    dist.all_reduce(values, op=dist.ReduceOp.MAX, group=self._host_group)
    return tuple(bool(v) for v in values.tolist())

  def group(self, axes) -> AxisGroup:
    """This rank's `AxisGroup` over `axes` (a name or names; () is this
    rank alone)."""
    axes = self._normalized(axes)
    if not axes:
      return AxisGroup(axes=(), ranks=(self.rank,), index=0)
    return self._groups[axes]

  def __repr__(self) -> str:
    return (f"Mesh({dict(self.shape)}, rank={self.rank}, "
            f"device={self.device})")


@dataclasses.dataclass(frozen=True)
class NamedSharding:
  """A partition spec on a mesh (`jax.sharding.NamedSharding`)."""

  mesh: Mesh
  spec: PartitionSpec


def _world_size() -> int:
  return dist.get_world_size() if dist.is_initialized() else 1


def create_mesh(mesh_shape: Optional[Sequence[int]] = None,
                axis_names: Sequence[str] = DEFAULT_AXES,
                devices: Optional[Sequence[int]] = None,
                dcn_data_parallelism: int = 1,
                device=None) -> Mesh:
  """A `Mesh` over the world's ranks (or over `devices`, a list of
  global ranks), computing on `device` (CUDA unless named; raises
  without a card).

  With `mesh_shape=None` every rank goes on the first ('data') axis. A
  shape that needs more ranks than there are raises; a smaller one takes
  a prefix of the ranks (the rest are outside the mesh). With
  `dcn_data_parallelism > 1` the outer axis spans hosts: the ranks are
  laid out host-major (a launcher numbers them host by host), so the
  first axis's outermost `dcn_data_parallelism` blocks are the hosts,
  and it must divide that axis."""
  devices = list(devices if devices is not None else range(_world_size()))
  n = len(devices)
  if mesh_shape is None:
    mesh_shape = [n] + [1] * (len(axis_names) - 1)
  mesh_shape = [int(s) for s in mesh_shape]
  needed = math.prod(mesh_shape)
  if needed > n:
    raise ValueError(f"mesh_shape {mesh_shape} does not cover {n} devices.")
  devices = devices[:needed]
  if len(mesh_shape) != len(axis_names):
    raise ValueError(
        f"mesh_shape rank {len(mesh_shape)} != axis_names "
        f"{len(axis_names)}.")
  if dcn_data_parallelism > 1 and mesh_shape[0] % dcn_data_parallelism:
    raise ValueError(
        f"dcn_data_parallelism {dcn_data_parallelism} does not divide the "
        f"{axis_names[0]!r} axis of mesh_shape {mesh_shape}")
  return Mesh(np.asarray(devices, dtype=np.int64).reshape(mesh_shape),
              axis_names, device_lib.resolve_device(device),
              dcn_data_parallelism)


def data_sharding(mesh: Mesh, batch_axis: str = "data") -> NamedSharding:
  """Sharding for batch leaves: leading dim over the data axis."""
  return NamedSharding(mesh, PartitionSpec(batch_axis))


def replicated(mesh: Mesh) -> NamedSharding:
  return NamedSharding(mesh, PartitionSpec())


def local_batch_size(global_batch_size: int, mesh: Mesh) -> int:
  """Per-process batch size: the global batch over the mesh's processes
  (one per rank)."""
  process_count = max(1, mesh.size)
  if global_batch_size % process_count:
    raise ValueError(
        f"Global batch {global_batch_size} not divisible by host count "
        f"{process_count}.")
  return global_batch_size // process_count


def _block(mesh: Mesh, entry, dim_size: int) -> Tuple[int, int]:
  """(start, length) of this rank's block of a dim of `dim_size` split
  over the axes of one spec entry."""
  axes = _spec_axes(entry)
  if not axes:
    return 0, dim_size
  group = mesh.group(axes)
  if dim_size % group.size:
    raise ValueError(f"dim of size {dim_size} does not split over the "
                     f"{group.size}-way axes {group.axes}")
  length = dim_size // group.size
  return group.index * length, length


def shard(x, mesh: Mesh, spec) -> Any:
  """This rank's block of the full tensor (or numpy array) `x` under
  `spec` (a view where slicing allows; dims past the spec whole)."""
  for dim, entry in enumerate(spec or ()):
    start, length = _block(mesh, entry, x.shape[dim])
    if length != x.shape[dim]:
      index = [slice(None)] * x.ndim
      index[dim] = slice(start, start + length)
      x = x[tuple(index)]
  return x


def unshard(x: torch.Tensor, mesh: Mesh, spec) -> torch.Tensor:
  """The full tensor from this rank's block `x` under `spec`: each split
  dim gathered over its axes (collective: every rank of those groups
  calls it)."""
  from tensor2robot_tpu_torch.parallel import collectives

  for dim, entry in enumerate(spec or ()):
    axes = _spec_axes(entry)
    if axes:
      x = collectives.all_gather(x, mesh.group(axes), dim=dim)
  return x


def _batch_spec_for(key: str, batch_axis: str, batch_spec,
                    flat_partition) -> Tuple:
  spec = tuple(batch_spec) if batch_spec is not None else (batch_axis,)
  if flat_partition is not None and key in flat_partition:
    spec = tuple(flat_partition[key])
  return spec


def put_host_batch(mesh: Mesh, batch, batch_axis: str = "data",
                   spec_structure=None, batch_spec=None,
                   process_local: bool = False) -> specs_lib.SpecStruct:
  """This rank's block of a host batch, on the mesh's device.

  Each leaf is split by `batch_spec` (default: its leading dim over
  `batch_axis`; `PartitionSpec('data', 'sp')` also splits dim 1), or by
  the spec structure's `partition_specs` where given. With
  `process_local`, `batch` already holds this rank's rows (a multi-host
  input pipeline feeds each process its own) and is placed as it is."""
  flat_partition = None
  if spec_structure is not None:
    flat_partition = specs_lib.partition_specs(spec_structure, batch_axis)
  out = specs_lib.SpecStruct()
  for key, value in specs_lib.flatten_spec_structure(batch).items():
    if not process_local:
      value = shard(value, mesh, _batch_spec_for(key, batch_axis, batch_spec,
                                                 flat_partition))
    if isinstance(value, np.ndarray):
      value = torch.from_numpy(np.ascontiguousarray(value))
    out[key] = (value.to(mesh.device, non_blocking=True)
                if isinstance(value, torch.Tensor) else value)
  return out


def replica_device_groups(num_replicas: int, devices=None) -> list:
  """Carves `devices` into `num_replicas` disjoint groups of contiguous
  runs of the list (the serving fleet's per-replica device groups).

  `devices` defaults to `torch.device('cuda', i)` for every visible
  card. A remainder (len(devices) % num_replicas) is spread one extra
  device over the FIRST groups rather than left idle; the fleet's
  least-outstanding-work router absorbs the uneven capacity. The list is
  carved as given: a caller that puts one card in it twice gets two
  replicas on that card, each with its own state."""
  if devices is None:
    devices = [torch.device("cuda", i)
               for i in range(torch.cuda.device_count())]
  devices = list(devices)
  if num_replicas < 1:
    raise ValueError(f"num_replicas must be >= 1, got {num_replicas}")
  if num_replicas > len(devices):
    raise ValueError(
        f"cannot carve {num_replicas} replica device groups out of "
        f"{len(devices)} devices (>= 1 device per replica required)")
  base, remainder = divmod(len(devices), num_replicas)
  groups = []
  offset = 0
  for index in range(num_replicas):
    size = base + (1 if index < remainder else 0)
    groups.append(devices[offset:offset + size])
    offset += size
  return groups


def _placed(values, device: torch.device) -> specs_lib.SpecStruct:
  out = specs_lib.SpecStruct()
  for key, value in specs_lib.flatten_spec_structure(values).items():
    out[key] = (value.to(device, non_blocking=True)
                if isinstance(value, torch.Tensor) else value)
  return out


def place_batch(device, batch, batch_spec=None
                ) -> Tuple[specs_lib.SpecStruct, specs_lib.SpecStruct]:
  """One host batch `{features, labels}` -> (features, labels), inline:
  on `device`, or, given a `Mesh`, this rank's block by `batch_spec`
  (`put_host_batch`) on the mesh's device. Missing labels become an
  empty SpecStruct."""
  if isinstance(device, Mesh):
    place = lambda part: put_host_batch(device, part, batch_spec=batch_spec)
  else:
    device = torch.device(device)
    place = lambda part: _placed(part, device)
  features = place(batch["features"])
  labels = (place(batch["labels"]) if "labels" in batch
            else specs_lib.SpecStruct())
  return features, labels


def _host_block(mesh: Mesh, batch, batch_spec):
  """This rank's block of a host batch, left on the host."""
  out = {}
  for part in ("features", "labels"):
    if part in batch:
      block = specs_lib.SpecStruct()
      for key, value in specs_lib.flatten_spec_structure(
          batch[part]).items():
        block[key] = shard(value, mesh, _batch_spec_for(key, "data",
                                                        batch_spec, None))
      out[part] = block
  return out


class _PinnedCopier:
  """The CUDA placement of `DevicePrefetcher`: page-locked ring, side
  stream, one event per batch. Used by the placer thread only."""

  def __init__(self, device: torch.device, slots: int):
    self.device = device
    self.stream = torch.cuda.Stream(device)
    self._slots: List[Dict[str, torch.Tensor]] = [{} for _ in range(slots)]
    self._events: List[Optional[torch.cuda.Event]] = [None] * slots
    self._next = 0
    self.timings: Deque[Tuple[torch.cuda.Event, torch.cuda.Event]] = (
        collections.deque(maxlen=_TIMED_COPIES))

  def _pinned(self, slot: Dict[str, torch.Tensor], key: str,
              value: torch.Tensor) -> torch.Tensor:
    buf = slot.get(key)
    if buf is None or buf.shape != value.shape or buf.dtype != value.dtype:
      buf = torch.empty(value.shape, dtype=value.dtype, pin_memory=True)
      slot[key] = buf
    buf.copy_(value)
    return buf

  def __call__(self, batch):
    i = self._next
    self._next = (i + 1) % len(self._slots)
    if self._events[i] is not None:
      # The copy that last read this slot's buffers must be done before
      # they are overwritten.
      self._events[i].synchronize()
    slot = self._slots[i]
    hosts = {}
    for part in ("features", "labels"):
      if part in batch:
        for key, value in specs_lib.flatten_spec_structure(
            batch[part]).items():
          hosts[f"{part}/{key}"] = (
              self._pinned(slot, f"{part}/{key}", value)
              if isinstance(value, torch.Tensor) else value)
    start = torch.cuda.Event(enable_timing=True)
    done = torch.cuda.Event(enable_timing=True)
    with torch.cuda.device(self.device), torch.cuda.stream(self.stream):
      start.record(self.stream)
      placed = {k: (v.to(self.device, non_blocking=True)
                    if isinstance(v, torch.Tensor) else v)
                for k, v in hosts.items()}
      done.record(self.stream)
    self._events[i] = done
    self.timings.append((start, done))
    obs_metrics.counter("data/prefetch_pinned_batches").inc()
    features = specs_lib.SpecStruct()
    labels = specs_lib.SpecStruct()
    for key, value in placed.items():
      part, leaf = key.split("/", 1)
      (features if part == "features" else labels)[leaf] = value
    return features, labels, done


class DevicePrefetcher:
  """Background device infeed: keeps up to `depth` batches placed ahead.

  Iterating yields (features, labels) already on `device` (CUDA unless
  the caller names another; raises without a card); given a `Mesh`,
  this rank's block of each batch by `batch_spec` (cut on the host,
  before the copy) on the mesh's device. Two daemon threads
  do the work: a feeder takes host batches from `dataset` into a bounded
  host queue, and a placer copies them to the device (module docstring)
  into a queue of `depth` placed batches, so batch N+1's source wait
  overlaps batch N's copy and both overlap the step. `max_batches`
  bounds how many batches it takes from `dataset`. Exceptions in either
  thread are raised again in the consumer. `close()` (also called at
  the end of the stream) stops the threads promptly and, with
  `close_source`, closes `source` (default: `dataset`), e.g. the
  `OverlappedLoader` behind a derived generator, joining its stage
  threads. The context-manager protocol closes on exit, and a
  `weakref.finalize` backstop stops the threads of a collected but
  unclosed prefetcher.

  Telemetry: `data/overlap_place_ms` (host time to place a batch),
  `data/overlap_device_queue_depth`, `data/overlap_host_queue_depth`,
  `data/prefetch_pinned_batches` (batches copied from page-locked
  buffers on the side stream). `copy_ms()` gives the newest copies'
  device times, from CUDA events on the side stream.
  """

  _STOP = object()

  def __init__(self, dataset, device=None, depth: int = 2,
               max_batches: Optional[int] = None,
               close_source: bool = False, source=None, batch_spec=None):
    if depth < 1:
      raise ValueError(f"depth must be >= 1, got {depth}")
    if source is None:
      source = dataset
    if isinstance(device, Mesh):
      mesh = device
      dataset = (_host_block(mesh, batch, batch_spec) for batch in dataset)
      device = mesh.device
    self.device = device_lib.resolve_device(device)
    self._copier = (_PinnedCopier(self.device, depth + 1)
                    if self.device.type == "cuda" else None)
    self._source = source if close_source else None
    if max_batches is not None:
      # Take from the source only what the consumer will take.
      dataset = itertools.islice(dataset, max_batches)
    out_queue: "queue.Queue" = queue.Queue(maxsize=depth)
    host_queue: "queue.Queue" = queue.Queue(maxsize=depth)
    stop = threading.Event()
    self._queue = out_queue
    self._stop = stop
    self._done = False
    sentinel = self._STOP
    copier, target = self._copier, self.device
    place_hist = obs_metrics.histogram("data/overlap_place_ms")
    depth_gauge = obs_metrics.gauge("data/overlap_device_queue_depth")
    host_depth_gauge = obs_metrics.gauge("data/overlap_host_queue_depth")
    perf_counter_ns = time.perf_counter_ns

    # The threads close over locals only, never `self`, so an abandoned
    # prefetcher is collectable and its finalizer can fire.
    def _put(q, item) -> bool:
      while not stop.is_set():
        try:
          q.put(item, timeout=0.1)
          return True
        except queue.Full:
          continue
      return False

    def _feeder():
      try:
        for batch in dataset:
          if stop.is_set() or not _put(host_queue, batch):
            return
          host_depth_gauge.set(float(host_queue.qsize()))
        _put(host_queue, sentinel)
      except BaseException as e:  # noqa: BLE001 - raised in the consumer
        _put(host_queue, e)

    def _placer():
      try:
        while not stop.is_set():
          try:
            item = host_queue.get(timeout=0.1)
          except queue.Empty:
            continue
          if item is sentinel or isinstance(item, BaseException):
            _put(out_queue, item)
            return
          t0 = perf_counter_ns()
          if copier is not None:
            placed = copier(item)
          else:
            placed = (*place_batch(target, item), None)
          place_hist.record((perf_counter_ns() - t0) * 1e-6)
          if not _put(out_queue, placed):
            return
          depth_gauge.set(float(out_queue.qsize()))
      except BaseException as e:  # noqa: BLE001 - raised in the consumer
        _put(out_queue, e)

    self._feeder = threading.Thread(target=_feeder, daemon=True,
                                    name="device-prefetch-feed")
    self._thread = threading.Thread(target=_placer, daemon=True,
                                    name="device-prefetch")
    self._feeder.start()
    self._thread.start()
    self._finalizer = weakref.finalize(self, stop.set)

  @property
  def stream(self) -> Optional["torch.cuda.Stream"]:
    """The side stream the copies run on (None on the CPU)."""
    return self._copier.stream if self._copier is not None else None

  def copy_ms(self) -> List[float]:
    """Device time of each of the newest batches' copies (CUDA events on
    the side stream; waits for them). Empty on the CPU."""
    if self._copier is None:
      return []
    timings = list(self._copier.timings)
    for _, done in timings:
      done.synchronize()
    return [start.elapsed_time(done) for start, done in timings]

  def __iter__(self):
    return self

  def __next__(self):
    if self._done:
      raise StopIteration
    item = self._queue.get()
    if item is self._STOP:
      self.close()
      raise StopIteration
    if isinstance(item, BaseException):
      self.close()
      raise item
    features, labels, done = item
    if done is not None:
      consumer = torch.cuda.current_stream(self.device)
      consumer.wait_event(done)
      for value in itertools.chain(features.values(), labels.values()):
        if isinstance(value, torch.Tensor):
          value.record_stream(consumer)
    return features, labels

  def __enter__(self):
    return self

  def __exit__(self, exc_type, exc_value, traceback):
    self.close()
    return False

  def close(self, timeout: float = 60.0) -> None:
    """Stops the threads and waits for the placer's batch in flight.

    The threads check the stop event at least every 0.1 s, so the joins
    are normally bounded by one batch. A feeder blocked inside
    next(dataset) is unstuck by closing a closable source (an
    `OverlappedLoader`); one that stays blocked for `timeout` on a
    stalled source is abandoned, with an error logged.
    """
    self._done = True
    self._stop.set()
    self._thread.join()
    self._feeder.join(timeout=1.0)
    self._close_source()
    self._feeder.join(timeout=timeout)
    if self._feeder.is_alive():
      _log.error("DevicePrefetcher.close(): the feeder is still blocked in "
                 "next(dataset) on a stalled data source; abandoning its "
                 "daemon thread.")
    self._finalizer.detach()

  def _close_source(self) -> None:
    """Closes a `close_source=True` source once."""
    source, self._source = self._source, None
    if source is None or not hasattr(source, "close"):
      return
    try:
      source.close()
    except ValueError:
      # A plain generator executing in the feeder thread cannot be
      # closed from here; the feeder ends it at its next batch.
      pass


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None,
                         initialization_timeout_secs: float = 300.0,
                         heartbeat_timeout_secs: Optional[float] = None,
                         backend: Optional[str] = None,
                         device=None) -> None:
  """Brings up the `torch.distributed` world from a coordinator address
  ('<host>:<port>' of process 0, which listens there). A no-op when
  already initialized, or for one process unless a `backend` is named
  (a world of one, e.g. NCCL on one card).

  The backend is `backend` when given, else NCCL when `device` (default:
  CUDA when a card is visible) is a CUDA device and gloo on the CPU;
  there is no fallback from one to the other. Several ranks on one card
  need `backend='gloo'`: NCCL refuses two ranks on one device.

  A worker (process_id > 0) first probes the coordinator over plain TCP
  until it answers, within `initialization_timeout_secs`, so a dead or
  unreachable coordinator is a clear `RuntimeError` naming the address
  instead of a long hang; the process group gets the residual budget as
  its timeout. `heartbeat_timeout_secs`, when given, bounds each later
  collective instead (a peer silent that long fails the job)."""
  if dist.is_initialized():
    return
  if num_processes in (None, 1) and backend is None:
    return
  num_processes = int(num_processes or 1)
  process_id = int(process_id or 0)
  if backend is None:
    if device is None:
      device = "cuda" if torch.cuda.is_available() else "cpu"
    backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
  host, sep, port_str = (coordinator_address or "").rpartition(":")
  host = host.strip("[]")  # bracketed IPv6 literals
  if not sep or not port_str.isdigit():
    raise ValueError(
        f"coordinator_address {coordinator_address!r} must be "
        "'<host>:<port>' (e.g. '10.0.0.1:8476').")
  port = int(port_str)
  deadline = time.monotonic() + initialization_timeout_secs
  if process_id != 0:
    while True:
      try:
        socket.create_connection((host, port), timeout=5.0).close()
        break
      except OSError as exc:
        if time.monotonic() >= deadline:
          raise RuntimeError(
              f"multi-host bring-up failed for process {process_id}/"
              f"{num_processes}: coordinator {coordinator_address!r} "
              "did not become reachable within "
              f"{initialization_timeout_secs:.0f}s "
              f"({type(exc).__name__}: {exc}). Check that process 0 is "
              "alive and the address/port is reachable from this "
              "host.") from exc
        time.sleep(0.5)
  residual = max(1.0, deadline - time.monotonic())
  import datetime

  timeout = datetime.timedelta(
      seconds=heartbeat_timeout_secs if heartbeat_timeout_secs is not None
      else max(residual, 1800.0))
  store = dist.TCPStore(host, port, num_processes, process_id == 0,
                        timeout=datetime.timedelta(seconds=residual))
  dist.init_process_group(backend, store=store, rank=process_id,
                          world_size=num_processes, timeout=timeout)
