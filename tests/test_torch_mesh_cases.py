"""The port's side of the mesh tests: functions run on every rank of a
CPU gloo world by `test_torch_mesh_world.run_world` (torch only: the ranks
never import JAX). It holds no test itself.

Each takes (rank, world_size, payload) and returns plain Python and
numpy. A case that gathers a sharded result does so on every rank (the
gathers are collectives) and returns it from rank 0.
"""

import os
import signal

import numpy as np
import torch

from tensor2robot_tpu_torch import bridge
from tensor2robot_tpu_torch import checkpoints
from tensor2robot_tpu_torch import train_eval
from tensor2robot_tpu_torch.models import optimizers
from tensor2robot_tpu_torch.models import sequence_model
from tensor2robot_tpu_torch.ops import attention
from tensor2robot_tpu_torch.parallel import collectives
from tensor2robot_tpu_torch.parallel import mesh as mesh_lib
from tensor2robot_tpu_torch.parallel import train_step as ts
from tensor2robot_tpu_torch.utils import mocks

CPU = torch.device("cpu")
IO_SPEC = ("data", None, "sp", None)
SEQ_WIDTHS = dict(obs_size=6, action_size=3, sequence_length=16,
                  hidden_size=16, num_blocks=2, num_heads=2)


def _mesh(shape, names):
  return mesh_lib.create_mesh(shape, names, device="cpu")


def _tensor(x):
  return torch.from_numpy(np.asarray(x))


def _numpy(x):
  return x.detach().float().cpu().numpy()


def _catch(fn):
  """(True, message) when fn raises ValueError, else (False, None)."""
  try:
    fn()
  except ValueError as e:
    return True, str(e)
  return False, None


# -- sequence-parallel attention ----------------------------------------------


def _local(mesh, *arrays):
  return [mesh_lib.shard(_tensor(a), mesh, IO_SPEC) for a in arrays]


def _full(mesh, x):
  return _numpy(mesh_lib.unshard(x, mesh, IO_SPEC))


def _attention_cases(mesh, payload):
  out = {}
  for causal in (False, True):
    q, k, v = _local(mesh, *payload["qkv_2_2_32_8"])
    out[f"ring_causal{causal}"] = _full(
        mesh, attention.ring_attention(q, k, v, mesh, causal=causal))
    out[f"ring_chunked_causal{causal}"] = _full(
        mesh, attention.ring_attention(q, k, v, mesh, causal=causal,
                                       block_k=4))
    q, k, v = _local(mesh, *payload["qkv_2_8_32_8"])
    out[f"ulysses_causal{causal}"] = _full(
        mesh, attention.ulysses_attention(q, k, v, mesh, causal=causal))
  q, k, v = _local(mesh, *payload["qkv_2_4_32_8"])
  out["ring_h4"] = _full(mesh, attention.ring_attention(q, k, v, mesh,
                                                        causal=True))
  out["ulysses_h4"] = _full(mesh, attention.ulysses_attention(
      q, k, v, mesh, causal=True))
  out["ulysses_flash_h4"] = _full(mesh, attention.ulysses_attention(
      q, k, v, mesh, causal=True, inner="flash"))

  def grads(fn, arrays):
    leaves = [x.requires_grad_(True) for x in _local(mesh, *arrays)]
    fn(*leaves).sum().backward()
    return [_full(mesh, x.grad) for x in leaves]

  out["ring_grads"] = grads(lambda q, k, v: attention.ring_attention(
      q, k, v, mesh, causal=True), payload["qkv_2_1_16_4"])
  out["ulysses_grads"] = grads(lambda q, k, v: attention.ulysses_attention(
      q, k, v, mesh, causal=True), payload["qkv_2_8_16_4"])
  out["ring_chunked_grads"] = grads(lambda q, k, v: attention.ring_attention(
      q, k, v, mesh, causal=True, block_k=2), payload["qkv_2_1_16_4"])
  q, k, v = _local(mesh, *payload["qkv_2_1_16_4"])
  out["bad_block_k"] = _catch(lambda: attention.ring_attention(
      q, k, v, mesh, block_k=3))
  q, k, v = _local(mesh, *payload["qkv_2_2_32_8"])
  out["indivisible_heads"] = _catch(lambda: attention.ulysses_attention(
      q, k, v, mesh))
  return out


def _module_cases(mesh, payload):
  """`MultiHeadAttention` with the ring against the plain backend, one
  set of weights (every rank holds the whole batch's T block)."""
  from tensor2robot_tpu_torch.layers.attention_layers import (
      MultiHeadAttention)

  torch.manual_seed(0)
  ref = MultiHeadAttention(12, num_heads=2, head_dim=8, causal=True)
  ring = MultiHeadAttention(12, num_heads=2, head_dim=8, causal=True,
                            backend="ring", mesh=mesh)
  ring.load_state_dict(ref.state_dict())
  x = _tensor(payload["module_x"])
  spec = (None, "sp", None)
  with torch.no_grad():
    want = _numpy(ref(x))
    got = _numpy(mesh_lib.unshard(ring(mesh_lib.shard(x, mesh, spec)), mesh,
                                  spec))
  return {"module_ring": got, "module_reference": want}


# -- sequence model train steps -------------------------------------------------


def _seq_model(backend, lr=1e-2, **kwargs):
  widths = {**SEQ_WIDTHS, **kwargs}
  return sequence_model.SequenceRegressionModel(
      attention_backend=backend,
      optimizer_fn=lambda: optimizers.create_sgd_optimizer(lr), **widths)


def _seq_step(mesh, payload, backend, rules=None, steps=1, **kwargs):
  """Loss(es), the gathered new parameters and the sharded leaves of
  `steps` SGD steps on the bridged parameters and the global batch."""
  model = _seq_model(backend, **kwargs)
  model.set_mesh(mesh)
  params = {k: _tensor(v) for k, v in payload["seq_params"].items()}
  state, shardings = bridge.train_state_on_mesh(
      ts.init_train_state(model, params), mesh, rules)
  spec = model.batch_partition_spec
  features = mesh_lib.put_host_batch(mesh, payload["seq_features"],
                                     batch_spec=spec)
  labels = mesh_lib.put_host_batch(mesh, payload["seq_labels"],
                                   batch_spec=spec)
  step = ts.make_train_step(model, mesh=mesh, shardings=shardings,
                            batch_spec=spec, donate=False)
  losses = []
  for _ in range(steps):
    state, metrics = step(state, features, labels)
    losses.append(float(metrics["loss"]))
  full = bridge.state_to_numpy(state, shardings)
  return {"losses": losses, "params": full["params"],
          "sharded": {k: tuple(v.spec) for k, v in shardings.params.items()
                      if v.spec}}


def _set_mesh_cases(mesh):
  no_sp = _mesh((2, 1, 1), ("data", "fsdp", "model"))
  return {
      "seq15": _catch(lambda: _seq_model("ring", sequence_length=15)
                      .set_mesh(mesh)),
      "no_sp": _catch(lambda: _seq_model("ring").set_mesh(no_sp)),
      "no_mesh": _catch(lambda: _seq_model("ring").create_module()),
      "heads3": _catch(lambda: _seq_model("ulysses", num_heads=3)
                       .set_mesh(mesh)),
  }


def sequence_parallel_world(rank, world_size, payload):
  """The cases of tests/test_torch_sequence_parallel.py, on 8 ranks."""
  del world_size
  out = {}
  attn_mesh = _mesh((2, 4, 1), ("data", "sp", "model"))
  out.update(_attention_cases(attn_mesh, payload))
  out.update(_module_cases(_mesh((1, 8, 1), ("data", "sp", "model")),
                           payload))
  # The 4-rank sequence-parallel steps run on ranks 0-3 (a prefix mesh);
  # every rank takes part in making each mesh's groups.
  sp_mesh = _mesh((2, 2, 1), ("data", "sp", "model"))
  set_mesh = _set_mesh_cases(sp_mesh)
  if sp_mesh.in_mesh:
    out["set_mesh"] = set_mesh
    for name, backend, kwargs in (
        ("ring", "ring", {}), ("ulysses", "ulysses", {}),
        ("ulysses_flash", "ulysses", {"ulysses_inner": "flash"})):
      out[f"step_{name}"] = _seq_step(sp_mesh, payload, backend, **kwargs)
    out["ring_30_steps"] = _seq_step(sp_mesh, payload, "ring", steps=30,
                                     lr=3e-3)["losses"]
  composite = _mesh((2, 2, 2), ("data", "fsdp", "sp"))
  out["step_composite"] = _seq_step(composite, payload, "ring",
                                    rules=ts.fsdp_rules())
  return out if rank == 0 else {"rank": rank}


# -- the mesh, data parallelism, FSDP, checkpoints --------------------------------


def _mock_batches(batch_size, count, seed=0):
  generator = mocks.MockInputGenerator(batch_size=batch_size, seed=seed)
  model = mocks.MockT2RModel()
  generator.set_specification_from_model(model, "train")
  dataset = generator.create_dataset("train")
  return [next(dataset) for _ in range(count)]


def _place(mesh, batch):
  return mesh_lib.place_batch(mesh, batch)


def _sgd_mock():
  return mocks.MockT2RModel(
      optimizer_fn=lambda: optimizers.create_sgd_optimizer(1e-2))


def _mock_state(model, mesh, payload, rules=None):
  """The bridged JAX init (params and batch statistics) on the mesh."""
  params = {k: _tensor(v) for k, v in payload["mock_params"].items()}
  state = ts.init_train_state(model, params)
  state = state.replace(mutable_state={
      k: _tensor(v) for k, v in payload["mock_mutable"].items()})
  return bridge.train_state_on_mesh(state, mesh, rules)


def _data_parallel_cases(mesh, payload):
  out = {}
  batches = _mock_batches(32, 301)
  # One SGD step against the JAX package's data-parallel step.
  model = _sgd_mock()
  state, shardings = _mock_state(model, mesh, payload)
  step = ts.make_train_step(model, mesh=mesh, shardings=shardings,
                            donate=False)
  features, labels = _place(mesh, {"features": payload["mock_features"],
                                   "labels": payload["mock_labels"]})
  new, metrics = step(state, features, labels)
  out["dp_step"] = {"loss": float(metrics["loss"]),
                    "norm": float(metrics["global_gradient_norm"]),
                    **bridge.state_to_numpy(new, shardings)}
  out["dp_input_unchanged"] = all(
      torch.equal(state.params[k], _tensor(v))
      for k, v in payload["mock_params"].items())
  # Loss decreases over 200 steps; the step count; donated state.
  model = mocks.MockT2RModel()
  state, shardings = ts.create_train_state(
      model, torch.Generator().manual_seed(0), CPU, mesh=mesh)
  step = ts.make_train_step(model, mesh=mesh, shardings=shardings)
  before_ptr = state.params["head.weight"].data_ptr()
  losses = []
  for batch in batches[:200]:
    state, metrics = step(state, *_place(mesh, batch))
    losses.append(float(metrics["loss"]))
  out["dp_losses"] = losses
  out["dp_step_count"] = state.step
  out["dp_donated"] = state.params["head.weight"].data_ptr() == before_ptr
  eval_step = ts.make_eval_step(model, mesh=mesh, shardings=shardings)
  out["dp_accuracy"] = float(eval_step(state, *_place(mesh, batches[0]))
                             ["accuracy"])
  out["dp_metric"] = float(metrics["loss"])
  predict = ts.make_predict_fn(model, mesh=mesh, shardings=shardings)
  out["dp_predict_shape"] = tuple(
      predict(state, _place(CPU, batches[0])[0])["prediction"].shape)
  # EMA and the bfloat16 policy.
  model = mocks.MockT2RModel(use_ema=True)
  state, shardings = ts.create_train_state(
      model, torch.Generator().manual_seed(0), CPU, mesh=mesh)
  step = ts.make_train_step(model, mesh=mesh, shardings=shardings)
  new, _ = step(state, *_place(mesh, batches[0]))
  out["dp_ema_moved_apart"] = not torch.allclose(
      new.params["dense_0.weight"], new.ema_params["dense_0.weight"])
  model = mocks.MockT2RModel(use_bfloat16=True)
  state, shardings = ts.create_train_state(
      model, torch.Generator().manual_seed(0), CPU, mesh=mesh)
  step = ts.make_train_step(model, mesh=mesh, shardings=shardings)
  new, metrics = step(state, *_place(mesh, batches[0]))
  out["dp_bf16"] = (float(metrics["loss"]),
                    str(new.params["dense_0.weight"].dtype))
  return out


def _moments(tree):
  """The param-shaped moment dicts of an optimizer state."""
  if isinstance(tree, dict):
    found = [tree[k] for k in ("mu", "nu", "trace") if k in tree]
    return found + [m for v in tree.values() for m in _moments(v)]
  if isinstance(tree, (tuple, list)):
    return [m for v in tree for m in _moments(v)]
  return []


def _fsdp_cases(mesh, payload):
  # Momentum under a global-norm clip: the clip reads the norm over every
  # rank's blocks, and the moments follow their parameters.
  model = mocks.MockT2RModel(
      optimizer_fn=lambda: optimizers.create_momentum_optimizer(
          1e-2, 0.9, gradient_clip_norm=0.05))
  state, shardings = _mock_state(model, mesh, payload, ts.fsdp_rules())
  step = ts.make_train_step(model, mesh=mesh, shardings=shardings,
                            donate=False)
  new, metrics = step(state, *_place(mesh, {
      "features": payload["mock_features"],
      "labels": payload["mock_labels"]}))
  return {"fsdp_step": {"loss": float(metrics["loss"]),
                        "local_shapes": {k: tuple(v.shape)
                                         for k, v in new.params.items()},
                        "local_moments": [
                            {k: tuple(v.shape) for k, v in m.items()}
                            for m in _moments(new.opt_state)],
                        "specs": {k: tuple(v.spec)
                                  for k, v in shardings.params.items()},
                        **bridge.state_to_numpy(new, shardings)}}


def _collective_cases(mesh):
  group = mesh.group("data")
  x = torch.arange(8 * 3, dtype=torch.float32).reshape(8, 3) + 100 * rank_of(
      mesh)
  perm = [(i, (i + 1) % group.size) for i in range(group.size)]
  out = {}
  for staged in (False, True):
    before = collectives.staged_calls["count"]
    with collectives.host_staging(staged):
      out[f"staged{staged}"] = [
          _numpy(collectives.all_reduce(x, group)),
          _numpy(collectives.all_reduce(x, group, op="max")),
          _numpy(collectives.all_gather(x, group, dim=1)),
          _numpy(collectives.reduce_scatter(x, group, dim=0)),
          _numpy(collectives.all_to_all(x.reshape(group.size, -1, 3),
                                        group)),
          _numpy(collectives.ppermute(x, group, perm)),
          _numpy(collectives.broadcast(x, group, 1))]
    out[f"staged{staged}_calls"] = collectives.staged_calls["count"] - before
  return out


def rank_of(mesh):
  return mesh.rank


def _mesh_construction_cases():
  out = {}
  default = mesh_lib.create_mesh(device="cpu")
  out["default"] = dict(default.shape)
  out["explicit"] = dict(_mesh((2, 2, 2), mesh_lib.DEFAULT_AXES).shape)
  out["too_large"] = _catch(lambda: _mesh((16, 1, 1), mesh_lib.DEFAULT_AXES))
  prefix = _mesh((2, 1, 1), mesh_lib.DEFAULT_AXES)
  out["prefix_size"] = int(prefix.devices.size)
  out["prefix_in_mesh"] = prefix.in_mesh
  out["local_batch_size"] = mesh_lib.local_batch_size(32, default)
  batch = {"x": np.arange(16 * 3, dtype=np.float32).reshape(16, 3)}
  out["put_host_batch"] = _numpy(mesh_lib.put_host_batch(default, batch)["x"])
  return out


def _checkpoint_cases(payload, fsdp_mesh, data_mesh):
  """Save on the (1, 2, 1) fsdp mesh, restore on the (2, 1, 1) data
  mesh; both meshes on ranks 0-1."""
  directory = payload["checkpoint_dir"]
  out = {"directory": directory}
  model = mocks.MockT2RModel()
  state, shardings = _mock_state(model, fsdp_mesh, payload, ts.fsdp_rules())
  step = ts.make_train_step(model, mesh=fsdp_mesh, shardings=shardings)
  state, _ = step(state, *_place(fsdp_mesh, {
      "features": payload["mock_features"],
      "labels": payload["mock_labels"]}))
  manager = checkpoints.CheckpointManager(directory, mesh=fsdp_mesh,
                                          async_checkpointing=False)
  out["saved"] = manager.save(int(state.step), state, shardings)
  out["saved_state"] = bridge.state_to_numpy(state, shardings)
  out["sharded_leaves"] = sorted(k for k, v in shardings.params.items()
                                 if v.spec)
  torch.distributed.barrier(fsdp_mesh.group(fsdp_mesh.axis_names).group)
  manager = checkpoints.CheckpointManager(directory, mesh=data_mesh,
                                          async_checkpointing=False)
  restored = manager.restore(device="cpu")
  restored, data_shardings = bridge.train_state_on_mesh(restored, data_mesh)
  out["restored_data_mesh"] = bridge.state_to_numpy(restored, data_shardings)
  out["restored_step"] = manager.last_restored_step
  return out


def mesh_world(rank, world_size, payload):
  """The cases of tests/test_torch_mesh.py, on 8 ranks."""
  del world_size
  out = {"construction": _mesh_construction_cases()}
  data_mesh = _mesh((2, 1, 1), mesh_lib.DEFAULT_AXES)
  fsdp_mesh = _mesh((1, 2, 1), mesh_lib.DEFAULT_AXES)
  fsdp4_mesh = _mesh((2, 4, 1), mesh_lib.DEFAULT_AXES)
  world = _mesh((8, 1, 1), mesh_lib.DEFAULT_AXES)
  out["collectives"] = _collective_cases(world)
  if data_mesh.in_mesh:
    out.update(_data_parallel_cases(data_mesh, payload))
    out["checkpoint"] = _checkpoint_cases(payload, fsdp_mesh, data_mesh)
  out.update(_fsdp_cases(fsdp4_mesh, payload))
  out["rank"] = rank
  return out


# -- multi-host and preemption -------------------------------------------------


def global_batch_sum(rank, world_size, payload):
  """The two-process case: each process's local rows assembled into the
  global batch, and a collective sum over it."""
  del payload
  mesh = mesh_lib.create_mesh(device="cpu")
  local = np.full((2, 3), rank, np.float32)
  batch = mesh_lib.put_host_batch(mesh, {"x": local}, process_local=True)
  total = collectives.all_reduce(batch["x"].sum(), mesh.group("data"))
  return {"total": float(total), "size": mesh.size,
          "world_size": world_size}


class _PreemptAfter:
  """A mock input generator that sends SIGTERM to its own process after
  handing out `after` batches."""

  def __init__(self, after):
    self._inner = mocks.MockInputGenerator(batch_size=8)
    self._after = after
    self.batch_size = self._inner.batch_size

  def set_specification_from_model(self, model, mode):
    self._inner.set_specification_from_model(model, mode)

  def create_dataset(self, mode):
    for i, batch in enumerate(self._inner.create_dataset(mode)):
      if i == self._after:
        os.kill(os.getpid(), signal.SIGTERM)
      yield batch


def preempted_world(rank, world_size, payload):
  """A real SIGTERM to rank 1 of a (2, 1, 1) data mesh at its 6th batch:
  every rank must save the same step and exit 42, rank 0 alone writing;
  then a resume to step 10."""
  del world_size
  writes = []
  original = checkpoints.CheckpointManager._write

  def recording_write(self, step, *args, **kwargs):
    writes.append(int(step))
    return original(self, step, *args, **kwargs)

  checkpoints.CheckpointManager._write = recording_write
  model_dir = payload["model_dir"]
  common = dict(model_dir=model_dir, mode="train",
                checkpoint_every_n_steps=100, log_every_n_steps=1,
                device_prefetch_depth=0, device="cpu", mesh_shape=(2, 1, 1))
  code = None
  try:
    train_eval.train_eval_model(
        model=mocks.MockT2RModel(), max_train_steps=100,
        input_generator_train=(_PreemptAfter(5) if rank == 1 else
                               mocks.MockInputGenerator(batch_size=8)),
        **common)
  except SystemExit as e:
    code = e.code
  preempted_writes = list(writes)
  steps_after_preemption = checkpoints.latest_step(
      os.path.join(model_dir, "checkpoints"))
  torch.distributed.barrier()
  train_eval.train_eval_model(
      model=mocks.MockT2RModel(), max_train_steps=10,
      input_generator_train=mocks.MockInputGenerator(batch_size=8), **common)
  return {"code": code, "preempted_writes": preempted_writes,
          "latest_after_preemption": steps_after_preemption,
          "writes": writes,
          "latest": checkpoints.latest_step(os.path.join(model_dir,
                                                         "checkpoints"))}
