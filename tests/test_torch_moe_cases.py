"""The port's side of tests/test_torch_moe.py: functions run on every rank
of a CPU gloo world by `test_torch_mesh_world` (torch only: the ranks
never import JAX). It holds no test itself.
"""

import os

import numpy as np
import torch

from tensor2robot_tpu_torch import bridge
from tensor2robot_tpu_torch import checkpoints
from tensor2robot_tpu_torch import train_eval
from tensor2robot_tpu_torch.layers import moe as moe_lib
from tensor2robot_tpu_torch.models import moe_model
from tensor2robot_tpu_torch.models import optimizers
from tensor2robot_tpu_torch.parallel import collectives
from tensor2robot_tpu_torch.parallel import mesh as mesh_lib
from tensor2robot_tpu_torch.parallel import train_step as ts
from tensor2robot_tpu_torch.utils import config
from tests import test_torch_pipeline_cases as pipeline_cases

AXES = mesh_lib.DEFAULT_AXES
LR = 1e-2
TRAIN_STEPS = 30
A2A_KW = dict(num_experts=8, hidden_size=8, output_size=6, top_k=2)

_tensor = pipeline_cases._tensor
_numpy = pipeline_cases._numpy


def _layer(params, **kwargs):
  layer = moe_lib.MixtureOfExperts(5, **kwargs)
  return layer, {k: _tensor(v) for k, v in params.items()}


def _block(mesh, x):
  group = mesh.group("data")
  size = x.shape[0] // group.size
  return x[group.index * size:(group.index + 1) * size]


def _gather(mesh, x):
  return _numpy(collectives.all_gather(x.detach().contiguous(),
                                      mesh.group("data")))


class _Route(torch.nn.Module):
  """The layer's routing as a module's forward (for functional_call)."""

  def __init__(self, layer):
    super().__init__()
    self.layer = layer

  def forward(self, x):
    return self.layer.route(x)


def _layer_case(mesh, layer, params, tokens, batch_group=None,
                with_grads=False):
  """This rank's block of the tokens through the layer: the gathered
  output, the aux loss, the expert assignments and (with_grads) the
  global loss's gradient of every leaf ((out ** 2).mean() + 0.01 aux,
  JAX's test loss)."""
  leaves = {k: v.clone().requires_grad_(with_grads) for k, v in params.items()}
  x = _block(mesh, tokens)
  with collectives.batch_group(batch_group):
    out, aux = torch.func.functional_call(layer, leaves, (x,))
  with torch.no_grad():
    _, _, top_idx = torch.func.functional_call(
        _Route(layer), {f"layer.{k}": v for k, v in leaves.items()}, (x,))
  result = {"out": _gather(mesh, out), "aux": float(aux),
            "top_idx": _gather(mesh, top_idx)}
  if with_grads:
    loss = (out ** 2).mean() + 0.01 * aux
    grads = torch.autograd.grad(loss, list(leaves.values()))
    result["grads"] = {k: _numpy(pipeline_cases._full_grad(mesh, g))
                       for k, g in zip(leaves, grads)}
  return result


def _layer_cases(mesh, payload):
  out = {}
  tokens = _tensor(payload["tokens"])
  layer, params = _layer(payload["a2a_params"], dispatch="alltoall",
                         mesh=mesh, capacity_factor=64.0, **A2A_KW)
  out["a2a"] = _layer_case(mesh, layer, params, tokens, with_grads=True)
  # The router pinned to expert 0, one slot an expert: alltoall keeps
  # each source shard's first token, sparse the batch's first four.
  pinned = dict(payload["a2a_params"])
  pinned["router.weight"] = np.zeros_like(pinned["router.weight"])
  pinned["router.bias"] = np.eye(8, dtype=np.float32)[0] * 10.0
  kw = dict(num_experts=8, hidden_size=8, output_size=6, top_k=1,
            capacity_factor=1.0)
  layer, params = _layer(pinned, dispatch="alltoall", mesh=mesh, **kw)
  out["pinned_a2a"] = _layer_case(mesh, layer, params, tokens)["out"]
  layer, params = _layer(pinned, dispatch="sparse", **kw)
  out["pinned_sparse"] = _layer_case(mesh, layer, params, tokens,
                                     batch_group=mesh.group("data"))["out"]
  # Dense and sparse over the batch split across the data ranks: the
  # global capacity and statistics.
  for name, kwargs in payload["global_cases"].items():
    layer, params = _layer(payload["global_params"], **kwargs)
    out[f"global_{name}"] = _layer_case(mesh, layer, params, tokens,
                                        batch_group=mesh.group("data"),
                                        with_grads=True)
  bad = moe_lib.MixtureOfExperts(5, num_experts=6, dispatch="alltoall",
                                 mesh=mesh)
  try:
    bad(torch.zeros(2, 5))
    out["indivisible"] = None
  except ValueError as e:
    out["indivisible"] = str(e)
  return out


def _model_step(model, mesh, case, rules, steps=1):
  model.set_mesh(mesh)
  state, shardings = bridge.train_state_on_mesh(
      ts.init_train_state(model, {k: _tensor(v)
                                  for k, v in case["params"].items()}),
      mesh, rules)
  f = mesh_lib.put_host_batch(mesh, case["features"])
  l = mesh_lib.put_host_batch(mesh, case["labels"])
  loss, grads = ts.make_grad_fn(model, mesh, shardings)(state, f, l)
  grads = {k: _numpy(mesh_lib.unshard(g, mesh, shardings.params[k].spec))
           for k, g in grads.items()}
  step = ts.make_train_step(model, mesh=mesh, shardings=shardings,
                            donate=False)
  new, metrics = step(state, f, l)
  first = bridge.state_to_numpy(new, shardings)["params"]
  losses = [float(metrics["loss"])]
  for _ in range(steps - 1):
    new, metrics = step(new, f, l)
    losses.append(float(metrics["loss"]))
  return {"loss": float(loss), "grads": grads, "params": first,
          "losses": losses, "aux": float(metrics["moe_aux_loss"]),
          "sharded": {k: (tuple(v.spec), tuple(state.params[k].shape))
                      for k, v in shardings.params.items() if v.spec}}


def _model_cases(payload):
  out = {}
  for name, shape, kwargs, axis in (
      ("ep", (2, 1, 2), dict(num_experts=4, dispatch="sparse"), "model"),
      ("a2a", (4, 1, 1), dict(num_experts=8, dispatch="alltoall",
                              capacity_factor=2.0), "data")):
    mesh = mesh_lib.create_mesh(shape, AXES, device="cpu")
    case = payload[f"model_{name}"]
    widths = dict(obs_size=8, action_size=3, hidden_size=16, **kwargs)
    rules = moe_model.expert_parallel_rules(axis=axis)
    out[f"model_{name}"] = _model_step(
        moe_model.MoERegressionModel(
            optimizer_fn=lambda: optimizers.create_sgd_optimizer(LR),
            **widths), mesh, case, rules)
    out[f"model_{name}"]["losses"] = _model_step(
        moe_model.MoERegressionModel(
            optimizer_fn=lambda: optimizers.create_adam_optimizer(3e-3),
            **widths), mesh, case, rules, steps=TRAIN_STEPS)["losses"]
  # The alltoall trunk's products under the bfloat16 policy.
  mesh = mesh_lib.create_mesh((2, 1, 1), AXES, device="cpu")
  if mesh.in_mesh:
    model = moe_model.MoERegressionModel(
        obs_size=64, action_size=8, num_experts=4, hidden_size=128,
        dispatch="alltoall", use_bfloat16=True)
    model.set_mesh(mesh)
    state, shardings = ts.create_train_state(
        model, torch.Generator().manual_seed(0), torch.device("cpu"),
        mesh=mesh, rules=moe_model.expert_parallel_rules(axis="data"))
    rng = np.random.RandomState(0)
    f = mesh_lib.put_host_batch(mesh, {"observation": rng.randn(
        16, 64).astype(np.float32)})
    l = mesh_lib.put_host_batch(mesh, {"action": rng.randn(16, 8).astype(
        np.float32)})
    step = ts.make_train_step(model, mesh=mesh, shardings=shardings)
    out["a2a_bf16"] = pipeline_cases.heavy_product_dtypes(
        lambda: step(state, f, l))
  return out


def _config_cases(payload):
  out = {}
  for name, bindings in payload["configs"].items():
    model_dir = os.path.join(payload["config_dir"], name)
    config.clear_config()
    config.parse_config_files_and_bindings(
        [os.path.join("tensor2robot_tpu_torch", "configs", "train_moe_ep.gin")],
        list(bindings) + [f"train_eval_model.model_dir = '{model_dir}'",
                          "train_eval_model.device = 'cpu'"])
    metrics = train_eval.train_eval_model()
    manager = checkpoints.CheckpointManager(
        os.path.join(model_dir, checkpoints.CHECKPOINT_DIRNAME))
    out[name] = {"loss": float(metrics["loss"]),
                 "steps": manager.all_steps()}
    config.clear_config()
    torch.distributed.barrier()
  return out


def moe_world(rank, world_size, payload):
  """The cases of tests/test_torch_moe.py, on 4 ranks."""
  del world_size
  mesh = mesh_lib.create_mesh((4, 1, 1), AXES, device="cpu")
  out = _layer_cases(mesh, payload)
  out.update(_model_cases(payload))
  out["configs"] = _config_cases(payload)
  return out if rank == 0 else {"rank": rank}
