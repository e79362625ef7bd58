"""The port's side of tests/test_torch_pipeline.py: functions run on every
rank of a CPU gloo world by `test_torch_mesh_world` (torch only: the ranks
never import JAX). It holds no test itself.

Each rank computes every case (the pipelines are collectives over the pp
ranks) and rank 0 returns the results, gathered to full tensors where a
case is sharded.
"""

import os

import numpy as np
import torch

from tensor2robot_tpu_torch import bridge
from tensor2robot_tpu_torch import checkpoints
from tensor2robot_tpu_torch import train_eval
from tensor2robot_tpu_torch.models import optimizers
from tensor2robot_tpu_torch.models import pipelined_model
from tensor2robot_tpu_torch.obs import metrics as obs_metrics
from tensor2robot_tpu_torch.parallel import collectives
from tensor2robot_tpu_torch.parallel import mesh as mesh_lib
from tensor2robot_tpu_torch.parallel import pipeline_parallel as pp
from tensor2robot_tpu_torch.parallel import train_step as ts
from tensor2robot_tpu_torch.research.bcz import models as bcz_models
from tensor2robot_tpu_torch.research.grasp2vec import models as g2v_models
from tensor2robot_tpu_torch.utils import config

AXES = ("data", "pp", "model")
# (num_micro, v, batch_axis) of TestInterleavedPipeline, plus GPipe.
APPLY_CASES = ((5, 1, None), (8, 2, None), (5, 2, None), (3, 2, None),
               (8, 2, "data"), (4, 1, "data"), (8, 4, None))
GRAD_CASES = ((8, 2, None), (8, 2, "data"), (4, 1, "data"))
MODEL_STEPS = 20
PP_LR = 1e-2

# The JAX test's heterogeneous stages (tests/test_moe_pipeline.py).
HETERO_FNS = (
    lambda p, x: torch.tanh(x[:, :12] @ p["w"] + p["b"]),
    lambda p, x: torch.relu(x[:, :20] @ p["w"]),
    lambda p, x: torch.tanh(x[:, :7] @ p["w1"]) @ p["w2"],
    lambda p, x: x[:, :5] @ p["w"] + p["b"],
)
HETERO8_DIMS = (10, 12, 8, 9, 7, 11, 6, 5, 4)


def _tensor(x):
  return torch.from_numpy(np.array(x, np.float32))


def _numpy(x):
  return x.detach().float().cpu().numpy()


def _tree(tree):
  return ({k: _tree(v) for k, v in tree.items()} if isinstance(tree, dict)
          else _tensor(tree))


def heavy_product_dtypes(fn):
  """(dtype, elements) of every convolution and matrix product `fn()`
  runs, backward included: the port's reading of
  tests/test_mixed_precision.py's bar (some bf16 product, and no float32
  one larger than 4096 elements)."""
  from torch.utils._python_dispatch import TorchDispatchMode

  heavy = {torch.ops.aten.convolution.default, torch.ops.aten.mm.default,
           torch.ops.aten.bmm.default, torch.ops.aten.addmm.default,
           torch.ops.aten.convolution_backward.default}
  seen = []

  class Watch(TorchDispatchMode):

    def __torch_dispatch__(self, func, types_, args=(), kwargs=None):
      out = func(*args, **(kwargs or {}))
      if func in heavy:
        first = out[0] if isinstance(out, tuple) else out
        if first is not None:
          seen.append((str(first.dtype), first.numel()))
      return out

  with Watch():
    fn()
  return seen


def bf16_leaks(seen):
  """The float32 products over 4096 elements, and whether any bf16 one
  ran."""
  leaks = [s for s in seen if s[0] != "torch.bfloat16" and s[1] > 4096]
  return leaks, any(s[0] == "torch.bfloat16" for s in seen)


def _stage_fn(params, x):
  return torch.tanh(x @ params["w"] + params["b"])


def _rows(mesh, x, batch_axis, dim=1):
  """This rank's rows of `x` along `dim` under `batch_axis`."""
  if batch_axis is None:
    return x
  group = mesh.group(batch_axis)
  size = x.shape[dim] // group.size
  return x.narrow(dim, group.index * size, size)


def _gather_rows(mesh, x, batch_axis, dim=1):
  if batch_axis is None:
    return x
  return collectives.all_gather(x.detach().contiguous(),
                                mesh.group(batch_axis), dim=dim)


def _full_grad(mesh, grad):
  """The global loss's gradient of a whole leaf from this rank's: the
  sum over every rank over the mesh size (module docstring of
  `parallel.pipeline_parallel`)."""
  return collectives.all_reduce(grad, mesh.group(mesh.axis_names)) / mesh.size


def _apply_cases(mesh, payload):
  out = {}
  for num_micro, v, batch_axis in APPLY_CASES:
    key = f"{num_micro}_{v}_{batch_axis}"
    stacked = _tree(payload["stacks"][v])
    micro = _rows(mesh, _tensor(payload["micro"][num_micro]), batch_axis)
    y = pp.pipelined_apply(_stage_fn, stacked, micro, mesh, "pp",
                           batch_axis=batch_axis, num_virtual_stages=v)
    out[f"apply_{key}"] = _numpy(_gather_rows(mesh, y, batch_axis))
  # The interleaved layout given as it is.
  inter = pp.interleave_stage_stack(_tree(payload["stacks"][2]), 4, 2)
  y = pp.pipelined_apply(_stage_fn, inter, _tensor(payload["micro"][8]),
                         mesh, "pp", num_virtual_stages=2,
                         params_layout="interleaved")
  out["apply_interleaved_layout"] = _numpy(y)
  for num_micro, v, batch_axis in GRAD_CASES:
    stacked = {k: p.requires_grad_(True)
               for k, p in _tree(payload["stacks"][v]).items()}
    micro = _rows(mesh, _tensor(payload["micro"][num_micro]), batch_axis)
    y = pp.pipelined_apply(_stage_fn, stacked, micro, mesh, "pp",
                           batch_axis=batch_axis, num_virtual_stages=v)
    (y ** 2).mean().backward()
    out[f"grad_{num_micro}_{v}_{batch_axis}"] = {
        k: _numpy(_full_grad(mesh, p.grad)) for k, p in stacked.items()}
  return out


def _hetero_cases(mesh, payload):
  out = {}
  stages = [_tree(p) for p in payload["hetero_params"]]
  stacked, unravels, sizes = pp.ravel_stage_stack(stages)
  out["hetero_stacked"] = _numpy(stacked)
  out["hetero_sizes"] = sizes
  micro = _tensor(payload["hetero_micro"])
  stacked.requires_grad_(True)
  y = pp.pipelined_apply_heterogeneous(
      HETERO_FNS, unravels, sizes, stacked, _rows(mesh, micro, "data"),
      mesh, batch_axis="data")
  (y[..., :3] ** 2).mean().backward()
  out["hetero_out"] = _numpy(_gather_rows(mesh, y, "data"))
  out["hetero_grad"] = _numpy(_full_grad(mesh, stacked.grad))
  # 8 stages, 2 chunks a rank, composed with the data split.
  fns = [lambda p, x, d=d: torch.tanh(x[:, :d] @ p["w"])
         for d in HETERO8_DIMS[:-1]]
  stacked8, unravels8, sizes8 = pp.ravel_stage_stack(
      [_tree(p) for p in payload["hetero8_params"]])
  stacked8.requires_grad_(True)
  micro8 = _tensor(payload["hetero8_micro"])
  y = pp.pipelined_apply_heterogeneous(
      fns, unravels8, sizes8, stacked8, _rows(mesh, micro8, "data"), mesh,
      batch_axis="data", num_virtual_stages=2)
  (y[..., :HETERO8_DIMS[-1]] ** 2).mean().backward()
  out["hetero8_out"] = _numpy(_gather_rows(mesh, y, "data"))
  out["hetero8_grad"] = _numpy(_full_grad(mesh, stacked8.grad))

  def raises(fn):
    try:
      fn()
    except ValueError as e:
      return str(e)
    return None

  out["hetero_mismatch"] = raises(lambda: pp.pipelined_apply_heterogeneous(
      HETERO_FNS[:3], unravels[:3], sizes[:3], stacked[:3].detach(), micro,
      mesh))
  out["hetero_v2_mismatch"] = raises(
      lambda: pp.pipelined_apply_heterogeneous(
          HETERO_FNS, unravels, sizes, stacked.detach(), micro, mesh,
          num_virtual_stages=2))
  out["hetero_wrong_stack"] = raises(
      lambda: pp.pipelined_apply_heterogeneous(
          HETERO_FNS * 2, unravels * 2, sizes * 2, stacked.detach(), micro,
          mesh, num_virtual_stages=2))
  six = {"w": torch.zeros(6, 4, 4), "b": torch.zeros(6, 4)}
  out["homogeneous_leading_dim"] = raises(lambda: pp.pipelined_apply(
      _stage_fn, six, torch.zeros(4, 2, 4), mesh, "pp",
      num_virtual_stages=2))
  four = {"w": torch.zeros(4, 4, 4), "b": torch.zeros(4, 4)}
  out["num_micro_zero"] = raises(lambda: pp.pipelined_apply(
      _stage_fn, four, torch.zeros(0, 2, 4), mesh, "pp"))
  with obs_metrics.isolated():
    pp.pipelined_apply(_stage_fn, four, torch.zeros(2, 2, 4), mesh, "pp")
    out["degenerate_snapshot"] = obs_metrics.snapshot(prefix="pp/")
  with obs_metrics.isolated():
    pp.pipelined_apply(_stage_fn, _tree(payload["stacks"][2]),
                       _tensor(payload["micro"][8]), mesh, "pp",
                       num_virtual_stages=2)
    out["onefonb_snapshot"] = obs_metrics.snapshot(prefix="pp/")
  # The staged transport (page-locked host buffers on the card): every
  # hop, forward and backward, goes through it; 2 x total ticks a rank.
  staged = collectives.staged_calls["count"]
  with collectives.host_staging(True):
    stacked = {k: p.requires_grad_(True)
               for k, p in _tree(payload["stacks"][2]).items()}
    y = pp.pipelined_apply(_stage_fn, stacked, _tensor(payload["micro"][8]),
                           mesh, "pp", num_virtual_stages=2)
    (y ** 2).mean().backward()
  out["staged_hops"] = collectives.staged_calls["count"] - staged
  out["staged_grad"] = {k: _numpy(_full_grad(mesh, p.grad))
                        for k, p in stacked.items()}
  return out


def _pipelined_train_step_cases(mesh, payload):
  """`make_pipelined_train_step`: one SGD step against the sequential
  gradient, then Adam fitting the target; both audited (`audit_name`),
  which on a mesh of more than one rank runs the step eagerly."""
  out = {}
  loss_fn = lambda y, t: ((y - t) ** 2).mean()
  x, target = _tensor(payload["step_x"]), _tensor(payload["step_y"])
  for name, optimizer, steps in (
      ("sgd", optimizers.create_sgd_optimizer(PP_LR), 1),
      ("adam", optimizers.create_adam_optimizer(1e-2), 60)):
    stacked = _tree(payload["stacks"][1])
    params = pp.shard_pipeline_tree(stacked, mesh, "pp")
    opt_state = pp.shard_pipeline_tree(optimizer.init(stacked), mesh, "pp")
    step = pp.make_pipelined_train_step(_stage_fn, loss_fn, optimizer, mesh,
                                        audit_name=f"pp/{name}_step")
    losses = []
    for _ in range(steps):
      params, opt_state, loss = step(params, opt_state, x, target)
      losses.append(float(loss))
    out[f"step_{name}_losses"] = losses
    out[f"step_{name}_params"] = {
        k: _numpy(collectives.all_gather(v, mesh.group("pp")))
        for k, v in params.items()}
    out[f"step_{name}_block_rows"] = params["w"].shape[0]
  return out


def _model_step(model, mesh, params, features, labels, rules, steps=1):
  model.set_mesh(mesh)
  state, shardings = bridge.train_state_on_mesh(
      ts.init_train_state(model, {k: _tensor(v) for k, v in params.items()}),
      mesh, rules)
  f = mesh_lib.put_host_batch(mesh, features)
  l = mesh_lib.put_host_batch(mesh, labels)
  loss, grads = ts.make_grad_fn(model, mesh, shardings)(state, f, l)
  grads = {k: _numpy(mesh_lib.unshard(g, mesh, shardings.params[k].spec))
           for k, g in grads.items()}
  step = ts.make_train_step(model, mesh=mesh, shardings=shardings,
                            donate=False)
  new, metrics = step(state, f, l)
  first = bridge.state_to_numpy(new, shardings)
  losses = [float(metrics["loss"])]
  for _ in range(steps - 1):
    new, metrics = step(new, f, l)
    losses.append(float(metrics["loss"]))
  # Each stage-local leaf and its moments hold 1/4 of the stack a rank.
  sharded = {k: (tuple(v.spec), tuple(state.params[k].shape))
             for k, v in shardings.params.items() if v.spec}
  return {"loss": float(loss), "grads": grads, "losses": losses,
          "params": first["params"], "sharded": sharded}


def _sgd(lr=PP_LR):
  return lambda: optimizers.create_sgd_optimizer(lr)


def _model_cases(mesh, payload):
  out = {}
  for name, kwargs in (("gpipe", {}), ("onefonb", {
      "num_stages": 8, "num_virtual_stages": 2, "num_microbatches": 8})):
    widths = {**payload["pp_widths"], **kwargs}
    case = payload[f"model_{name}"]
    model = pipelined_model.PipelinedRegressionModel(optimizer_fn=_sgd(),
                                                     **widths)
    out[f"model_{name}"] = _model_step(
        model, mesh, case["params"], case["features"], case["labels"],
        pipelined_model.pipeline_parallel_rules())
    model = pipelined_model.PipelinedRegressionModel(
        optimizer_fn=lambda: optimizers.create_adam_optimizer(3e-3),
        **widths)
    out[f"model_{name}_adam"] = _model_step(
        model, mesh, case["params"], case["features"], case["labels"],
        pipelined_model.pipeline_parallel_rules(),
        steps=MODEL_STEPS)["losses"]
  # A pp mesh whose rules leave the stages whole: the trunk takes only
  # this rank's block, so the step refuses the layout.
  try:
    _model_step(pipelined_model.PipelinedRegressionModel(
        optimizer_fn=_sgd(), **payload["pp_widths"]), mesh,
        payload["model_gpipe"]["params"], payload["model_gpipe"]["features"],
        payload["model_gpipe"]["labels"], ())
  except ValueError as e:
    out["whole_stage_rules"] = str(e)
  bcz = payload["model_bcz"]
  out["model_bcz"] = _model_step(
      bcz_models.BCZModel(optimizer_fn=_sgd(), **payload["bcz_widths"]),
      mesh, bcz["params"], bcz["features"], bcz["labels"],
      pipelined_model.pipeline_parallel_rules(), steps=5)
  g2v = payload["model_grasp2vec"]
  out["model_grasp2vec"] = _model_step(
      g2v_models.Grasp2VecModel(optimizer_fn=_sgd(),
                                **payload["grasp2vec_widths"]),
      mesh, g2v["params"], g2v["features"], g2v["labels"],
      pipelined_model.pipeline_parallel_rules(), steps=5)
  return out


def _config_cases(rank, payload):
  """The four pipelined configs through `train_eval_model` on this
  world, shrunk in length (and BC-Z and Grasp2Vec in image size)."""
  out = {}
  for name, bindings in payload["configs"].items():
    model_dir = os.path.join(payload["config_dir"], name)
    config.clear_config()
    config.parse_config_files_and_bindings(
        [os.path.join("tensor2robot_tpu_torch", "configs", f"{name}.gin")],
        list(bindings) + [f"train_eval_model.model_dir = '{model_dir}'",
                          "train_eval_model.device = 'cpu'"])
    metrics = train_eval.train_eval_model()
    manager = checkpoints.CheckpointManager(
        os.path.join(model_dir, checkpoints.CHECKPOINT_DIRNAME))
    out[name] = {"loss": float(metrics["loss"]),
                 "steps": manager.all_steps(),
                 "eval_loss": metrics.get("eval/loss")}
    config.clear_config()
    torch.distributed.barrier()
  return out


def pipeline_world(rank, world_size, payload):
  """The cases of tests/test_torch_pipeline.py, on 8 ranks."""
  del world_size
  mesh = mesh_lib.create_mesh((2, 4, 1), AXES, device="cpu")
  out = {}
  out.update(_apply_cases(mesh, payload))
  out.update(_hetero_cases(mesh, payload))
  out.update(_pipelined_train_step_cases(mesh, payload))
  out.update(_model_cases(mesh, payload))
  out["configs"] = _config_cases(rank, payload)
  return out if rank == 0 else {"rank": rank}
