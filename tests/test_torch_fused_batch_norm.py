"""The fused batch-norm operator (`ops/batch_norm.py`) on the CPU: its
plain forward and backward against autograd through `moments` and
`normalize`, the registered operators under `torch.library.opcheck`,
`BatchNorm`'s routing (the fused operator, the batch-group path, the
eval path) and what it records, the kernels' layouts and launch plans,
and the one node each way a traced graph holds.

The CUDA kernels themselves are held against the plain version on the
card by `chip_smoke.py`."""

import numpy as np
import pytest
import torch

from tensor2robot_tpu_torch.analysis import graph_audit
from tensor2robot_tpu_torch.layers import flax_layers
from tensor2robot_tpu_torch.obs import metrics as metrics_lib
from tensor2robot_tpu_torch.obs import trace
from tensor2robot_tpu_torch.ops import batch_norm as bn_ops
from tensor2robot_tpu_torch.parallel import collectives

FUSED = "model/batch_norm/fused"
MOMENTUM, EPSILON = 0.9997, 1e-3


@pytest.fixture(autouse=True)
def _quiet_tracer():
  trace.disable()
  trace.clear()
  yield
  trace.disable()
  trace.clear()


def _inputs(shape, dtype, channels_last=False, use_scale=True, seed=0):
  """x (offset from 0, so the fast variance cancels a little), scale,
  bias, running statistics and a cotangent, from numpy."""
  rng = np.random.default_rng(seed)
  c = shape[1]
  x = torch.tensor(rng.normal(0.7, 2.0, shape), dtype=dtype)
  if channels_last:
    x = x.contiguous(memory_format=torch.channels_last)
  weight = (torch.tensor(rng.normal(1.0, 0.3, c), dtype=dtype)
            if use_scale else None)
  bias = torch.tensor(rng.normal(0.0, 0.3, c), dtype=dtype)
  running = (torch.tensor(rng.normal(0.0, 1.0, c), dtype=dtype),
             torch.tensor(rng.uniform(0.5, 2.0, c), dtype=dtype))
  dy = torch.tensor(rng.normal(0.0, 1.0, shape), dtype=dtype)
  return x, weight, bias, running, dy


def _reference(x, weight, bias, running, dy):
  """y, the new running statistics and (dx, dscale, dbias) of the chain
  `BatchNorm` ran before the fused operator: `moments`, `normalize` and
  autograd through both."""
  leaves = [t.detach().requires_grad_(True) for t in (x, weight, bias)
            if t is not None]
  xr = leaves[0]
  wr = leaves[1] if weight is not None else None
  br = leaves[-1]
  dims = (0,) + tuple(range(2, x.ndim))
  mean, var = flax_layers.moments(xr, dims)
  y = flax_layers.normalize(xr, mean, var, wr, br, EPSILON)
  new_mean = MOMENTUM * running[0] + (1.0 - MOMENTUM) * mean.detach(
  ).reshape(-1)
  new_var = MOMENTUM * running[1] + (1.0 - MOMENTUM) * var.detach(
  ).reshape(-1)
  grads = torch.autograd.grad(y, leaves, dy)
  return y.detach(), new_mean, new_var, grads


SHAPES = [((6, 5, 4, 3), False), ((6, 5, 4, 3), True), ((9, 7), False)]


@pytest.mark.parametrize("shape, channels_last", SHAPES)
@pytest.mark.parametrize("use_scale", [True, False])
def test_plain_forward_and_backward_match_autograd_in_float64(
    shape, channels_last, use_scale):
  x, weight, bias, running, dy = _inputs(shape, torch.float64,
                                         channels_last, use_scale)
  y_ref, mean_ref, var_ref, grads = _reference(x, weight, bias, running, dy)
  y, new_mean, new_var, mean, rstd = bn_ops._batch_norm_forward_plain(
      x, weight, bias, *running, MOMENTUM, EPSILON)
  assert torch.equal(y, y_ref)
  assert torch.equal(new_mean, mean_ref) and torch.equal(new_var, var_ref)
  dx, dscale, dbias = bn_ops._batch_norm_backward_plain(
      dy, x, weight, mean, rstd, torch.float64)
  want = dict(zip(["dx", "dscale", "dbias"] if use_scale else
                  ["dx", "dbias"], grads))
  got = {"dx": dx, "dscale": dscale, "dbias": dbias}
  for name, ref in want.items():
    scale = max(1.0, float(ref.abs().max()))
    assert float((got[name] - ref).abs().max()) <= 1e-12 * scale, name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape, channels_last", SHAPES)
def test_operator_through_autograd_against_the_chain(dtype, shape,
                                                     channels_last):
  """On the CPU the operator's y and running statistics are the chain's
  bit for bit, in x's layout; its gradients are the chain's to rounding
  (float32 sums in another order; bf16 dx within one bf16 step)."""
  x, weight, bias, running, dy = _inputs(shape, dtype, channels_last)
  y_ref, mean_ref, var_ref, grads = _reference(x, weight, bias, running, dy)
  leaves = [t.detach().requires_grad_(True) for t in (x, weight, bias)]
  y, new_mean, new_var = bn_ops.batch_norm_train(
      *leaves, *running, MOMENTUM, EPSILON)
  assert torch.equal(y, y_ref) and y.stride() == x.stride()
  assert torch.equal(new_mean, mean_ref) and torch.equal(new_var, var_ref)
  assert not new_mean.requires_grad and not new_var.requires_grad
  got = torch.autograd.grad(y, leaves, dy)
  for g, ref, leaf in zip(got, grads, leaves):
    assert g.dtype == leaf.dtype and g.shape == leaf.shape
    step = 2.0 ** -7 if dtype == torch.bfloat16 else 1e-5
    scale = max(1.0, float(ref.float().abs().max()))
    assert float((g.float() - ref.float()).abs().max()) <= step * scale


def _op_args(shape, dtype, channels_last, use_scale):
  x, weight, bias, running, dy = _inputs(shape, dtype, channels_last,
                                         use_scale)
  x.requires_grad_(True)
  for t in (weight, bias):
    if t is not None:
      t.requires_grad_(True)
  return x, weight, bias, running, dy


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape, channels_last", SHAPES)
@pytest.mark.parametrize("use_scale", [True, False])
def test_opcheck_forward_and_backward_operators(dtype, shape, channels_last,
                                               use_scale):
  x, weight, bias, running, dy = _op_args(shape, dtype, channels_last,
                                          use_scale)
  torch.library.opcheck(torch.ops.t2r.batch_norm_fwd.default,
                        (x, weight, bias, *running, MOMENTUM, EPSILON))
  _, _, _, mean, rstd = bn_ops._batch_norm_forward_plain(
      x.detach(), weight, bias, *running, MOMENTUM, EPSILON)
  torch.library.opcheck(torch.ops.t2r.batch_norm_bwd.default,
                        (dy, x.detach(), None if weight is None else
                         weight.detach(), mean, rstd, dtype))


def _counter():
  return metrics_lib.counter(FUSED).value


@pytest.mark.parametrize("shape, channels_last", SHAPES)
def test_training_forward_is_fused_and_keeps_its_spans(shape,
                                                       channels_last):
  x, _, _, _, _ = _inputs(shape, torch.float32, channels_last)
  layer = flax_layers.BatchNorm(shape[1])
  x = x.requires_grad_(True)
  before = _counter()
  trace.enable()
  y, new = layer(x * 1.0, True)
  y.square().sum().backward()
  trace.disable()
  assert _counter() == before + 1
  assert set(new) == {"running_mean", "running_var"}
  names = [e["name"] for e in trace.get_tracer().events()
           if e.get("ph") == "X"]
  assert names.count("model/batch_norm") == 1
  assert names.count("model/batch_norm.backward") == 1


class _Pair:
  """A stand-in batch group of two ranks holding the same rows."""
  size = 2


@pytest.mark.parametrize("shape", [(4, 3, 5, 5), (6, 4)])
def test_batch_group_takes_the_global_moments_path(monkeypatch, shape):
  """Under a batch group the statistics are summed over the group
  (`_global_moments`), not fused: with both ranks' rows alike the result
  is the single rank's chain's."""
  calls = []

  def all_reduce_sum(tensor, group):
    calls.append(group)
    return tensor * group.size

  monkeypatch.setattr(collectives, "all_reduce_sum", all_reduce_sum)
  x, _, _, _, _ = _inputs(shape, torch.float32)
  layer = flax_layers.BatchNorm(shape[1])
  before = _counter()
  with collectives.batch_group(_Pair()):
    y, new = layer(x, True)
  assert len(calls) == 1 and _counter() == before
  dims = (0,) + tuple(range(2, x.ndim))
  mean, var = flax_layers.moments(x, dims)
  want = flax_layers.normalize(x, mean, var, layer.weight, layer.bias,
                               layer.epsilon)
  torch.testing.assert_close(y, want, rtol=1e-6, atol=1e-6)
  torch.testing.assert_close(new["running_var"],
                             0.99 + 0.01 * var.reshape(-1))


def test_eval_and_unsupported_inputs_keep_the_chain():
  """Eval mode normalises by the running statistics; on the CPU a float64
  input, an input of another layout and one under functorch's transforms
  are not fused."""
  layer = flax_layers.BatchNorm(3)
  x = torch.randn(4, 3, 5, 5)
  before = _counter()
  y, new = layer(x, False)
  assert new == {} and torch.equal(y, flax_layers.normalize(
      x, layer.running_mean.reshape(1, -1, 1, 1),
      layer.running_var.reshape(1, -1, 1, 1), layer.weight, layer.bias,
      layer.epsilon))
  layer(x.double(), True)
  layer(x.transpose(2, 3), True)
  layer(torch.randn(4, 3, 5), True)
  torch.func.vmap(lambda v: layer(v, True)[0])(x[None])
  assert _counter() == before
  assert not flax_layers._fusable(x.transpose(0, 1))
  assert flax_layers._fusable(x) and flax_layers._fusable(x.bfloat16())


def _fake_cuda_state(layer):
  return {k: torch.empty(v.shape, dtype=v.dtype, device="cuda")
          for k, v in [*layer.named_parameters(), *layer.named_buffers()]}


# (shape, strides, dtype) of fake CUDA inputs, by whether the kernels
# take them.
TAKEN = {
    "nchw": ((4, 3, 5, 5), (75, 25, 5, 1), torch.float32),
    "channels_last_bf16": ((4, 3, 5, 5), (75, 1, 15, 3), torch.bfloat16),
    "rows": ((4, 3), (3, 1), torch.float32),
}
REFUSED = {
    "transposed": ((4, 3, 5, 5), (75, 25, 1, 5), torch.float32),
    "channel_slice": ((4, 3, 5, 5), (150, 25, 5, 1), torch.bfloat16),
    "rank_3": ((4, 3, 5), (15, 5, 1), torch.float32),
}
# Dtypes the kernels do not have (float64 is the reference precision of
# the card-against-CPU checks) keep the chain.
CHAINED = {
    "float64": ((4, 3, 5, 5), (75, 25, 5, 1), torch.float64),
    "float16": ((4, 3, 5, 5), (75, 25, 5, 1), torch.float16),
}


@pytest.mark.parametrize("case", sorted({**TAKEN, **REFUSED, **CHAINED}))
def test_off_the_cpu_a_training_forward_is_fused_or_raises(case):
  """On a CUDA tensor (fake ones here, no card needed) every float32 or
  bf16 training forward outside a batch group goes to the operator: a
  rank and layout the kernels take runs it, any other raises; none falls
  back to the chain. Other dtypes, and eval mode, keep the chain."""
  from torch._subclasses.fake_tensor import FakeTensorMode

  layer = flax_layers.BatchNorm(3)
  takes = case in TAKEN
  shape, strides, dtype = {**TAKEN, **REFUSED, **CHAINED}[case]
  before = _counter()
  with FakeTensorMode():
    state = _fake_cuda_state(layer)
    x = torch.empty_strided(shape, strides, dtype=dtype, device="cuda")
    run = lambda train: torch.func.functional_call(layer, state, (x, train))
    if takes:
      y, new = run(True)
      assert y.device.type == "cuda" and y.stride() == x.stride()
      assert set(new) == {"running_mean", "running_var"}
    elif case in REFUSED:
      with pytest.raises(ValueError):
        run(True)
    else:
      assert run(True)[0].stride() == x.stride()
    assert run(False)[0].shape == x.shape
  assert _counter() == before + int(takes)


def test_off_the_cpu_functorch_transforms_raise():
  from torch._subclasses.fake_tensor import FakeTensorMode

  layer = flax_layers.BatchNorm(3)
  with FakeTensorMode():
    state = _fake_cuda_state(layer)
    x = torch.empty(2, 4, 3, 5, 5, device="cuda")
    with pytest.raises(ValueError, match="functorch"):
      torch.func.vmap(lambda v: torch.func.functional_call(
          layer, state, (v, True))[0])(x)


def test_layouts_the_kernels_take():
  x = torch.empty(2, 3, 4, 5)
  assert bn_ops.layout(x) == (bn_ops.PLANES, 2, 3, 20)
  assert bn_ops.layout(x.contiguous(memory_format=torch.channels_last)) == (
      bn_ops.ROWS, 40, 3, 1)
  assert bn_ops.layout(torch.empty(7, 3)) == (bn_ops.ROWS, 7, 3, 1)
  # [N, C, 1, 1] is rows, however its size-1 dims are strided.
  assert bn_ops.layout(torch.empty(2, 3, 1, 1)) == (bn_ops.ROWS, 2, 3, 1)
  for bad in (x.transpose(2, 3), torch.empty(3, 7).t(), x[:, :2],
              torch.empty(2, 3, 4)):
    assert not bn_ops.takes(bad)
    with pytest.raises(ValueError):
      bn_ops.layout(bad)
  assert not bn_ops.takes(x.half())


# The critic's norms at batch 256 (channels-last conv outputs, the dense
# norms) on an H100's 132 SMs, with 16-byte bf16 vectors.
@pytest.mark.parametrize("kind, outer, c, inner, width, want", [
    (bn_ops.ROWS, 256 * 236 * 236, 64, 1, 8, (1056, 1, 8)),
    (bn_ops.ROWS, 256 * 12 * 12, 64, 1, 8, (1056, 1, 8)),
    (bn_ops.ROWS, 256, 256, 1, 8, (32, 1, 32)),
    (bn_ops.ROWS, 256, 64, 1, 8, (8, 1, 8)),
    (bn_ops.ROWS, 100, 1000, 1, 4, (13, 8, 32)),
    (bn_ops.ROWS, 100, 3, 1, 1, (2, 1, 4)),
    (bn_ops.PLANES, 256, 64, 236 * 236, 8, (33, 64, 14)),
    (bn_ops.PLANES, 256, 64, 79 * 79, 8, (33, 64, 2)),
    (bn_ops.PLANES, 2, 8, 5, 8, (1, 8, 1)),
])
def test_launch_plans(kind, outer, c, inner, width, want):
  grid_x, grid_y, split = bn_ops._plan(kind, outer, c, inner, width, 132)
  assert (grid_x, grid_y, split) == want
  assert grid_y <= 65535 and grid_x >= 1
  if kind == bn_ops.ROWS:
    groups = c // width
    assert split & (split - 1) == 0 and split <= 32
    assert grid_y * split >= groups > (grid_y - 1) * split


def test_a_traced_training_step_holds_one_node_each_way():
  """`graph_audit.trace_graph` (make_fx on fake tensors, the backward
  inside the trace) sees the fused operators, not their insides, and
  launches nothing."""
  layer = flax_layers.BatchNorm(4)
  x = torch.randn(3, 4, 5, 5).contiguous(memory_format=torch.channels_last)
  weight = layer.weight.detach().clone().requires_grad_(True)
  bias = layer.bias.detach().clone().requires_grad_(True)

  def step(x, weight, bias):
    y, _, _ = bn_ops.batch_norm_train(x, weight, bias, layer.running_mean,
                                      layer.running_var, 0.99, 1e-5)
    return y.float().square().sum()

  launches = bn_ops.batch_norm_train.launches
  stats = graph_audit.graph_stats(graph_audit.trace_graph(
      step, [x, weight, bias]))
  assert stats["ops"] == {"t2r.batch_norm_fwd": 1, "t2r.batch_norm_bwd": 1}
  assert stats["joint"]
  assert bn_ops.batch_norm_train.launches == launches


def test_shape_errors_raise():
  x = torch.randn(2, 3, 4, 4)
  with pytest.raises(ValueError):
    bn_ops.batch_norm_train(x, torch.ones(4), None, torch.zeros(3),
                            torch.ones(3), 0.9, 1e-5)
