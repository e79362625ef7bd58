"""The kernels as registered operators, for compiled graphs, on the CPU.

`t2r::flash_fwd` (differentiable through `register_autograd`),
`t2r::flash_bwd` and `t2r::decode_tick` (mutating its arenas) are opaque
to `torch.compile`: a graph holds the call, and on a CPU tensor each runs
its plain version. Held here:

* `torch.library.opcheck` passes for all three (schema, fake
  implementation, autograd registration);
* a flash attention forward and backward compiled with `aot_eager`
  gives the eager path's output and gradients bit for bit (the same ops
  in the same order), with no graph break;
* the decode tick, eager and compiled, mutates its arenas exactly as the
  plain version does, and returns the same output;
* each operator's flop formula gives `PERF.md`'s bound count (causal
  halves the products): the forward 2, the backward 7 products of
  2·BH·T²·D; the tick 4·B·T·H·D;
* the plain versions run through the operators: their launch counters
  stay 0 on the CPU.
"""

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from tensor2robot_tpu_torch.ops import attention
from tensor2robot_tpu_torch.ops import decode_kernels

torch.set_num_threads(1)


def _qkv(bh=4, t=24, d=8, seed=0):
  rs = np.random.RandomState(seed)
  return [torch.from_numpy(rs.randn(bh, t, d).astype(np.float32))
          for _ in range(3)]


def _arenas(seed=1, s=5, t=32, h=2, d=8, b=3):
  rs = np.random.RandomState(seed)
  f = lambda *shape: torch.from_numpy(rs.randn(*shape).astype(np.float32))
  return (f(b, h, d), f(b, h, d), f(b, h, d), f(s, t, h, d), f(s, t, h, d),
          torch.tensor([2, 4, 0], dtype=torch.int32),
          torch.tensor([5, 31, 0], dtype=torch.int32),
          torch.tensor([True, True, False]))


@pytest.mark.parametrize("causal", [False, True])
def test_opcheck_flash_operators(causal):
  q, k, v = _qkv()
  torch.library.opcheck(torch.ops.t2r.flash_fwd.default,
                        (q, k, v, causal, 20))
  out, lse = attention.flash_forward(q, k, v, causal, 20)
  torch.library.opcheck(torch.ops.t2r.flash_bwd.default,
                        (q, k, v, out, lse, torch.randn_like(out), causal,
                         20))


def test_opcheck_decode_tick():
  torch.library.opcheck(torch.ops.t2r.decode_tick.default, _arenas())


@pytest.mark.parametrize("causal", [False, True])
def test_compiled_flash_gradients_are_the_eager_paths_bit_for_bit(causal):
  torch._dynamo.reset()

  def loss_fn(q, k, v):
    out = attention.flash_attention(q, k, v, causal=causal)
    return (out * torch.cos(out)).sum()

  arrays = [x.reshape(2, 2, 24, 8) for x in _qkv(seed=3)]
  grads = {}
  for kind, fn in (("eager", loss_fn),
                   ("compiled", torch.compile(loss_fn, backend="aot_eager",
                                              fullgraph=True,
                                              dynamic=False))):
    leaves = [x.clone().requires_grad_(True) for x in arrays]
    loss = fn(*leaves)
    grads[kind] = [loss.detach()] + list(torch.autograd.grad(loss, leaves))
  for got, want in zip(grads["compiled"], grads["eager"]):
    assert torch.equal(got, want)
  assert attention.flash_forward.launches == 0
  assert attention.flash_backward.launches_dq == 0


def test_decode_tick_mutates_its_arenas_as_the_plain_version_does():
  torch._dynamo.reset()
  args = _arenas()
  want_arenas = [args[3].clone(), args[4].clone()]
  want = decode_kernels._decode_tick_plain(
      *args[:3], want_arenas[0], want_arenas[1], *args[5:])
  for kind in ("eager", "compiled"):
    k_arena, v_arena = args[3].clone(), args[4].clone()
    fn = decode_kernels.fused_decode_attention
    if kind == "compiled":
      fn = torch.compile(fn, backend="aot_eager", fullgraph=True,
                         dynamic=False)
    out, k_out, v_out = fn(*args[:3], k_arena, v_arena, *args[5:])
    assert torch.equal(out, want), kind
    assert torch.equal(k_arena, want_arenas[0]), kind
    assert torch.equal(v_arena, want_arenas[1]), kind
    assert k_out is k_arena and v_out is v_arena
    # The pad lane's null slot 0 is untouched.
    assert torch.equal(k_arena[0], args[3][0])
  assert decode_kernels.fused_decode_attention.launches == 0


@pytest.mark.parametrize("causal", [False, True])
def test_flop_formulas_are_the_bound_columns(causal):
  bh, t, d = 4, 24, 8
  product = 2 * bh * t * t * d // (2 if causal else 1)
  q, k, v = (x.requires_grad_(True) for x in _qkv(bh, t, d))
  with FlopCounterMode(display=False) as forward:
    out, _ = attention.flash_forward(q, k, v, causal, t)
  assert forward.get_total_flops() == 2 * product
  with FlopCounterMode(display=False) as backward:
    torch.autograd.grad(out.sum(), [q, k, v])
  assert backward.get_total_flops() == 7 * product
  args = _arenas()
  with FlopCounterMode(display=False) as tick:
    decode_kernels.fused_decode_attention(*args)
  b, h, dd = args[0].shape
  assert tick.get_total_flops() == 4 * b * args[3].shape[1] * h * dd


def test_lse_is_not_differentiable_and_double_backward_raises():
  q, k, v = (x.requires_grad_(True) for x in _qkv())
  out, lse = attention.flash_forward(q, k, v, True, 24)
  assert out.requires_grad and not lse.requires_grad
  (dq,) = torch.autograd.grad(out.sum(), [q], create_graph=True)
  with pytest.raises(RuntimeError):
    torch.autograd.grad(dq.sum(), [q])
