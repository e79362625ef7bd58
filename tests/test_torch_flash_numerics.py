"""How the tensor-core flash kernels may feed their products, on the CPU.

A bf16 tensor-core product rounds its A operand to bf16. The dK/dV kernel
(`csrc/flash_bwd.cu`) computes P^T and dS^T in f32 and feeds them as the
A operands of dV = P^T.dO and dK = dS^T.Q; the dQ kernel feeds dS as the
A operand of dQ = dS.K. This rehearsal emulates, in torch at BH 2, T 512,
D 64, causal, bf16 inputs from a numpy seed, the two ways to do that,
against `_flash_backward_plain` (P and dS in f32, as the TPU kernel keeps
them):

* single rounding: P and dS rounded once to bf16;
* the kernels' split: x_hi = bf16(x), x_lo = bf16(x - x_hi), two products.

The split must stay within `chip_smoke.py`'s bf16 backward limits, and
single rounding must exceed its relative 2-norm limit, so that the limit
tells the two apart on the card.

A TF32 product keeps 10 mantissa bits of each operand. The f32 forward
(`csrc/flash_fwd.cu`) splits every f32 operand x into big = tf32(x) and
small = tf32(x - big) and sums small.big + big.small + big.big (3xTF32).
The same rehearsal on f32 inputs: 3xTF32 must meet `F32_TOL` on O and lse
against `_flash_forward_plain`, and one TF32 product must not.
"""

import math

import numpy as np
import pytest
import torch

import chip_smoke
from tensor2robot_tpu_torch.ops import attention

torch.set_num_threads(1)

BH, T, D = 2, 512, 64


def _bf16(x):
  return x.to(torch.bfloat16).float()


def _split(x):
  hi = _bf16(x)
  return hi, _bf16(x - hi)


def _problem():
  rs = np.random.RandomState(0)
  q, k, v, do = (torch.from_numpy(rs.randn(BH, T, D).astype(np.float32))
                 .to(torch.bfloat16) for _ in range(4))
  out, lse = attention._flash_forward_plain(q, k, v, True, T)
  want = attention._flash_backward_plain(q, k, v, out, lse, do, True, T)
  # P and dS in f32, as the plain version and the kernel compute them.
  scale = 1.0 / math.sqrt(D)
  qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
  delta = (dof * out.float()).sum(dim=-1, keepdim=True)
  valid = attention._flash_valid(T, True, T, q.device)
  s = torch.einsum("bqd,bkd->bqk", qf, kf) * scale
  p = torch.exp(s.masked_fill(~valid, float("-inf")) - lse)
  ds = p * (torch.einsum("bqd,bkd->bqk", dof, vf) - delta) * scale
  return {"q": qf, "k": kf, "do": dof, "p": p, "ds": ds, "dq": want[0],
          "dk": want[1], "dv": want[2]}


@pytest.fixture(scope="module")
def problem():
  return _problem()


def _dkv(problem, feed):
  """dK and dV with P and dS fed as `feed` gives them (a list of bf16
  parts, each one product), f32 sums, outputs rounded to bf16."""
  dv = sum(torch.einsum("bqk,bqd->bkd", part, problem["do"])
           for part in feed(problem["p"]))
  dk = sum(torch.einsum("bqk,bqd->bkd", part, problem["q"])
           for part in feed(problem["ds"]))
  return dk.to(torch.bfloat16), dv.to(torch.bfloat16)


def _dq(problem, feed):
  """dQ with dS fed as `feed` gives it, f32 sums, rounded to bf16."""
  dq = sum(torch.einsum("bqk,bkd->bqd", part, problem["k"])
           for part in feed(problem["ds"]))
  return dq.to(torch.bfloat16)


def _errors(got, want):
  got, want = got.double(), want.double()
  scaled = float((got - want).abs().max()) / max(1.0, float(want.abs().max()))
  return scaled, float((got - want).norm() / want.norm())


def test_split_meets_the_bf16_backward_limits(problem):
  dk, dv = _dkv(problem, lambda x: list(_split(x)))
  for got, want in ((dk, problem["dk"]), (dv, problem["dv"])):
    scaled, rel = _errors(got, want)
    assert scaled <= chip_smoke.BWD_BF16_TOL
    assert rel <= chip_smoke.BWD_BF16_REL_NORM_TOL


def test_single_rounding_fails_the_norm_limit(problem):
  dk, dv = _dkv(problem, lambda x: [_bf16(x)])
  for got, want in ((dk, problem["dk"]), (dv, problem["dv"])):
    _, rel = _errors(got, want)
    assert rel > chip_smoke.BWD_BF16_REL_NORM_TOL


def test_dq_split_meets_the_bf16_backward_limits(problem):
  scaled, rel = _errors(_dq(problem, lambda x: list(_split(x))),
                        problem["dq"])
  assert scaled <= chip_smoke.BWD_BF16_TOL
  assert rel <= chip_smoke.BWD_BF16_REL_NORM_TOL


def test_dq_single_rounding_fails_the_norm_limit(problem):
  _, rel = _errors(_dq(problem, lambda x: [_bf16(x)]), problem["dq"])
  assert rel > chip_smoke.BWD_BF16_REL_NORM_TOL


def test_limits_are_one_output_step_and_1e_3():
  assert chip_smoke.BWD_BF16_TOL == 2.0 ** -7
  assert chip_smoke.BWD_BF16_REL_NORM_TOL == 1e-3


# -- f32 forward: 3xTF32 ---------------------------------------------------------


def _tf32(x):
  """x rounded to TF32 (10 mantissa bits), to nearest with ties away from
  zero, as `cvt.rna.tf32.f32` rounds: on the int32 view, add half of the
  13 dropped bits and clear them."""
  bits = x.contiguous().view(torch.int32)
  return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _split_tf32(x):
  big = _tf32(x)
  return big, _tf32(x - big)


def _product_3x(a, b, equation):
  """a.b as the kernel runs it: small.big + big.small + big.big, each
  product of TF32 values exact in f32, summed in f32."""
  (ab, as_), (bb, bs) = _split_tf32(a), _split_tf32(b)
  return (torch.einsum(equation, as_, bb) + torch.einsum(equation, ab, bs)
          + torch.einsum(equation, ab, bb))


def _product_1x(a, b, equation):
  return torch.einsum(equation, _tf32(a), _tf32(b))


@pytest.fixture(scope="module")
def f32_problem():
  rs = np.random.RandomState(1)
  q, k, v = (torch.from_numpy(rs.randn(BH, T, D).astype(np.float32))
             for _ in range(3))
  return q, k, v, attention._flash_forward_plain(q, k, v, True, T)


def _forward(q, k, v, product):
  """The f32 forward with every product run by `product`: scores, row
  max, P = exp(S - m) in f32 (unrounded up to the product), O and lse."""
  scale = 1.0 / math.sqrt(D)
  s = product(q, k, "bqd,bkd->bqk") * scale
  s = s.masked_fill(~attention._flash_valid(T, True, T, q.device),
                    float("-inf"))
  m = s.amax(dim=-1, keepdim=True)
  p = torch.exp(s - m)
  l = p.sum(dim=-1, keepdim=True)
  return product(p, v, "bqk,bkd->bqd") / l, m + torch.log(l)


def _forward_errors(f32_problem, product):
  q, k, v, (want_out, want_lse) = f32_problem
  out, lse = _forward(q, k, v, product)
  return (float((out - want_out).abs().max()),
          float((lse - want_lse).abs().max()))


def test_tf32_rounds_to_nearest_on_the_int32_view():
  x = torch.tensor([1.0, 1.0 + 2.0 ** -11, 1.0 + 2.0 ** -11 + 2.0 ** -20,
                    1.0 + 2.0 ** -12, -(1.0 + 3 * 2.0 ** -11), 3.0e-39])
  want = torch.tensor([1.0, 1.0 + 2.0 ** -10, 1.0 + 2.0 ** -10, 1.0,
                       -(1.0 + 2 * 2.0 ** -10), 3.0e-39])
  got = _tf32(x)
  assert torch.equal(got[:5], want[:5])
  assert (got.view(torch.int32) & 0x1FFF).eq(0).all()
  big, small = _split_tf32(x[:5])
  assert torch.equal(big + small, x[:5])


def test_3xtf32_forward_meets_the_f32_limit(f32_problem):
  out_err, lse_err = _forward_errors(f32_problem, _product_3x)
  assert out_err <= chip_smoke.F32_TOL
  assert lse_err <= chip_smoke.F32_TOL


def test_one_tf32_product_fails_the_f32_limit(f32_problem):
  assert max(_forward_errors(f32_problem, _product_1x)) > chip_smoke.F32_TOL


# -- f32 backward: 3xTF32 --------------------------------------------------------
#
# The f32 dQ and dK/dV kernels (`csrc/flash_bwd.cu`) run every product as
# 3xTF32 on the split pass's planes, and add each streamed tile's dQ, dK
# or dV contribution (32 keys or queries) into f32 sums on the CUDA cores.
# Emulated here on f32 inputs against the f64 function, with
# `chip_smoke.py`'s f32 backward limits: scaled <= F32_TOL and relative
# 2-norm <= REL_NORM_TOL.

TILE = 32  # keys (dQ) or queries (dK/dV) per streamed tile


@pytest.fixture(scope="module")
def f32_bwd_problem():
  rs = np.random.RandomState(2)
  q, k, v, do = (torch.from_numpy(rs.randn(BH, T, D).astype(np.float32))
                 for _ in range(4))
  out, lse = attention._flash_forward_plain(q, k, v, True, T)
  return q, k, v, do, out, lse, _backward_f64(q, k, v, do)


def _backward_f64(q, k, v, do):
  """dQ, dK and dV of causal attention, in f64."""
  q, k, v, do = (x.double() for x in (q, k, v, do))
  scale = 1.0 / math.sqrt(D)
  s = torch.einsum("bqd,bkd->bqk", q, k) * scale
  s = s.masked_fill(~attention._flash_valid(T, True, T, q.device),
                    float("-inf"))
  p = torch.softmax(s, dim=-1)
  out = torch.einsum("bqk,bkd->bqd", p, v)
  delta = (do * out).sum(dim=-1, keepdim=True)
  ds = p * (torch.einsum("bqd,bkd->bqk", do, v) - delta) * scale
  return (torch.einsum("bqk,bkd->bqd", ds, k),
          torch.einsum("bqk,bqd->bkd", ds, q),
          torch.einsum("bqk,bqd->bkd", p, do))


def _backward_emulated(problem, product):
  """dQ, dK and dV as the kernels compute them: S and dP by `product`; P
  and dS in f32; each tile's dQ, dK and dV contribution by `product`,
  added to f32 sums."""
  q, k, v, do, out, lse, _ = problem
  scale = 1.0 / math.sqrt(D)
  delta = (do * out).sum(dim=-1, keepdim=True)
  s = product(q, k, "bqd,bkd->bqk") * scale
  s = s.masked_fill(~attention._flash_valid(T, True, T, q.device),
                    float("-inf"))
  p = torch.exp(s - lse)
  ds = p * (product(do, v, "bqd,bkd->bqk") - delta) * scale
  tiles = [slice(j, j + TILE) for j in range(0, T, TILE)]
  dq = sum(product(ds[:, :, j], k[:, j], "bqk,bkd->bqd") for j in tiles)
  dk = sum(product(ds[:, j], q[:, j], "bqk,bqd->bkd") for j in tiles)
  dv = sum(product(p[:, j], do[:, j], "bqk,bqd->bkd") for j in tiles)
  return dq, dk, dv


def _backward_errors(problem, product):
  return [_errors(got, want) for got, want in
          zip(_backward_emulated(problem, product), problem[-1])]


def test_3xtf32_backward_meets_the_f32_limits(f32_bwd_problem):
  for scaled, rel in _backward_errors(f32_bwd_problem, _product_3x):
    assert scaled <= chip_smoke.F32_TOL
    assert rel <= chip_smoke.REL_NORM_TOL


def test_one_tf32_product_fails_the_f32_backward_limit(f32_bwd_problem):
  errors = _backward_errors(f32_bwd_problem, _product_1x)
  assert max(scaled for scaled, _ in errors) > chip_smoke.F32_TOL


def test_port_tf32_rounds_as_the_tests_do():
  x = torch.from_numpy(np.random.RandomState(3).randn(4096).astype(np.float32))
  assert torch.equal(attention._tf32(x), _tf32(x))


# The split pass's planes at a T that is not a multiple of 8 and a head_dim
# computed at 32.
SPLIT_BH, SPLIT_T, SPLIT_D = 3, 45, 16


@pytest.fixture(scope="module")
def split_planes():
  rs = np.random.RandomState(4)
  sources = [torch.from_numpy(rs.randn(SPLIT_BH, SPLIT_T, SPLIT_D).astype(
      np.float32) * 10.0 ** rs.uniform(-6, 6, (SPLIT_BH, SPLIT_T, 1)).astype(
          np.float32)) for _ in range(4)]
  return sources, attention._flash_bwd_split_plain(*sources)


def test_split_planes_rebuild_their_sources(split_planes):
  (q, k, v, do), (rows, cols) = split_planes
  assert rows.shape == (8, SPLIT_BH, SPLIT_T, 32)
  assert cols.shape == (6, SPLIT_BH, 32, 48)
  assert rows.dtype == cols.dtype == torch.float32
  for index, x in enumerate((q, k, v, do)):
    big, small = rows[2 * index], rows[2 * index + 1]
    for part in (big, small):  # tf32 values: the 13 low bits clear
      assert (part.view(torch.int32) & 0x1FFF).eq(0).all()
    assert torch.equal(big, _tf32(big)) and torch.equal(small, _tf32(small))
    rebuilt = (big.double() + small.double())[..., :SPLIT_D]
    assert bool(((rebuilt - x.double()).abs()
                 <= 2.0 ** -21 * x.double().abs()).all())
    assert big[..., SPLIT_D:].eq(0).all() and small[..., SPLIT_D:].eq(0).all()


def test_split_transposes_are_permuted_row_planes(split_planes):
  _, (rows, cols) = split_planes
  t8 = cols.shape[-1]
  # Position p of each group of 8 holds index 0 2 4 6 1 3 5 7, so that
  # index j sits at (j >> 1) + 4 (j & 1).
  source = [8 * (p // 8) + (0, 2, 4, 6, 1, 3, 5, 7)[p % 8] for p in range(t8)]
  assert all(source[(j & ~7) + ((j & 7) >> 1) + 4 * (j & 1)] == j
             for j in range(t8))
  for col_index, name in enumerate(attention._COL_PLANES):
    # "qt_big" is the transpose of "q_big", "dot_small" of "do_small".
    plane = rows[attention._ROW_PLANES.index(name.replace("t_", "_", 1))]
    for p, j in enumerate(source):
      want = plane[:, j, :] if j < SPLIT_T else torch.zeros_like(plane[:, 0])
      assert torch.equal(cols[col_index][:, :, p], want)


def test_bwd_args_pair_planes_with_f32():
  q = torch.zeros((1, 8, 16))
  with pytest.raises(ValueError, match="split pass"):
    attention._bwd_args(q, q, q, q, q, q, True, 8, None)
  q16 = q.to(torch.bfloat16)
  with pytest.raises(ValueError, match="split pass"):
    attention._bwd_args(q16, q16, q16, q16, q, q, True, 8, (q, q))
