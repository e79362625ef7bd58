"""How the bf16 dK/dV kernel may feed its tensor-core products, on the CPU.

A bf16 tensor-core product rounds its A operand to bf16. The dK/dV kernel
(`csrc/flash_bwd.cu`) computes P^T and dS^T in f32 and feeds them as the
A operands of dV = P^T.dO and dK = dS^T.Q. This rehearsal emulates, in
torch at BH 2, T 512, D 64, causal, bf16 inputs from a numpy seed, the two
ways to do that, against `_flash_backward_plain` (P and dS in f32, as the
TPU kernel keeps them):

* single rounding: P and dS rounded once to bf16;
* the kernel's split: x_hi = bf16(x), x_lo = bf16(x - x_hi), two products.

The split must stay within `chip_smoke.py`'s bf16 backward limits, and
single rounding must exceed its relative 2-norm limit, so that the limit
tells the two apart on the card.
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
  return {"q": qf, "do": dof, "p": p, "ds": ds, "dk": want[1],
          "dv": want[2]}


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


def test_limits_are_one_output_step_and_1e_3():
  assert chip_smoke.BWD_BF16_TOL == 2.0 ** -7
  assert chip_smoke.BWD_BF16_REL_NORM_TOL == 1e-3
