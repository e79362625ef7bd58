"""Rounding for the plain references, their controls and witnesses.

A reference runs in float32 with every product exact to float32 (TF32
off). The same code runs at a lower precision by rounding where a
program of that precision would round:

* `operand(x, mode)`: the operands of every product (matrix product,
  convolution, attention's two products), as a lower-precision product
  reads them; it accumulates in float32;
* `stored(x, mode)`: every tensor that a layer hands to the next, as a
  program of that precision keeps its activations, and in the backward
  the gradient that flows through it.

The modes:

* "float32": nothing is rounded (the reference);
* "tf32": operands to 10 explicit mantissa bits, rounded to nearest
  even; nothing stored is rounded (the control of a float32
  configuration);
* "bf16": operands, activations and gradients to bfloat16 (a witness
  of what a bfloat16 program's rounding alone gives);
* "fp8": operands and activations to float8 e4m3, gradients to e5m2,
  each with a per-tensor scale that maps the tensor's largest magnitude
  to the format's largest (the control of a bfloat16 configuration).

The rounding is explicit, so a control reads the same on the CPU as on
the card. An operand's rounding passes its gradient straight through.
"""

from __future__ import annotations

import torch

_E4M3, _E5M2 = 448.0, 57344.0


def _tf32(x: torch.Tensor) -> torch.Tensor:
  bits = x.float().contiguous().view(torch.int32)
  rounded = (bits + 0x0FFF + ((bits >> 13) & 1)) & ~0x1FFF
  return rounded.view(torch.float32)


def _fp8(x: torch.Tensor, dtype=torch.float8_e4m3fn,
         largest: float = _E4M3) -> torch.Tensor:
  x = x.float()
  scale = largest / x.abs().amax().clamp_min(1e-30)
  return (x * scale).to(dtype).float() / scale


def _round(x: torch.Tensor, mode: str) -> torch.Tensor:
  if mode == "tf32":
    return _tf32(x)
  if mode == "bf16":
    return x.to(torch.bfloat16).float()
  if mode == "fp8":
    return _fp8(x)
  return x.float()


def operand(x: torch.Tensor, mode: str) -> torch.Tensor:
  """`x` in float32 as a product of `mode` reads it."""
  if mode == "float32":
    return x.float()
  rounded = _round(x.detach(), mode)
  return x.float() + (rounded - x.float()).detach()


class _Stored(torch.autograd.Function):

  @staticmethod
  def forward(ctx, x, mode):
    ctx.mode = mode
    return _round(x, mode)

  @staticmethod
  def backward(ctx, grad):
    if ctx.mode == "fp8":
      return _fp8(grad, torch.float8_e5m2, _E5M2), None
    return _round(grad, ctx.mode), None


def stored(x: torch.Tensor, mode: str) -> torch.Tensor:
  """`x` as a program of `mode` keeps it between layers; its gradient
  rounded the same way in the backward."""
  if mode in ("float32", "tf32"):
    return x
  return _Stored.apply(x, mode)


class exact_float32:
  """Within the block, float32 products on the card are exact float32
  (TF32 off for cuBLAS and cuDNN); the flags are restored after."""

  def __enter__(self):
    self._saved = (torch.backends.cuda.matmul.allow_tf32,
                   torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return self

  def __exit__(self, *exc):
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = self._saved
    return False
