"""Rotation representations: quaternion / axis-angle / matrix conversions.

Counterpart of `tensor2robot_tpu.ops.rotations`, batched over leading
dims. Quaternions are [..., 4] in (w, x, y, z) order; axis-angle is
[..., 3], the angle as the vector's norm.

The gradients follow the JAX package's at its boundary points:

* `jnp.clip` is max-then-min there, whose gradient splits evenly at a
  tie; `torch.clamp` passes the whole gradient at its bounds. So the
  clips here are `torch.minimum(torch.maximum(x, low), high)`, which
  split as JAX's do;
* `jnp.linalg.norm` is the square root of the sum of squares, whose
  gradient at the zero vector is NaN; `torch.linalg.vector_norm`
  defines it as 0. So the norms here are written out as JAX's are;
* the double `torch.where` in `axis_angle_to_quaternion` keeps the
  untaken branch's NaN out of the gradient, as JAX's double `jnp.where`
  does.
"""

from __future__ import annotations

import torch

__all__ = ["quaternion_normalize", "quaternion_multiply",
           "quaternion_conjugate", "quaternion_rotate",
           "quaternion_to_axis_angle", "axis_angle_to_quaternion",
           "quaternion_to_rotation_matrix", "geodesic_distance"]

_EPS = 1e-8


def _const(value: float, like: torch.Tensor) -> torch.Tensor:
  return torch.tensor(value, dtype=like.dtype, device=like.device)


def _clip(x: torch.Tensor, low: float, high: float) -> torch.Tensor:
  """`jnp.clip`, ties splitting the gradient as JAX's max and min do."""
  return torch.minimum(torch.maximum(x, _const(low, x)), _const(high, x))


def _norm(x: torch.Tensor) -> torch.Tensor:
  """`jnp.linalg.norm(x, axis=-1, keepdims=True)`, its gradient too."""
  return torch.sqrt((x * x).sum(-1, keepdim=True))


def quaternion_normalize(q: torch.Tensor) -> torch.Tensor:
  return q / torch.maximum(_norm(q), _const(_EPS, q))


def quaternion_multiply(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
  aw, ax, ay, az = a.split(1, dim=-1)
  bw, bx, by, bz = b.split(1, dim=-1)
  return torch.cat([
      aw * bw - ax * bx - ay * by - az * bz,
      aw * bx + ax * bw + ay * bz - az * by,
      aw * by - ax * bz + ay * bw + az * bx,
      aw * bz + ax * by - ay * bx + az * bw,
  ], dim=-1)


def quaternion_conjugate(q: torch.Tensor) -> torch.Tensor:
  return q * torch.tensor([1.0, -1.0, -1.0, -1.0], dtype=q.dtype,
                          device=q.device)


def quaternion_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
  """Rotates vectors [..., 3] by quaternions [..., 4]."""
  qv = torch.cat([torch.zeros_like(v[..., :1]), v], dim=-1)
  return quaternion_multiply(
      quaternion_multiply(q, qv), quaternion_conjugate(q))[..., 1:]


def axis_angle_to_quaternion(axis_angle: torch.Tensor) -> torch.Tensor:
  # A safe norm: the sqrt of a clamped sum keeps gradients finite at 0.
  sq = (axis_angle ** 2).sum(-1, keepdim=True)
  angle = torch.sqrt(torch.maximum(sq, _const(_EPS ** 2, sq)))
  half = 0.5 * angle
  small = sq < 1e-12
  # Double where: the untaken branch contributes no NaN gradient.
  safe_angle = torch.where(small, _const(1.0, angle), angle)
  sinc_half = torch.where(small, 0.5 - sq / 48.0,
                          torch.sin(0.5 * safe_angle) / safe_angle)
  w = torch.cos(half)
  return torch.cat([w, axis_angle * sinc_half], dim=-1)


def quaternion_to_axis_angle(q: torch.Tensor) -> torch.Tensor:
  q = quaternion_normalize(q)
  # Force w >= 0 so the angle is in [0, pi] (shortest arc).
  q = torch.where(q[..., :1] < 0, -q, q)
  w = _clip(q[..., :1], -1.0, 1.0)
  xyz = q[..., 1:]
  sin_half = _norm(xyz)
  angle = 2.0 * torch.atan2(sin_half, w)
  small = sin_half < 1e-6
  scale = torch.where(small, _const(2.0, angle),
                      angle / torch.maximum(sin_half, _const(_EPS, angle)))
  return xyz * scale


def quaternion_to_rotation_matrix(q: torch.Tensor) -> torch.Tensor:
  q = quaternion_normalize(q)
  w, x, y, z = q.split(1, dim=-1)
  row0 = torch.cat([1 - 2 * (y ** 2 + z ** 2), 2 * (x * y - w * z),
                    2 * (x * z + w * y)], dim=-1)
  row1 = torch.cat([2 * (x * y + w * z), 1 - 2 * (x ** 2 + z ** 2),
                    2 * (y * z - w * x)], dim=-1)
  row2 = torch.cat([2 * (x * z - w * y), 2 * (y * z + w * x),
                    1 - 2 * (x ** 2 + y ** 2)], dim=-1)
  return torch.stack([row0, row1, row2], dim=-2)


def geodesic_distance(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
  """Angle of the relative rotation, the natural orientation loss."""
  q1 = quaternion_normalize(q1)
  q2 = quaternion_normalize(q2)
  dot = torch.abs((q1 * q2).sum(-1))
  return 2.0 * torch.arccos(_clip(dot, 0.0, 1.0))
