"""The published peaks of one NVIDIA H100 SXM and the least time of a
piece of work on it.

NVIDIA's data sheet, dense rates without sparsity, at the full 700 W:
989 TFLOP/s in bf16, 495 in TF32, 67 in f32 outside the tensor cores,
3.35 TB/s of HBM.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "tf32": 495e12,
              "float32": 67e12}


def least_seconds(moved_bytes: float, flops: float, dtype: str) -> float:
  """max(bytes / HBM rate, flops / peak). An f32-exact product has two
  ways on this card, the f32 CUDA cores or three TF32 products on the
  tensor cores (165 TFLOP/s effective); the faster one bounds it."""
  t_bytes = moved_bytes / HBM_BYTES_PER_S
  if dtype == "float32":
    t_ops = min(flops / PEAK_FLOPS["float32"], 3 * flops / PEAK_FLOPS["tf32"])
  else:
    t_ops = flops / PEAK_FLOPS[dtype]
  return max(t_bytes, t_ops)
