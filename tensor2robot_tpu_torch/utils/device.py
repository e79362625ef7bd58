"""Device selection for the port's entry points."""

from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["resolve_device", "same_device"]

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
  """The device an entry point runs on: CUDA unless the caller names
  another. Raises rather than quietly running on the CPU when no CUDA
  device is present."""
  device = torch.device("cuda" if device is None else device)
  if device.type == "cuda":
    if not torch.cuda.is_available():
      raise RuntimeError(
          "no CUDA device is available; pass device='cpu' to run the "
          "plain PyTorch versions of the kernels on the CPU.")
    if device.index is None:
      device = torch.device("cuda", torch.cuda.current_device())
  return device


def same_device(a: torch.device, b: Optional[torch.device]) -> bool:
  """True when `a` and `b` name one device (type and index)."""
  return b is not None and a.type == b.type and a.index == b.index
