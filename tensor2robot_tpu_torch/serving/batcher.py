"""Errors of the batching fronts.

Counterpart of the errors in `tensor2robot_tpu.serving.batcher`
(`MicroBatcher` comes with the stateless-serving slice).
"""

from __future__ import annotations

__all__ = ["ShutdownError", "ShedError"]


class ShedError(RuntimeError):
  """The batcher refused the request (admission control)."""


class ShutdownError(ShedError):
  """The batcher was closed while the request was still queued."""
