"""The modules a benchmark run may not load: JAX and the JAX package.

Names are compared by their whole top-level part (before the first dot):
the port's `tensor2robot_tpu_torch` begins with `tensor2robot_tpu`, so a
prefix test would be wrong.
"""

from __future__ import annotations

import sys
from typing import Iterable, List

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "tensor2robot_tpu"})


def forbidden_modules(names: Iterable[str] = None) -> List[str]:
  """The loaded module names whose top-level name is forbidden."""
  names = list(sys.modules) if names is None else list(names)
  return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)
