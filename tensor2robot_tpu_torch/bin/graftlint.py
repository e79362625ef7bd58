"""Static-analysis CLI: graftlint over the port's configs and sources.

Thin bin/ face of `tensor2robot_tpu_torch.analysis.lint` (the port of
the JAX package's `bin.graftlint`): argparse-based, and it creates no
CUDA context.

Usage:
  python -m tensor2robot_tpu_torch.bin.graftlint tensor2robot_tpu_torch
  python -m tensor2robot_tpu_torch.bin.graftlint --list-rules

Exits non-zero iff findings remain after `# graftlint: disable=`
suppressions. README.md's port section has the rule catalog.
"""

from __future__ import annotations

import sys

from tensor2robot_tpu_torch.analysis import lint


def main(argv=None) -> int:
  return lint.main(argv)


if __name__ == "__main__":
  sys.exit(main())
