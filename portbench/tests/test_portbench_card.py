"""On the card, at each cell's own size: the control (and for training
the half-batch fault) comes out not correct against the cell's limits on
three seeds, and sound runs of the program (and the reference rounded as
a bfloat16 program rounds, a witness) come out correct. Run on the
chip with `python3 -m pytest portbench/tests -m card -q`."""

from __future__ import annotations

import pytest

from portbench import calibrate, compare, harness

CELLS = ["train_seq.b32", "train_critic.b256", "serve_seq.vec64"]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_control_and_faults_fail_and_sound_runs_pass(cell, card):
  limits = harness.load_json(harness.HERE / "cells" / f"{cell}.json")[
      "limits"]
  found = calibrate.readings(cell, [90001], [90011, 90012, 90013], 2.0,
                             card)
  for kind, seed, numbers in found:
    held = {k: limits[k] for k in numbers if k in limits}
    ok = compare.passes(compare.judge(numbers, held))
    assert ok == (kind in ("sound", "witness_bf16")), (kind, seed, numbers)
