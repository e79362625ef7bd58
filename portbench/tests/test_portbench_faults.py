"""A run with the timed path broken underneath comes out not correct:
once for each fault a cell can have. (No cell spans chips, so no
exchange between chips can be left out.) The harness's look for a card
is skipped; the rest of the run is its traffic driver's, at a tiny size."""

from __future__ import annotations

import time

import pytest

from portbench import harness
from tensor2robot_tpu_torch.parallel import train_step as ts
from tensor2robot_tpu_torch.serving import session

import conftest


def _correct(cell, seed=977):
  run = harness.prepare(cell, seed, 0.3, False, "cpu", time.perf_counter())
  conftest.shrink(run)
  return harness.execute(run)


def _half(tree):
  return type(tree)({k: v[:v.shape[0] // 2] for k, v in tree.items()})


@pytest.fixture
def broken_step(monkeypatch):
  def plant(fault):
    real = ts.make_train_step

    def make(model, *args, **kwargs):
      step = real(model, *args, **kwargs)

      def broken(state, features, labels):
        if fault == "unchanged":
          return state, step(state, features, labels)[1]
        if fault == "half_batch":
          return step(state, _half(features), _half(labels))
        new, metrics = step(state, features, labels)
        return new.replace(**{fault: getattr(state, fault)}), metrics

      return broken

    monkeypatch.setattr(ts, "make_train_step", make)

  return plant


@pytest.mark.parametrize("cell", ["train_seq.b32", "train_critic.b256"])
@pytest.mark.parametrize("fault", ["unchanged", "half_batch"])
def test_a_broken_train_step_is_not_correct(cell, fault, broken_step):
  broken_step(fault)
  result = _correct(cell)
  assert result["correct"] is False, result["checks"]


@pytest.mark.parametrize("part", ["ema_params", "mutable_state"])
def test_a_critic_step_leaving_part_of_its_state_unchanged_is_not_correct(
    part, broken_step):
  broken_step(part)
  result = _correct("train_critic.b256")
  assert result["correct"] is False, result["checks"]


def test_an_answer_altered_where_it_is_produced_is_not_correct(monkeypatch):
  real = session.SessionEngine.step_many
  calls = []

  def altered(self, items):
    answers = real(self, items)
    calls.append(1)
    if len(calls) == 50:
      answers[3]["action"] = answers[3]["action"] + 0.05
    return answers

  monkeypatch.setattr(session.SessionEngine, "step_many", altered)
  result = _correct("serve_seq.vec64")
  assert len(calls) > 50
  assert result["correct"] is False, result["checks"]
