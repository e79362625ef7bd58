"""The plain references against the port at a tiny size, and the
lower-precision controls, which must come out not correct."""

from __future__ import annotations

import time

import pytest
import torch

from portbench import calibrate, compare, harness, weights

import conftest


def _float32(run):
  conftest.shrink(run)
  run.config["train"]["use_bfloat16"] = False


@pytest.mark.parametrize("cell", ["train_seq.b32", "train_critic.b256"])
def test_float32_port_agrees_with_the_reference(cell):
  """With the port's step in float32 the three steps agree to float32
  rounding: the reference follows the same mathematics."""
  found = calibrate.readings(cell, [31], [], 0.1, "cpu", _float32)
  numbers = found[0][2]
  assert numbers["loss_gap"] < 1e-5, numbers
  assert numbers["grad_gap"] < 1e-3, numbers
  assert numbers["update_gap"] < 1e-3, numbers


def test_sequence_reference_forward_matches_the_port():
  run = harness.prepare("serve_seq.vec64", 3, 0.1, False, "cpu", 0.0)
  conftest.shrink(run)
  model = run.program.build_model(run.config, "serve")
  shapes = {k: tuple(v.shape) for k, v in model.module.named_parameters()}
  params = weights.draw(shapes, "lecun", torch.Generator().manual_seed(3),
                        "cpu")
  obs = torch.randn(2, run.config["model"]["sequence_length"],
                    run.config["model"]["obs_size"])
  port, _ = model.inference_network_fn(params, {}, {"observation": obs},
                                       "predict")
  ours = run.reference.forward(params, obs, run.config)
  torch.testing.assert_close(port["action"], ours, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("cell", ["train_seq.b32", "train_critic.b256",
                                  "serve_seq.vec64"])
def test_the_control_is_not_correct(cell):
  """The reference with the operands of every product in the precision
  below the configuration's (fp8 for bf16 training, TF32 for f32
  serving), put in the program's place, fails the cell's limits, and
  reads at least three times what sound runs of the program read on one
  of its numbers."""
  found = calibrate.readings(cell, [41, 42], [43], 0.3, "cpu",
                             conftest.shrink)
  got = calibrate.summary(found)
  limits = harness.load_json(harness.HERE / "cells" / f"{cell}.json")[
      "limits"]
  control = {k: v for k, v in got["control"].items() if k in limits}
  held = {k: limits[k] for k in control}
  assert held and not compare.passes(compare.judge(control, held)), control
  assert any(control[k] >= 3 * got["sound"][k] for k in control), got


def test_half_batch_fault_reads_far_above_sound_runs():
  found = calibrate.readings("train_seq.b32", [51], [52], 0.1, "cpu",
                             conftest.shrink)
  got = calibrate.summary(found)
  assert got["half_batch"]["grad_gap"] >= 10 * got["sound"]["grad_gap"]
