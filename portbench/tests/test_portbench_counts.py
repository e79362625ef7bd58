"""The benchmark's own counts of work, pinned, and reconciled with the
port's X-ray."""

from __future__ import annotations

import pytest
import torch

from portbench import harness

DECODE_B8 = [4095, 3072, 2048, 1024, 512, 256, 48, 1]  # the kernel table's


@pytest.fixture(scope="module")
def seq():
  return (harness.load_json(harness.HERE / "configs" /
                            "seq_policy_t4096.json"),
          harness.load_module("counts", "seq_policy_t4096"))


def test_sequence_step_flops_at_batch_2_and_16(seq):
  cfg, counts = seq
  assert counts.train_step_flops(cfg, 2) == 412_761_456_640
  assert counts.recomputed_flops(cfg, 2) == 103_079_215_104
  assert counts.train_step_flops(cfg, 16) == 3_302_091_653_120


def test_xray_counts_the_recomputed_products_on_top(seq):
  """X-ray's step flops (fake tensors, the port's registered formulas,
  which count 7 backward products) are the benchmark's count plus the
  3 recomputed products a block."""
  from tensor2robot_tpu_torch.obs import xray
  from tensor2robot_tpu_torch.parallel import train_step as ts

  cfg, counts = seq
  program = harness.load_module("programs", "seq_policy_t4096")
  model = program.build_model(cfg, "train")
  state = ts.create_train_state(model, torch.Generator().manual_seed(0),
                                torch.device("cpu"))
  features, labels = program.make_batch(cfg, model, 2, torch.Generator(),
                                        "cpu")
  flops, _, _ = xray._fake_profile(ts.make_train_step(model),
                                   (state, features, labels))
  assert flops == 515_840_671_744
  assert flops == counts.train_step_flops(cfg, 2) + counts.recomputed_flops(
      cfg, 2)


def test_decode_bound_of_the_kernel_tables_b8_vector(seq):
  cfg, counts = seq
  assert counts.decode_launch_seconds(cfg, DECODE_B8) * 1e3 == \
      pytest.approx(0.0135, abs=5e-5)


def test_flash_bounds_are_the_kernel_tables(seq):
  cfg, counts = seq
  assert counts.flash_fwd_seconds(cfg, 2, "bfloat16") * 1e3 == \
      pytest.approx(0.0347, abs=5e-5)
  assert counts.flash_bwd_seconds(cfg, 2, "bfloat16") * 1e3 == \
      pytest.approx(0.0695, abs=5e-5)


def test_critic_tower_shapes_and_step_flops():
  cfg = harness.load_json(harness.HERE / "configs" / "qtopt_grasping44.json")
  counts = harness.load_module("counts", "qtopt_grasping44")
  convs = counts.convs(cfg)
  assert [c[-1] for c in convs] == [236] + [79] * 6 + [27] * 6 + [12, 10, 8]
  fc0 = next(d for d in counts.denses(cfg) if d[0] == "fc0")
  assert fc0[1] == 8 * 8 * 64
  assert counts.train_step_flops(cfg, 256) == 6_549_501_476_864
  assert counts.train_step_flops(cfg, 2) * 128 == counts.train_step_flops(
      cfg, 256)


def test_critic_counts_match_the_tiny_towers_parameters():
  """Every conv and dense kernel the counts name is one of the port's
  module's, with that shape."""
  cfg = harness.load_json(harness.HERE / "configs" / "qtopt_grasping44.json")
  counts = harness.load_module("counts", "qtopt_grasping44")
  program = harness.load_module("programs", "qtopt_grasping44")
  params = dict(program.build_model(cfg, "train").module.named_parameters())
  for name, cin, cout, k, _, _ in counts.convs(cfg):
    assert tuple(params[f"{name}.weight"].shape) == (cout, cin, k, k)
  for name, n_in, n_out, _ in counts.denses(cfg):
    assert tuple(params[f"{name}.weight"].shape) == (n_out, n_in)
  kernels = {k for k, v in params.items() if v.ndim > 1}
  assert kernels == {f"{c[0]}.weight" for c in counts.convs(cfg)} | {
      f"{d[0]}.weight" for d in counts.denses(cfg)}
