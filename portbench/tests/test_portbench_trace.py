"""The trace arithmetic and the readers of the traced metrics, on a
synthetic trace (the profiler's CUDA activity needs the card)."""

from __future__ import annotations

import numpy as np
import pytest

from portbench import harness, profiling

MS = 1_000_000  # ns


def _trace():
  device = [("flash_fwd_tc_kernel", 0 * MS, 2 * MS),
            ("flash_bwd_dq_tc_kernel", 1 * MS, 3 * MS),  # overlaps
            ("flash_bwd_dkv_tc_kernel", 5 * MS, 6 * MS),
            ("elementwise_kernel", 8 * MS, 9 * MS)]
  host = [("portbench/train_step", 0, 10 * MS),
          ("aten::mul", 3 * MS, 4 * MS),
          ("cudaLaunchKernel", 3 * MS, 3 * MS + 10)]
  return profiling.Trace(0, 10 * MS, device, host)


def test_busy_is_the_union_and_gaps_name_the_innermost_host_op():
  t = _trace()
  assert t.window_s == pytest.approx(0.010)
  assert t.busy_s == pytest.approx(0.005)
  gaps = t.idle_gaps(10)
  assert sorted(gaps) == [["aten::mul", pytest.approx(0.002)],
                          ["portbench/train_step", pytest.approx(0.001)],
                          ["portbench/train_step", pytest.approx(0.002)]]
  assert sum(g[1] for g in gaps) == pytest.approx(0.005)
  assert t.top_ops(1)[0][0] in ("flash_fwd_tc_kernel",
                                "flash_bwd_dq_tc_kernel")


def test_traced_training_readers():
  run = harness.prepare("train_seq.b32", 1, 1.0, True, "cpu", 0.0)
  run.trace_summary = _trace()
  run.stats.update(steps=10, batch=16, window_s=1.0, traced_steps=1,
                   enqueue_s=[0.01, 0.02, 0.03])
  read = lambda name: harness.load_module("layer_metrics", name).read(run)
  least = run.counts.flash_fwd_seconds(run.config, 16, "bfloat16")
  assert read("flash_fwd_roofline") == pytest.approx(100 * least / 0.002)
  least = run.counts.flash_bwd_seconds(run.config, 16, "bfloat16")
  assert read("flash_bwd_roofline") == pytest.approx(100 * least / 0.003)
  assert read("device_idle.train") == pytest.approx(50.0)
  assert read("host_enqueue_ms.train") == pytest.approx(20.0)
  assert read("train_mfu") == pytest.approx(
      100 * 10 * 3_302_091_653_120 / 989e12)
  assert read("device_idle.serve") is None


def test_traced_serving_readers_and_a_missing_launch():
  run = harness.prepare("serve_seq.vec64", 1, 1.0, True, "cpu", 0.0)
  depths = [np.arange(64) * 64, np.arange(64) * 64 + 1]
  device = [("decode_tick_kernel", i * MS, i * MS + MS // 2)
            for i in range(4)]
  run.trace_summary = profiling.Trace(0, 4 * MS, device, [])
  run.stats.update(window_s=1.0, dispatches=2, robots=64,
                   latencies_s=[0.003, 0.005], depths=depths,
                   traced_depths=depths)
  read = lambda name: harness.load_module("layer_metrics", name).read(run)
  least = 2 * sum(run.counts.decode_launch_seconds(run.config, d.tolist())
                  for d in depths)
  assert read("decode_roofline") == pytest.approx(100 * least / 0.002)
  assert read("host_ms.serve") == pytest.approx(4.0 - 1.0)
  assert read("device_idle.serve") == pytest.approx(50.0)
  assert 0 < read("serve_mfu") < 100
  run.trace_summary.device.pop()
  with pytest.raises(RuntimeError):
    read("decode_roofline")
