"""The port's program spans on the CPU: the tracer's clock stamp against
`torch.profiler`'s clock, `Phases`, and the spans inside the session
engine (`serve/session/*`), the train step (`train/*`) and batch norm
(`model/batch_norm*`)."""

import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from tensor2robot_tpu_torch.layers import flax_layers
from tensor2robot_tpu_torch.models import sequence_model
from tensor2robot_tpu_torch.obs import metrics as metrics_lib
from tensor2robot_tpu_torch.obs import trace
from tensor2robot_tpu_torch.parallel import train_step as ts
from tensor2robot_tpu_torch.predictors import predictors
from tensor2robot_tpu_torch.serving import session
from tensor2robot_tpu_torch.utils import mocks

SERVE_CHILDREN = ["serve/session/admit", "serve/session/stack",
                  "serve/session/h2d", "serve/session/dispatch",
                  "serve/session/fetch", "serve/session/book"]


@pytest.fixture(autouse=True)
def _quiet_tracer():
  """Every test starts and ends with the global tracer off and empty."""
  trace.disable()
  trace.clear()
  yield
  trace.disable()
  trace.clear()


def _spans(name=None):
  return [e for e in trace.get_tracer().events()
          if e.get("ph") == "X" and (name is None or e["name"] == name)]


def _interval_ns(event):
  start = round(event["ts"] * 1000)
  return start, start + round(event["dur"] * 1000)


def test_clock_stamp_maps_a_span_onto_the_profilers_clock():
  trace.enable()
  with profile(activities=[ProfilerActivity.CPU]) as prof:
    with trace.span("probe/outer"):
      with record_function("probe/range"):
        torch.ones(64).mul_(2.0).sum()
  stamp = trace.clock_stamp()
  span, = _spans("probe/outer")
  start, end = (trace.epoch_ns(span["ts"], stamp),
                trace.epoch_ns(span["ts"] + span["dur"], stamp))
  ranges = [e for e in prof.profiler.kineto_results.events()
            if e.name() == "probe/range"]
  assert ranges
  event = ranges[0]
  slack = 50_000  # ns
  assert start - slack <= event.start_ns()
  assert event.start_ns() + event.duration_ns() <= end + slack
  assert span["os_tid"] > 0


def test_phases_tile_their_parent_and_record_nothing_when_off():
  phases = trace.phases("p", "p/a")
  phases.next("p/b", key=1)
  phases.end()
  assert _spans() == []
  trace.enable()
  phases = trace.phases("p", "p/a")
  time.sleep(0.001)
  phases.next("p/b", key=1)
  phases.end()
  by_name = {e["name"]: e for e in _spans()}
  assert set(by_name) == {"p", "p/a", "p/b"}
  parent, a, b = (_interval_ns(by_name[k]) for k in ("p", "p/a", "p/b"))
  assert a[0] == parent[0] and b[1] == parent[1]
  assert abs(a[1] - b[0]) <= 1
  assert by_name["p/b"]["args"] == {"key": 1}
  assert "args" not in by_name["p/a"]


def _engine():
  predictor = predictors.CheckpointPredictor(
      model=sequence_model.SequenceRegressionModel(
          obs_size=4, action_size=2, sequence_length=8, hidden_size=16,
          num_blocks=1, num_heads=2, attention_backend="flash"),
      device="cpu")
  predictor.init_randomly(seed=0)
  return session.SessionEngine(predictor=predictor, max_sessions=4,
                               max_tick_batch=4, device="cpu").warmup()


def test_step_many_is_one_step_span_tiled_by_six_children():
  with metrics_lib.isolated():
    engine = _engine()
    sids = [engine.open() for _ in range(3)]
    rs = np.random.RandomState(0)
    trace.enable()
    fetched = 0
    for _ in range(4):
      out = engine.step_many(
          [(sid, {"observation": rs.randn(4).astype(np.float32)})
           for sid in sids])
      fetched += sum(v.nbytes for v in out[0].values()) * 4  # bucket 4
    trace.disable()
    counted = metrics_lib.counter("serve/session/fetched_bytes").value
  steps = _spans("serve/session/step")
  assert len(steps) == 4
  for step in steps:
    lo, hi = _interval_ns(step)
    children = sorted((e for e in _spans() if e["name"] in SERVE_CHILDREN
                       and lo <= _interval_ns(e)[0] < hi),
                      key=lambda e: e["ts"])
    assert [e["name"] for e in children] == SERVE_CHILDREN
    edges = [_interval_ns(e) for e in children]
    assert edges[0][0] == lo and edges[-1][1] == hi
    for (_, end), (start, _) in zip(edges, edges[1:]):
      assert abs(start - end) <= 1
    assert children[3]["args"] == {"sessions": 3, "bucket": 4}
  assert counted == fetched > 0


def _mock_state_and_batches():
  model = mocks.MockT2RModel(use_ema=True, ema_decay=0.9)
  state = ts.create_train_state(model, torch.Generator().manual_seed(0),
                                torch.device("cpu"))
  x, y = mocks.make_separable_data(16, seed=1)
  return model, state, {"x": torch.from_numpy(x)}, {"y": torch.from_numpy(y)}


def _tree(state, metrics):
  out = {f"m/{k}": v for k, v in metrics.items()}
  for group in ("params", "ema_params", "mutable_state"):
    out.update({f"{group}/{k}": v
                for k, v in (getattr(state, group) or {}).items()})
  return out


def test_train_step_spans_and_no_effect_on_the_numbers():
  model, state, features, labels = _mock_state_and_batches()
  step = ts.make_train_step(model)
  quiet = _tree(*step(state, features, labels))
  assert _spans() == []
  trace.enable()
  traced = _tree(*step(state, features, labels))
  trace.disable()
  assert quiet.keys() == traced.keys()
  for k in quiet:
    assert torch.equal(quiet[k], traced[k]), k
  (outer,) = _spans("train/step")
  (grads,) = _spans("train/gradients")
  (update,) = _spans("train/update")
  lo, hi = _interval_ns(outer)
  g, u = _interval_ns(grads), _interval_ns(update)
  assert lo == g[0] and u[1] == hi and abs(g[1] - u[0]) <= 1
  # The mock's two batch norms, forward and backward, inside the step.
  forward = _spans("model/batch_norm")
  backward = _spans("model/batch_norm.backward")
  assert len(forward) == 2 and len(backward) == 2
  for event in forward + backward:
    assert g[0] <= _interval_ns(event)[0] < g[1]


class _ConvBN(torch.nn.Module):

  def __init__(self):
    super().__init__()
    self.conv = torch.nn.Conv2d(3, 4, 3, padding=1)
    self.bn1 = flax_layers.BatchNorm(4)
    self.bn2 = flax_layers.BatchNorm(4)

  def forward(self, x):
    y, _ = self.bn1(self.conv(x), True)
    y, _ = self.bn2(torch.relu(y), True)
    return y


def test_conv_batch_norm_backward_spans_and_no_hook_when_off():
  net = _ConvBN()
  x = torch.randn(2, 3, 6, 6, generator=torch.Generator().manual_seed(0))
  out = net(x)
  assert out._backward_hooks is None
  out.square().sum().backward()
  assert _spans() == []
  trace.enable()
  out = net(x)
  assert out._backward_hooks
  out.square().sum().backward()
  trace.disable()
  forward = _spans("model/batch_norm")
  backward = _spans("model/batch_norm.backward")
  assert len(forward) == 2 and len(backward) == 2
  # The second norm's backward runs first: the two do not overlap.
  (a_lo, a_hi), (b_lo, b_hi) = sorted(_interval_ns(e) for e in backward)
  assert a_hi <= b_lo
  assert all(e["os_tid"] > 0 for e in forward + backward)


def test_eval_mode_batch_norm_records_nothing():
  trace.enable()
  bn = flax_layers.BatchNorm(4)
  y, new = bn(torch.randn(3, 4, requires_grad=True), False)
  assert new == {} and y._backward_hooks is None
  assert _spans() == []


def test_graftrace_flush_stamps_its_shards_through_clock_stamp(
    tmp_path, monkeypatch):
  from tensor2robot_tpu_torch.obs import graftrace
  import json

  monkeypatch.setattr(trace, "clock_stamp", lambda: (1234, 5678))
  graftrace.configure(str(tmp_path), role="probe")
  try:
    with trace.span("probe/span"):
      pass
    path = graftrace.flush()
  finally:
    graftrace._reset_for_tests()
  with open(path) as f:
    shard = json.load(f)
  assert shard["clock"] == {"perf_ns": 1234, "epoch_ns": 5678}
  assert any(e.get("name") == "probe/span" and e["os_tid"] > 0
             for e in shard["traceEvents"])
