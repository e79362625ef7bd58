"""The compiled, X-rayed train step and the rest of `utils/backend.py`,
against the JAX package, on the CPU.

* `XrayedFunction` around a small `SequenceRegressionModel` step
  (`aot_eager`, flash attention through the registered operators) trains
  the JAX package's three bridged steps at the eager step's tolerances
  (tests/test_torch_train_step.py), with no graph break and no recompile
  after the first call, and its record carries the JAX package's record
  keys (those of `analyze_jit` on a jitted step here), `graph_breaks`
  0, and `flops` equal to `FlopCounterMode` over the eager step (the
  flash operators counted by their formulas).
* The degrade contract, as the JAX package's: a forced compile failure
  runs the eager step and counts `xray/analyze_failures`; a later call
  whose recompile fails runs eagerly and counts
  `xray/compiled_call_fallbacks`; an error while the compiled step runs
  is raised, not retried.
* `train_eval_model(executable_cache_dir='auto')` writes a run record
  whose `compile` block `runlog` reads (`compile_time_s`), and the two
  packages' `graftscope diff` give the same exit code and compile
  metric on two such records.
* The heartbeat monitor's knobs (`ok=None`, a per-probe slow threshold,
  the transition cap) give the JAX monitor's states, causes and
  timeline; the timing probes keep its warm-up, barrier and clamp
  discipline; `analytic_mfu` is its formula at the H100's peak.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from tensor2robot_tpu.bin import graftscope as jax_graftscope
from tensor2robot_tpu.obs import runlog as jax_runlog
from tensor2robot_tpu.obs import xray as jax_xray
from tensor2robot_tpu.parallel import train_step as jax_train_step
from tensor2robot_tpu.utils import backend as jax_backend
from tensor2robot_tpu_torch import bridge
from tensor2robot_tpu_torch import train_eval
from tensor2robot_tpu_torch.bin import graftscope
from tensor2robot_tpu_torch.data import input_generators
from tensor2robot_tpu_torch.obs import metrics as metrics_lib
from tensor2robot_tpu_torch.obs import runlog
from tensor2robot_tpu_torch.obs import xray
from tensor2robot_tpu_torch.parallel import train_step
from tensor2robot_tpu_torch.utils import backend
from tests import test_torch_train_step as tts

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _isolated_registry():
  with metrics_lib.isolated():
    xray.clear_records()
    yield
  xray.clear_records()


def _jax_record_keys():
  """The keys of the JAX package's record of a jitted step here."""
  fn = jax.jit(lambda x, y: (x @ y).sum())
  _, record = jax_xray.analyze_jit("probe", fn, jax.numpy.ones((4, 4)),
                                   jax.numpy.ones((4, 4)), collect=False)
  return set(record)


def test_compiled_step_trains_the_jax_steps():
  jax_model, model = tts._models(use_ema=True)
  batches = tts._batches(3)
  jax_state, _ = jax_train_step.create_train_state(
      jax_model, jax.random.PRNGKey(0), batches[0][0])
  state = bridge.train_state_from_jax(jax_state)
  jax_step = jax_train_step.make_train_step(jax_model, donate=False)
  eager = train_step.make_train_step(model)
  compiled = xray.XrayedFunction("train_step", eager, model=model)
  flops = None
  for i, (features, labels) in enumerate(batches):
    (jf, jl), (pf, pl) = tts._preprocess_both(jax_model, model, features,
                                              labels)
    if i == 0:
      with FlopCounterMode(display=False) as counter:
        eager(state, pf, pl)
      flops = counter.get_total_flops()
    jax_state, jax_metrics = jax_step(jax_state, jf, jl)
    state, metrics = compiled(state, pf, pl)
    for key in ("loss", "mse", "global_gradient_norm"):
      assert abs(float(metrics[key]) - float(jax_metrics[key])) <= \
          tts.F32_TOL, key
  assert compiled.compiled and compiled.recompiles == 0
  tts._assert_params_close(jax_state.params, state.params, 3, tts.PARAM_TOL)
  tts._assert_params_close(jax_state.ema_params, state.ema_params, 3,
                           tts.PARAM_TOL)
  record = compiled.record
  assert record["graph_breaks"] == 0 and record["graphs"] >= 1
  assert record["flops"] == flops > 0
  assert record["backend"] == "aot_eager"
  ported = {"name", "trace_s", "lower_s", "compile_s", "jaxpr_eqns",
            "donated_bytes", "undonated_bytes", "flops", "bytes_accessed",
            "temp_bytes", "arithmetic_intensity", "roofline_ms",
            "peak_flops", "peak_hbm_bw"}
  assert ported <= set(record)
  # Every key the port shares with JAX's record is one JAX writes.
  assert ported - {"temp_bytes", "arithmetic_intensity", "roofline_ms",
                   "peak_flops", "peak_hbm_bw"} <= _jax_record_keys()
  assert record["peak_flops"] == backend.H100_PEAK_BF16_FLOPS == 989e12
  assert record["temp_bytes"] > 0 and record["bytes_accessed"] is None
  assert xray.records() == [record]
  snapshot = metrics_lib.snapshot(prefix="xray/")
  assert snapshot["counter/xray/analyses"] == 1
  assert "counter/xray/analyze_failures" not in snapshot


def test_the_compiled_region_gives_the_eager_gradients():
  jax_model, model = tts._models()
  del jax_model
  features, labels = tts._batches(1)[0]
  pf, pl = model.preprocessor.preprocess(
      {k: torch.from_numpy(v) for k, v in features.items()},
      {k: torch.from_numpy(v) for k, v in labels.items()}, "train")
  state = train_step.create_train_state(model, torch.Generator().manual_seed(0),
                                        torch.device("cpu"))
  compiled = xray.XrayedFunction("train_step",
                                 train_step.make_train_step(model),
                                 model=model)
  compiled(state, pf, pl)
  region = compiled._compiled.forward_loss
  want = train_step.loss_and_grads(model, state.params, pf, pl,
                                   state.mutable_state)
  got = train_step.loss_and_grads(model, state.params, pf, pl,
                                  state.mutable_state, forward_loss_fn=region)
  assert float(got[0]) == pytest.approx(float(want[0]), rel=1e-6)
  assert set(got[2]) == set(want[2])
  for key, grad in want[2].items():
    np.testing.assert_allclose(got[2][key].numpy(), grad.numpy(),
                               rtol=1e-5, atol=1e-6, err_msg=key)
  assert compiled.recompiles == 0


def test_a_forced_compile_failure_runs_the_eager_step(monkeypatch):
  monkeypatch.setitem(xray.COMPILE_BACKENDS, "cpu", "no-such-backend")
  x = torch.arange(6.0)
  fn = xray.XrayedFunction("failing", lambda t: t * 2)
  assert torch.equal(fn(x), x * 2) and torch.equal(fn(x), x * 2)
  assert not fn.compiled
  assert metrics_lib.snapshot()["counter/xray/analyze_failures"] == 1


def test_a_failed_recompile_falls_back_and_an_execution_error_raises():
  torch._dynamo.reset()

  def step(t):
    if t.shape[0] == 3:
      torch._dynamo.graph_break()  # under fullgraph: the compile fails
    return torch.linalg.cholesky(t @ t.T + t.shape[0] * torch.eye(
        t.shape[0])) if t.ndim == 2 else t * 2

  fn = xray.XrayedFunction("fallback", step)
  assert torch.equal(fn(torch.ones(2)), torch.full((2,), 2.0))
  assert fn.compiled
  assert torch.equal(fn(torch.ones(3)), torch.full((3,), 2.0))
  assert not fn.compiled
  snapshot = metrics_lib.snapshot()
  assert snapshot["counter/xray/compiled_call_fallbacks"] == 1
  assert "counter/xray/analyze_failures" not in snapshot
  # An error of the step itself, in the compiled graph, is raised.
  torch._dynamo.reset()
  chol = xray.XrayedFunction("cholesky", torch.linalg.cholesky)
  chol(torch.eye(3))
  with pytest.raises(torch.linalg.LinAlgError):
    chol(-torch.eye(3))
  assert metrics_lib.snapshot().get(
      "counter/xray/compiled_call_fallbacks", 0) == 1


def _train(model_dir, cache_dir):
  model = tts._models()[1]
  generator = input_generators.DefaultRandomInputGenerator(batch_size=2)
  train_eval.train_eval_model(
      model=model, model_dir=str(model_dir), mode="train",
      max_train_steps=2, checkpoint_every_n_steps=2,
      input_generator_train=generator, device="cpu",
      executable_cache_dir=cache_dir)
  return runlog.load_records(os.path.join(model_dir, "runs.jsonl"))[-1]


def test_train_eval_writes_the_compile_block_both_graftscopes_read(
    tmp_path, monkeypatch, capsys):
  monkeypatch.setenv("TORCHINDUCTOR_CACHE_DIR", str(tmp_path / "inductor"))
  cold = _train(tmp_path / "a", "auto")
  warm = _train(tmp_path / "b", str(tmp_path / "a" / "excache"))
  for record in (cold, warm):
    (compile_record,) = record["compile"]
    assert compile_record["name"] == "train_step"
    assert compile_record["graph_breaks"] == 0
    assert runlog.key_metrics(record)["compile_time_s"] == pytest.approx(
        compile_record["compile_s"])
    assert jax_runlog.key_metrics(record)["compile_time_s"] == \
        pytest.approx(compile_record["compile_s"])
    assert record["memory"]["hbm_watermark_bytes"] >= \
        compile_record["temp_bytes"]
  assert cold["compile"][0]["cache"]["hit"] is False
  assert warm["compile"][0]["cache"]["hit"] is True
  assert warm["extra"]["cache"]["counter/cache/hits"] == 1
  assert os.listdir(tmp_path / "a" / "excache")
  runs = [str(tmp_path / d / "runs.jsonl") for d in ("a", "b")]
  codes = [graftscope.main(["diff", *runs]),
           jax_graftscope.main(["diff", *runs])]
  out = capsys.readouterr().out
  assert codes[0] == codes[1] and "compile_time_s" in out


def test_train_eval_default_stays_eager(tmp_path):
  record = _train(tmp_path / "eager", None)
  assert "compile" not in record
  assert record["extra"]["cache"]["counter/cache/misses"] == 0


def test_heartbeat_knobs_match_the_jax_monitor():
  clock = iter(float(t) for t in range(100))
  ticks = lambda: next(clock)  # noqa: E731
  monitors = [backend.HeartbeatMonitor(degraded_after_s=5.0, clock=ticks,
                                       max_transitions=3),
              jax_backend.HeartbeatMonitor(degraded_after_s=5.0,
                                           clock=ticks, max_transitions=3)]
  probes = [(True, 1.0, None), (True, 6.0, None), (None, 0.0, None),
            (False, 0.0, None), (True, 1.0, None), (True, 9.0, 10.0),
            (True, 11.0, 10.0), (None, 0.0, None)]
  states = [[], []]
  for ok, elapsed, slow in probes:
    for i, monitor in enumerate(monitors):
      states[i].append(monitor.record_probe(ok, elapsed, source="t",
                                            degraded_after_s=slow,
                                            cause=None if ok is not False
                                            else "boom"))
  assert states[0] == states[1]
  blocks = [m.health_block() for m in monitors]
  strip = lambda ts: [{k: v for k, v in t.items() if k != "unix_time"}  # noqa
                      for t in ts]
  assert strip(blocks[0]["transitions"]) == strip(blocks[1]["transitions"])
  assert len(blocks[0]["transitions"]) == 3
  assert blocks[0]["cause"] == blocks[1]["cause"] == "slow_probe"


class _State:
  def __init__(self, leaf):
    self.params = {"w": leaf, "b": torch.zeros(1)}


def test_time_train_steps_runs_warmup_and_iters_and_reports_halves():
  import time as _time

  calls = []

  def step(state, features, labels):
    calls.append((features, labels))
    if len(calls) == 3:  # the first timed step
      _time.sleep(0.05)
    return state, {}

  h1, h2, out = backend.time_train_steps_halves(
      step, _State(torch.zeros(3)), "f", "l", iters=6, warmup=2)
  assert len(calls) == 8 and calls[0] == ("f", "l")
  assert h1 > h2 > 0 and isinstance(out, _State)
  sec, _ = backend.time_train_steps(step, out, "f", "l", iters=4, warmup=0)
  assert sec > 0 and len(calls) == 12


def test_time_train_steps_halves_clamps_barrier_dominated_windows(
    monkeypatch):
  import time as _time

  real = backend.state_barrier

  def slow_barrier(state):
    _time.sleep(0.03)
    return real(state)

  monkeypatch.setattr(backend, "state_barrier", slow_barrier)
  flags = {}
  h1, h2, _ = backend.time_train_steps_halves(
      lambda s, f, l: (s, {}), _State(torch.zeros(1)), "f", "l", iters=4,
      warmup=0, out_flags=flags)
  assert flags.get("barrier_dominated") is True
  assert 0.0 < h1 < 0.015 and 0.0 < h2 < 0.015


def test_time_op_and_sync_and_mfu():
  x = torch.ones(8)
  assert backend.sync({"a": [x]})["a"][0] is x
  assert backend.time_op(lambda t: t * 2, x, iters=5) >= 0.0
  with pytest.raises(ValueError):
    backend.time_op(lambda t: t, x, iters=1)
  flops, seconds = 1e12, 0.01
  assert xray.analytic_mfu(flops, seconds) == pytest.approx(
      jax_xray.analytic_mfu(flops, seconds, peak_flops=989e12))
  assert backend.H100_PEAK_HBM_BW == 3.35e12
