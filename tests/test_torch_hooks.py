"""The port's hooks against the JAX package's, on the CPU.

* A recording hook sees the same `(callback, step)` sequence from the
  port's and the JAX package's `train_eval_model` for the same cadences,
  modes, `iterations_per_loop` and `eval_throttle_secs` (the throttle
  pinned by a fake clock that the recording hook sets to 10 s a step).
* The asynchronous `ExportHook` never blocks `after_checkpoint` behind a
  slow export: the newest snapshot waits in a latest-wins slot. An
  export holds the weights of its own step, copied at `after_checkpoint`
  (a later in-place change of the live state does not reach it), and in
  a trained run each bundle equals its step's checkpoint bit for bit.
* A failed asynchronous export is recorded and `end` raises it.
* `BestExportHook` exports only on improvement and resumes its best from
  `best_metric.json`.
* `write_warmup_request` writes the JAX package's JSON for the same spec
  (the port's `make_random_numpy` is JAX's draw for draw); the TD3
  builder's synchronous exports get a warmup request, an asynchronous
  export none.
"""

import json
import os
import threading
import time
import types

import numpy as np
import pytest
import torch

from tensor2robot_tpu import specs as jax_specs
from tensor2robot_tpu import train_eval as jax_train_eval
from tensor2robot_tpu.data import input_generators as jax_input_generators
from tensor2robot_tpu.hooks import core as jax_hooks
from tensor2robot_tpu.hooks import td3 as jax_td3
from tensor2robot_tpu.research.qtopt import flagship as jax_flagship
from tensor2robot_tpu_torch import checkpoints
from tensor2robot_tpu_torch import specs
from tensor2robot_tpu_torch import train_eval
from tensor2robot_tpu_torch.data import input_generators
from tensor2robot_tpu_torch.export import export_generator
from tensor2robot_tpu_torch.hooks import core as hooks
from tensor2robot_tpu_torch.hooks import td3
from tensor2robot_tpu_torch.parallel import train_step
from tensor2robot_tpu_torch.research.qtopt import flagship

# The port's tests run in the same worker processes as the JAX suite;
# one torch thread keeps torch from starting its OpenMP and MKL thread
# pools beside XLA's CPU threads.
torch.set_num_threads(1)

SECONDS_PER_STEP = 10.0


def _recorder(base, clock):
  """A hook class of `base` logging (callback, step), and setting the
  fake clock to 10 s a step at each step."""

  class Recorder(base):

    def __init__(self):
      self.calls = []

    def begin(self, ctx):
      self.calls.append(("begin", None))

    def after_step(self, ctx, step, metrics):
      clock[0] = SECONDS_PER_STEP * step
      self.calls.append(("after_step", int(step)))

    def after_checkpoint(self, ctx, step):
      self.calls.append(("after_checkpoint", int(step)))

    def after_eval(self, ctx, step, metrics):
      self.calls.append(("after_eval", int(step)))

    def end(self, ctx):
      self.calls.append(("end", None))

  return Recorder()


def _builder(base_builder, hook):

  class Builder(base_builder):

    def create_hooks(self, model, model_dir):
      return [hook]

  return Builder()


CASES = {
    "train_and_evaluate_throttled": dict(
        mode="train_and_evaluate", max_train_steps=8,
        checkpoint_every_n_steps=3, eval_every_n_steps=2,
        eval_throttle_secs=25.0, log_every_n_steps=4, eval_steps=1),
    "train_k_steps": dict(mode="train", max_train_steps=7,
                          checkpoint_every_n_steps=2, iterations_per_loop=3,
                          log_every_n_steps=4),
    "evaluate": dict(mode="evaluate", eval_steps=2),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_hook_call_sequence_matches_jax(case, tmp_path, monkeypatch):
  kwargs = CASES[case]
  clock = [0.0]
  fake_time = types.SimpleNamespace(time=lambda: clock[0],
                                    perf_counter=time.perf_counter,
                                    monotonic=time.monotonic,
                                    sleep=time.sleep)
  monkeypatch.setattr(jax_train_eval, "time", fake_time)
  monkeypatch.setattr(train_eval, "time", fake_time)
  calls = {}
  for name in ("jax", "port"):
    clock[0] = 0.0
    if name == "jax":
      hook = _recorder(jax_hooks.Hook, clock)
      jax_train_eval.train_eval_model(
          model=jax_flagship.make_flagship_model("cpu"),
          model_dir=str(tmp_path / name),
          input_generator_train=jax_input_generators
          .DefaultRandomInputGenerator(batch_size=2),
          input_generator_eval=jax_input_generators
          .DefaultRandomInputGenerator(batch_size=2, seed=7),
          hook_builders=[_builder(jax_hooks.HookBuilder, hook)],
          mesh_shape=(1, 1, 1), step_stats_every_n_steps=0,
          executable_cache_dir=None, device_prefetch_depth=0, **kwargs)
    else:
      hook = _recorder(hooks.Hook, clock)
      train_eval.train_eval_model(
          model=flagship.make_flagship_model("cpu"),
          model_dir=str(tmp_path / name),
          input_generator_train=input_generators.DefaultRandomInputGenerator(
              batch_size=2),
          input_generator_eval=input_generators.DefaultRandomInputGenerator(
              batch_size=2, seed=7),
          hook_builders=[_builder(hooks.HookBuilder, hook)], device="cpu",
          device_prefetch_depth=0, **kwargs)
    calls[name] = hook.calls
  assert calls["port"] == calls["jax"]
  assert calls["port"][0] == ("begin", None)
  assert calls["port"][-1] == ("end", None)
  if case == "train_and_evaluate_throttled":
    # Evals cross 2, 4, 6, 8; within 25 s of the last, 2 and 6 are
    # skipped; the last step's eval never is.
    assert [s for c, s in calls["port"] if c == "after_eval"] == [4, 8]


def _states(model):
  """Three distinct states of `model` at steps 10, 20, 30."""
  out = []
  for i, step in enumerate((10, 20, 30)):
    state = train_step.create_train_state(
        model, torch.Generator().manual_seed(i), torch.device("cpu"))
    out.append(state.replace(step=step))
  return out


class _SlowGenerator(export_generator.DefaultExportGenerator):
  """Blocks its first export until released."""

  def __init__(self):
    super().__init__()
    self.started, self.release = threading.Event(), threading.Event()

  def export(self, state, export_dir_base, global_step=None):
    if not self.started.is_set():
      self.started.set()
      assert self.release.wait(30)
    return super().export(state, export_dir_base, global_step)


def test_async_export_never_blocks_and_exports_its_own_step(tmp_path):
  model = flagship.make_flagship_model("cpu")
  states = _states(model)
  live = {"state": None}
  generator = _SlowGenerator()
  hook = hooks.ExportHook(export_generator=generator, num_versions=5,
                          async_export=True)
  ctx = hooks.TrainContext(model, str(tmp_path),
                           get_state=lambda: live["state"])
  hook.begin(ctx)
  try:
    for state in states:
      live["state"] = state
      start = time.monotonic()
      assert hook.after_checkpoint(ctx, state.step) is None
      assert time.monotonic() - start < 5  # never waits for the export
      if state.step == 10:
        assert generator.started.wait(30)
    want = {s.step: {k: v.clone() for k, v in s.ema_params.items()}
            for s in states}
    for value in states[2].ema_params.values():
      value.add_(1.0)  # the live state moves on; the snapshot must not
  finally:
    generator.release.set()
    hook.end(ctx)
  # 20 was replaced in the slot by 30 while 10 was being written.
  assert [e["step"] for e in hook.exports] == [10, 30]
  assert not any(t.name == "export-worker" for t in threading.enumerate())
  for record in hook.exports:
    variables = torch.load(os.path.join(record["path"], "params",
                                        "variables.pt"), weights_only=True)
    for key, value in want[record["step"]].items():
      assert torch.equal(variables["params"][key], value), key


def test_async_exports_of_a_trained_run_equal_their_checkpoints(tmp_path):
  train_eval.train_eval_model(
      model=flagship.make_flagship_model("cpu"), model_dir=str(tmp_path),
      mode="train", max_train_steps=6, checkpoint_every_n_steps=2,
      log_every_n_steps=2, device="cpu",
      input_generator_train=input_generators.DefaultRandomInputGenerator(
          batch_size=2),
      hook_builders=[hooks.AsyncExportHookBuilder(
          export_generator=export_generator.DefaultExportGenerator(),
          num_versions=5, lagged=True)])
  manager = checkpoints.CheckpointManager(str(tmp_path / "checkpoints"))
  bundles = sorted(os.listdir(tmp_path / "export"), key=int)
  steps = []
  for version in bundles:
    path = tmp_path / "export" / version
    step = specs.load_assets(str(path / "t2r_assets.json")).global_step
    steps.append(step)
    state = manager.restore(step)
    variables = torch.load(str(path / "params" / "variables.pt"),
                           weights_only=True)
    for key, value in state.ema_params.items():
      assert torch.equal(variables["params"][key], value), (step, key)
  assert steps == [2, 4, 6]
  assert sorted(os.listdir(tmp_path / "lagged_export"), key=int) == \
      bundles[:-1]


def test_a_failed_async_export_is_raised_at_end(tmp_path):
  model = flagship.make_flagship_model("cpu")
  state = _states(model)[0]

  class Broken(export_generator.DefaultExportGenerator):

    def export(self, state, export_dir_base, global_step=None):
      raise OSError("export volume gone")

  hook = hooks.ExportHook(export_generator=Broken(), async_export=True)
  ctx = hooks.TrainContext(model, str(tmp_path), get_state=lambda: state)
  hook.begin(ctx)
  hook.after_checkpoint(ctx, 10)
  with pytest.raises(RuntimeError, match="export volume gone"):
    hook.end(ctx)
  assert hook.failures[0]["step"] == 10


def test_best_export_hook_exports_on_improvement_and_resumes(tmp_path):
  model = flagship.make_flagship_model("cpu")
  state = _states(model)[0]
  ctx = hooks.TrainContext(model, str(tmp_path), get_state=lambda: state)

  def run(hook, evals):
    hook.begin(ctx)
    exported = []
    for step, loss in evals:
      before = os.listdir(tmp_path / "best_export") if (
          tmp_path / "best_export").exists() else []
      hook.after_eval(ctx, step, {"loss": loss})
      after = os.listdir(tmp_path / "best_export")
      if sorted(after) != sorted(before):
        exported.append(step)
    return exported

  first = hooks.BestExportHook(
      export_generator=export_generator.DefaultExportGenerator())
  assert run(first, [(1, 1.0), (2, 2.0), (3, float("nan")), (4, 0.5)]) == \
      [1, 4]
  versions = [d for d in os.listdir(tmp_path / "best_export") if d.isdigit()]
  assert len(versions) == 1
  with open(tmp_path / "best_export" / "best_metric.json") as f:
    assert json.load(f) == {"metric": "loss", "value": 0.5, "step": 4}
  resumed = hooks.BestExportHook(
      export_generator=export_generator.DefaultExportGenerator())
  assert run(resumed, [(5, 0.7), (6, 0.25)]) == [6]


def test_warmup_request_matches_jax(tmp_path):
  jax_spec = jax_flagship.make_flagship_model(
      "cpu").preprocessor.get_in_feature_specification("predict")
  spec = flagship.make_flagship_model(
      "cpu").preprocessor.get_in_feature_specification("predict")
  os.makedirs(tmp_path / "jax")
  os.makedirs(tmp_path / "port")
  for batch_size in (1, 3):
    jax_path = jax_td3.write_warmup_request(str(tmp_path / "jax"), jax_spec,
                                            batch_size)
    path = td3.write_warmup_request(str(tmp_path / "port"), spec, batch_size)
    with open(path) as f, open(jax_path) as g:
      assert f.read() == g.read()
  want = jax_specs.make_random_numpy(jax_spec, batch_size=4, seed=3)
  got = specs.make_random_numpy(spec, batch_size=4, seed=3)
  assert list(got) == list(want)
  for key in want:
    np.testing.assert_array_equal(got[key], want[key])


def test_td3_builder_writes_warmups_beside_synchronous_exports(tmp_path):
  model = flagship.make_flagship_model("cpu")
  state = _states(model)[0]
  ctx = hooks.TrainContext(model, str(tmp_path), get_state=lambda: state)
  (hook,) = td3.TD3HookBuilder(
      export_generator=export_generator.DefaultExportGenerator(),
      num_versions=2).create_hooks(model, str(tmp_path))
  hook.begin(ctx)
  paths = [hook.after_checkpoint(ctx, step) for step in (10, 20)]
  hook.end(ctx)
  assert all(os.path.isfile(os.path.join(p, td3.WARMUP_FILENAME))
             for p in paths)
  assert os.listdir(tmp_path / "lagged_export") == [os.path.basename(
      paths[0])]
  quiet = td3._WarmupExportHook(
      export_generator=export_generator.DefaultExportGenerator(),
      export_dir_name="async_export", async_export=True)
  quiet.begin(ctx)
  assert quiet.after_checkpoint(ctx, 30) is None
  quiet.end(ctx)
  (path,) = [e["path"] for e in quiet.exports]
  assert not os.path.exists(os.path.join(path, td3.WARMUP_FILENAME))
  # The telemetry hooks are ported: StepStatsHook writes a window row and
  # the trace, SentinelHook the incident totals.
  from tensor2robot_tpu_torch.obs import sentinel as sentinel_lib
  from tensor2robot_tpu_torch.obs import stepstats
  from tensor2robot_tpu_torch.utils import summaries

  recorder = stepstats.StepStatsRecorder(batch_size=4, barrier=lambda s: None,
                                         device_gauges=False)
  watcher = sentinel_lib.Sentinel()
  writer = summaries.SummaryWriter(str(tmp_path / "telemetry"))
  telemetry_ctx = hooks.TrainContext(model, str(tmp_path),
                                     get_state=lambda: state,
                                     summary_writer=writer,
                                     step_stats=recorder, sentinel=watcher)
  recorder.start()
  recorder.end_step(1, state)
  step_hook, sentinel_hook = hooks.StepStatsHook(), hooks.SentinelHook()
  step_hook.after_step(telemetry_ctx, 1, {})
  sentinel_hook.after_step(telemetry_ctx, 1, {"loss": float("nan")})
  step_hook.end(telemetry_ctx)
  sentinel_hook.end(telemetry_ctx)
  writer.close()
  rows = [json.loads(line) for line in open(writer.path)]
  assert rows[0]["step"] == 1 and rows[0]["examples_per_sec"] > 0
  assert rows[-1]["sentinel/nonfinite_metric"] == 1.0
