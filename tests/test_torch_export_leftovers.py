"""The export and serving leftovers on the port, against the JAX package:
the profiler hook, the pickled-assets converter, the image aliases,
`place_on_device` and the `run_graftserve` CLI.

* `ProfilerHook`: a profiler that cannot start is logged once, counted
  (`counter/profiler/start_failures`), disarms, and the run goes on
  (`gauge/profiler/trace_captured` 0), in both packages; on the port a
  window of training steps writes a Chrome trace under
  `<model_dir>/profile/` naming the steps' work, and `graftscope report`
  lists the directory.
* `convert_pickle_assets`: both packages convert one pickle (legacy
  `(shape, dtype[, name])` tuples, nested) to the same specs.
* `utils.image` re-exports the codec's four functions, as the JAX one
  does; an image round-trips through both alike.
* `place_on_device` moves a restored state and keeps it there across a
  `restore()`.
* `run_graftserve`, single engine and `--replicas 2` on ['cpu', 'cpu']:
  every request succeeds, the rungs warm once, none compiled; with
  `--executable_cache_dir` every rung compiles (`engine_compiles`,
  `compile_sec`) into the cache, and a second run loads them all.
"""

import json
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

from tensor2robot_tpu import specs as jax_specs
from tensor2robot_tpu.hooks import profiler as jax_profiler
from tensor2robot_tpu.obs import metrics as jax_metrics
from tensor2robot_tpu.utils import convert_pkl_assets as jax_convert
from tensor2robot_tpu.utils import image as jax_image
from tensor2robot_tpu_torch import specs
from tensor2robot_tpu_torch import train_eval
from tensor2robot_tpu_torch.bin import graftscope
from tensor2robot_tpu_torch.export import export_generator
from tensor2robot_tpu_torch.hooks import profiler
from tensor2robot_tpu_torch.obs import metrics
from tensor2robot_tpu_torch.parallel import train_step
from tensor2robot_tpu_torch.predictors import predictors
from tensor2robot_tpu_torch.utils import config
from tensor2robot_tpu_torch.utils import convert_pkl_assets
from tensor2robot_tpu_torch.utils import image
from tensor2robot_tpu_torch.utils import mocks

torch.set_num_threads(1)

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _clean_config():
  config.clear_config()
  yield
  config.clear_config()


# -- the profiler hook ----------------------------------------------------------------


def _fail_jax(monkeypatch, calls):
  import jax

  def boom(log_dir):
    calls.append(log_dir)
    raise RuntimeError("profiler service unreachable")

  monkeypatch.setattr(jax.profiler, "start_trace", boom)
  return jax_profiler, jax_metrics


def _fail_port(monkeypatch, calls):

  def boom(*args, **kwargs):
    calls.append(kwargs)
    raise RuntimeError("profiler unavailable")

  monkeypatch.setattr(torch.profiler, "profile", boom)
  return profiler, metrics


@pytest.mark.parametrize("fail", [_fail_port, _fail_jax],
                         ids=["port", "jax"])
def test_start_failure_logs_once_and_disarms(tmp_path, monkeypatch, fail):
  calls = []
  profiler_lib, metrics_lib = fail(monkeypatch, calls)
  with metrics_lib.isolated() as registry:
    hook = profiler_lib.ProfilerHook(start_step=1, num_steps=2)
    ctx = type("Ctx", (), {"model_dir": str(tmp_path)})()
    hook.after_step(ctx, 1, {})  # must NOT raise
    hook.after_step(ctx, 1, {})  # disarmed: no retry
    hook.after_step(ctx, 3, {})
    hook.end(ctx)
    snap = registry.snapshot()
  assert len(calls) == 1
  assert snap["counter/profiler/start_failures"] == 1.0
  assert snap["gauge/profiler/trace_captured"] == 0.0


def test_window_writes_a_chrome_trace_that_graftscope_lists(tmp_path,
                                                            capsys):
  model_dir = str(tmp_path / "run")
  with metrics.isolated() as registry:
    train_eval.train_eval_model(
        model=mocks.MockT2RModel(), model_dir=model_dir, mode="train",
        max_train_steps=6, checkpoint_every_n_steps=6,
        input_generator_train=mocks.MockInputGenerator(batch_size=4),
        hook_builders=[profiler.ProfilerHookBuilder(start_step=2,
                                                    num_steps=2)],
        log_every_n_steps=6, device="cpu")
    snap = registry.snapshot()
  assert snap["gauge/profiler/trace_captured"] == 1.0
  trace_path = os.path.join(model_dir, "profile", "steps_2-4.chrome.json")
  with open(trace_path) as f:
    events = json.load(f)["traceEvents"]
  names = {e.get("name", "") for e in events}
  # The window holds the train steps' work: their matrix products.
  assert any("addmm" in n or "mm" == n.split("::")[-1] for n in names)
  assert graftscope.main(["report", model_dir]) == 0
  assert os.path.join(model_dir, "profile") in capsys.readouterr().out


# -- pickled assets, image aliases -----------------------------------------------


def test_convert_pickle_assets_matches_the_jax_package(tmp_path):
  payload = {
      "feature_spec": {
          "image": ((64, 64, 3), "uint8", "state/image"),
          "pose": ((7,), "float32", "state/pose"),
          "nested": {"action": ((2,), "float32")},
      },
      "label_spec": {"reward": ((1,), "float32", "reward")},
  }
  path = str(tmp_path / "assets.pkl")
  with open(path, "wb") as f:
    pickle.dump(payload, f)
  port = convert_pkl_assets.convert_pickle_assets(
      path, str(tmp_path / "port.json"), global_step=7)
  jax = jax_convert.convert_pickle_assets(
      path, str(tmp_path / "jax.json"), global_step=7)
  for got, want in ((port.feature_spec, jax.feature_spec),
                    (port.label_spec, jax.label_spec)):
    assert list(got) == list(want)
    for key in want:
      assert got[key].to_dict() == want[key].to_dict(), key
  reloaded = specs.load_assets(str(tmp_path / "port.json"))
  assert reloaded.global_step == 7
  assert sorted(reloaded.feature_spec) == sorted(port.feature_spec)
  jax_reloaded = jax_specs.load_assets(str(tmp_path / "port.json"))
  assert sorted(jax_reloaded.feature_spec) == sorted(port.feature_spec)


def test_image_aliases_round_trip_like_the_jax_package():
  assert image.__all__ == jax_image.__all__
  rng = np.random.RandomState(0)
  array = rng.randint(0, 255, (24, 32, 3), np.uint8)
  for fmt in ("png", "jpeg"):
    data = image.encode_image(array, fmt)
    assert data == jax_image.encode_image(array, fmt)
    np.testing.assert_array_equal(image.decode_image(data, channels=3),
                                  jax_image.decode_image(data, channels=3))
  batch = image.decode_image_batch([image.encode_image(array, "png")] * 2,
                                   channels=3)
  assert batch.shape == (2, 24, 32, 3)
  small = image.maybe_recompress_jpeg(image.encode_image(array, "png"),
                                      quality=60, max_side=16)
  assert max(image.decode_image(small, channels=3).shape[:2]) == 16


# -- place_on_device -----------------------------------------------------------------


def test_place_on_device_is_sticky_across_restore(tmp_path):
  model_dir = str(tmp_path / "m")
  train_eval.train_eval_model(
      model=mocks.MockT2RModel(), model_dir=model_dir, mode="train",
      max_train_steps=2, checkpoint_every_n_steps=2,
      input_generator_train=mocks.MockInputGenerator(batch_size=4),
      log_every_n_steps=2, device="cpu")
  predictor = predictors.CheckpointPredictor(
      model=mocks.MockT2RModel(), model_dir=model_dir, device="cpu")
  with pytest.raises(ValueError, match="no model loaded"):
    predictor.place_on_device("cpu")
  assert predictor.restore()
  moved = []
  original = train_step.TrainState.to

  def spy(state, device):
    moved.append(torch.device(device))
    return original(state, device)

  with pytest.MonkeyPatch.context() as patch:
    patch.setattr(train_step.TrainState, "to", spy)
    predictor.place_on_device(torch.device("cpu"))
  assert moved == [torch.device("cpu")]
  assert predictor.device == torch.device("cpu")
  x = {"x": np.ones((2, 3), np.float32)}
  before = predictor.predict(x)["prediction"]
  assert predictor.restore()
  assert all(v.device == torch.device("cpu")
             for v in predictor.state.params.values())
  np.testing.assert_array_equal(predictor.predict(x)["prediction"], before)


# -- run_graftserve --------------------------------------------------------------------


@pytest.fixture(scope="module")
def mock_export(tmp_path_factory):
  # The bundle's operative config is the process's: cleared first, it
  # binds only what this export used (a test that ran before in the same
  # worker would otherwise rebind the CLI's configurables through it).
  config.clear_config()
  root = str(tmp_path_factory.mktemp("serve") / "export")
  model = mocks.MockT2RModel()
  generator = export_generator.DefaultExportGenerator()
  generator.set_specification_from_model(model)
  generator.export(train_step.create_train_state(
      model, torch.Generator().manual_seed(0), torch.device("cpu")), root,
      global_step=3)
  config.clear_config()
  return root


def _graftserve(*argv):
  return subprocess.run(
      [sys.executable, "-m", "tensor2robot_tpu_torch.bin.run_graftserve",
       *argv], capture_output=True, text=True, timeout=240, cwd=REPO_ROOT,
      env={**os.environ, "PYTHONPATH": REPO_ROOT})


@pytest.mark.parametrize("replicas,devices", [(1, "cpu"), (2, "cpu,cpu")])
def test_graftserve_serves_every_request(mock_export, replicas, devices):
  result = _graftserve(
      "--export_dir", mock_export, "--replicas", str(replicas),
      "--devices", devices, "--concurrency", "4",
      "--requests_per_thread", "10", "--config_files",
      os.path.join(REPO_ROOT, "tensor2robot_tpu_torch", "configs",
                   "serve_fleet.gin"))
  assert result.returncode == 0, result.stderr[-3000:]
  line = json.loads(result.stdout.strip().splitlines()[-1])
  assert line["ok"] == 40 and line["errors"] == {}
  assert line["replicas"] == replicas and line["global_step"] == 3
  assert line["buckets"] == [1, 2, 4, 8, 16]
  warms = [5] * replicas if replicas > 1 else 5
  assert line["engine_warms"] == warms
  # No cache directory: the rungs run eagerly, none is compiled.
  assert line["compile_sec"] == []
  assert line["engine_compiles"] == ([0] * replicas if replicas > 1 else 0)
  assert line["latency_ms"]["count"] == 40.0
  assert line["fleet_shed"] == 0.0


def test_graftserve_refuses_the_executable_cache(mock_export, tmp_path):
  """The flag was refused until the executable cache was ported (item
  15.3); now it compiles every rung into the cache, and a second run
  loads each rung's entry instead of storing it."""
  cache_dir = str(tmp_path / "excache")
  lines = []
  for _ in range(2):
    result = _graftserve("--export_dir", mock_export, "--devices", "cpu",
                         "--concurrency", "2", "--requests_per_thread", "5",
                         "--executable_cache_dir", cache_dir)
    assert result.returncode == 0, result.stderr[-3000:]
    lines.append(json.loads(result.stdout.strip().splitlines()[-1]))
  rungs = len(lines[0]["buckets"])  # the default ladder, 1 to 8
  for line in lines:
    assert line["ok"] == 10 and line["errors"] == {}
    assert line["buckets"] == [1, 2, 4, 8] and line["engine_warms"] == 4
    assert len(line["compile_sec"]) == rungs
    assert all(s > 0 for s in line["compile_sec"])
  # Fresh compiles: every rung cold, none warm (each loads its entry).
  assert [line["engine_compiles"] for line in lines] == [rungs, 0]
  assert len([n for n in os.listdir(cache_dir)
              if n.endswith(".json")]) == rungs
