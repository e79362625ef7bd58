"""The port's graftscope CLI against the JAX package's, on the CPU.

* On a model_dir written by the port's trainer and on one written by the
  JAX package's (two runs each, the second rewound by a NaN under a fault
  plan, so each holds step-stats rows, a trace, two run records,
  incidents and postmortem bundles), both CLIs render the same text for
  `report`, `history`, `diff` and `postmortem`, with the same exit codes;
* the error paths exit alike: 2 for a missing directory or a bad run
  reference, 1 for a directory without telemetry, 3 for a diff past its
  threshold; the subcommands the port has not yet exit 2 naming the
  ROADMAP item;
* `obs/*` and the CLI import, and the CLI renders, with torch and jax
  blocked in `sys.modules`.
"""

from __future__ import annotations

import os
import subprocess
import sys

import pytest
import torch

from tensor2robot_tpu import train_eval as jax_train_eval
from tensor2robot_tpu.bin import graftscope as jax_graftscope
from tensor2robot_tpu.obs import faultlab as jax_faultlab
from tensor2robot_tpu.utils import mocks as jax_mocks
from tensor2robot_tpu_torch import train_eval
from tensor2robot_tpu_torch.bin import graftscope
from tensor2robot_tpu_torch.obs import faultlab
from tensor2robot_tpu_torch.utils import mocks

torch.set_num_threads(1)

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port_run(model_dir, steps):
  train_eval.train_eval_model(
      model=mocks.MockT2RModel(), model_dir=model_dir, mode="train",
      max_train_steps=steps, checkpoint_every_n_steps=4, log_every_n_steps=2,
      device="cpu", input_generator_train=mocks.MockInputGenerator(
          batch_size=8))


def _jax_run(model_dir, steps):
  jax_train_eval.train_eval_model(
      model=jax_mocks.MockT2RModel(device_type="cpu"), model_dir=model_dir,
      mode="train", max_train_steps=steps, checkpoint_every_n_steps=4,
      log_every_n_steps=2, executable_cache_dir=None,
      input_generator_train=jax_mocks.MockInputGenerator(batch_size=8))


@pytest.fixture(scope="module")
def model_dirs(tmp_path_factory):
  """{"port": dir, "jax": dir}: a clean run to 8, then a run resumed to 12
  whose first log (step 10) is poisoned, so it rewinds to 8."""
  root = tmp_path_factory.mktemp("graftscope")
  dirs = {"port": str(root / "port"), "jax": str(root / "jax")}
  for which, run, module in (("port", _port_run, faultlab),
                             ("jax", _jax_run, jax_faultlab)):
    run(dirs[which], 8)
    plan = module.FaultPlan([module.FaultSpec(point="train.nonfinite",
                                              at=(0,), count=1)])
    with plan.activated():
      run(dirs[which], 12)
  return dirs


def _both(capsys, argv):
  """(exit code, stdout) of the port's CLI and of the JAX package's."""
  out = []
  for module in (graftscope, jax_graftscope):
    code = module.main(list(argv))
    out.append((code, capsys.readouterr().out))
  return out


@pytest.mark.parametrize("writer", ["port", "jax"])
@pytest.mark.parametrize("command", [
    ["report"], [], ["history"], ["diff", "{dir}#0", "{dir}#1"],
    ["diff", "--trend", "-k", "1"], ["postmortem"], ["postmortem", "--list"],
    ["postmortem", "--index", "0", "--steps", "3"]])
def test_both_clis_render_the_same_text(capsys, model_dirs, writer, command):
  model_dir = model_dirs[writer]
  argv = [arg.format(dir=model_dir) for arg in command]
  if not any("{dir}" in arg for arg in command):
    argv.append(model_dir)
  port, jax = _both(capsys, argv)
  assert port == jax
  code, text = port
  assert code in (0, 3) and text


def test_rendered_run_carries_the_rewind(capsys, model_dirs):
  (code, text), _ = _both(capsys, ["postmortem", model_dirs["port"]])
  assert code == 0
  assert "reason: incident:nonfinite_metric" in text
  assert "nonfinite_metric" in text and "value=nan" in text
  (code, text), _ = _both(capsys, ["report", model_dirs["port"]])
  assert code == 0 and "step-time breakdown" in text
  assert "train/step_window" in text and "run history (2 record(s)" in text


def test_error_paths_exit_alike(capsys, tmp_path, model_dirs):
  empty = tmp_path / "empty"
  empty.mkdir()
  missing = str(tmp_path / "missing")
  for argv, want in (
      (["report", missing], 2), (["report", str(empty)], 1),
      (["history", missing], 2), (["history", str(empty)], 2),
      (["diff", missing, missing], 2),
      (["diff", f"{model_dirs['port']}#7", model_dirs["port"]], 2),
      (["diff", model_dirs["port"]], 2),
      (["diff", f"{model_dirs['port']}#0", f"{model_dirs['port']}#1",
        "--threshold", "step_ms=-1", "--threshold",
        "examples_per_sec=-1"], 3),
      (["postmortem", missing], 2), (["postmortem", str(empty)], 1),
      (["postmortem", "--list", str(empty)], 1),
      (["postmortem", "--index", "9", model_dirs["port"]], 2)):
    port, jax = _both(capsys, argv)
    assert port == jax, argv
    assert port[0] == want, (argv, port)


@pytest.mark.parametrize("name", ["cache", "forge", "audit", "timeline",
                                  "watch"])
def test_subcommands_not_ported_exit_2_naming_the_item(capsys, name):
  """Every subcommand is ported: `timeline`, `watch`, `cache`, `forge`
  and `audit` exit 2 only on a usage error, a missing directory or
  config, with the JAX CLI's code (`tests/test_torch_graftrace.py`,
  `tests/test_torch_graftwatch.py`, `tests/test_torch_compile_serving.py`
  and `tests/test_torch_graph_audit.py` hold the rest)."""
  assert graftscope.main([name, "x"]) == 2
  err = capsys.readouterr().err
  if name in ("timeline", "watch"):
    assert f"graftscope {name}: no such directory: x" in err
  elif name == "cache":
    assert "no cache directory at x" in err
  else:
    assert f"graftscope {name}: no such config: x" in err
  assert jax_graftscope.main([name, "x"]) == 2


def test_obs_and_the_cli_run_with_torch_and_jax_blocked(model_dirs):
  obs_dir = os.path.join(REPO_ROOT, "tensor2robot_tpu_torch", "obs")
  modules = sorted(name[:-3] for name in os.listdir(obs_dir)
                   if name.endswith(".py") and name != "__init__.py")
  assert {"faultlab", "flightrec", "runlog", "sentinel", "stepstats",
          "xray"} <= set(modules)
  code = (
      "import importlib, sys\n"
      "for name in ('torch', 'jax', 'tensor2robot_tpu'):\n"
      "  sys.modules[name] = None\n"
      f"for module in {modules!r}:\n"
      "  importlib.import_module('tensor2robot_tpu_torch.obs.' + module)\n"
      "from tensor2robot_tpu_torch.bin import graftscope\n"
      f"assert graftscope.main(['postmortem', {model_dirs['port']!r}]) == 0\n"
      f"assert graftscope.main(['report', {model_dirs['port']!r}]) == 0\n"
      "assert 'torch' not in [m for m in sys.modules if sys.modules[m]]\n"
      "print('FRAMEWORK_FREE_OK')\n")
  result = subprocess.run([sys.executable, "-c", code], cwd=REPO_ROOT,
                          capture_output=True, text=True, timeout=120)
  assert result.returncode == 0, result.stderr[-3000:]
  assert "FRAMEWORK_FREE_OK" in result.stdout
