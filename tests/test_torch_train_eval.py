"""The port's `train_eval_model`, trainer CLI and checkpoint predictor, on
the CPU at small widths.

* Cadence: with `iterations_per_loop` 1 and 3, scalars are logged and
  checkpoints saved where a dispatch crosses a multiple of the interval,
  the last step is always logged and a checkpoint is forced at the end —
  the JAX package's `_crossed` rule.
* The files a run writes: `train/metrics.jsonl`, `checkpoints/<step>/`,
  `checkpoints/manifests/<step>.json`.
* Resume: a second call continues from the newest checkpoint, and the
  final state equals the same steps run through `make_train_step` on the
  same batches from the same initial state (K-step loops included: the
  same arithmetic, so exactly equal).
* The CLI parses `--config_files` / `--config` with argparse and trains.
* `CheckpointPredictor(model_dir=...)` serves the newest verified step.
"""

import json
import os

import numpy as np
import pytest
import torch

from tensor2robot_tpu_torch import checkpoints
from tensor2robot_tpu_torch import train_eval
from tensor2robot_tpu_torch.bin import run_t2r_trainer
from tensor2robot_tpu_torch.data import input_generators
from tensor2robot_tpu_torch.models import sequence_model
from tensor2robot_tpu_torch.parallel import train_step
from tensor2robot_tpu_torch.predictors import predictors
from tensor2robot_tpu_torch.utils import config

# The port's tests run in the same worker processes as the JAX suite;
# one torch thread keeps torch from starting its OpenMP and MKL thread
# pools beside XLA's CPU threads.
torch.set_num_threads(1)

WIDTHS = dict(obs_size=4, action_size=2, hidden_size=16, num_blocks=2,
              num_heads=2, sequence_length=12, attention_backend="flash")
REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _model(**kwargs):
  return sequence_model.SequenceRegressionModel(**WIDTHS, **kwargs)


def _generator(seed=0):
  return input_generators.DefaultRandomInputGenerator(batch_size=2, seed=seed)


def _train(model_dir, model=None, **kwargs):
  kwargs.setdefault("max_train_steps", 7)
  kwargs.setdefault("checkpoint_every_n_steps", 3)
  kwargs.setdefault("log_every_n_steps", 2)
  return train_eval.train_eval_model(
      model=model or _model(), model_dir=str(model_dir), mode="train",
      input_generator_train=_generator(), device="cpu", seed=0, **kwargs)


def _logged(model_dir):
  """The loss rows of a run's metrics.jsonl (its step-stats windows and
  final registry snapshot are rows of their own)."""
  with open(os.path.join(model_dir, "train", "metrics.jsonl")) as f:
    return [r for r in map(json.loads, f) if "loss" in r]


def _manager(model_dir):
  return checkpoints.CheckpointManager(
      os.path.join(model_dir, checkpoints.CHECKPOINT_DIRNAME))


def _reference_state(model, steps, seed=0):
  """`steps` train steps through `make_train_step`: the same initial
  state and batch stream as `train_eval_model`."""
  state = train_step.create_train_state(
      model, torch.Generator().manual_seed(seed), torch.device("cpu"))
  generator = _generator()
  generator.set_specification_from_model(model, "train")
  stream = generator.create_dataset("train")
  step = train_step.make_train_step(model)
  for _ in range(steps):
    batch = next(stream)
    state, _ = step(state, batch["features"], batch["labels"])
  return state


def _assert_states_equal(a, b):
  assert a.step == b.step
  flat = lambda s: train_step.map_tensors(  # noqa: E731
      lambda x: x.numpy(), (s.params, s.ema_params, s.opt_state))
  np.testing.assert_equal(flat(a), flat(b))


@pytest.mark.parametrize("iterations_per_loop,logged,saved", [
    (1, [2, 4, 6, 7], [3, 6, 7]),
    (3, [3, 6, 7], [3, 6, 7]),
    (2, [2, 4, 6, 7], [4, 6, 7]),
])
def test_cadence_and_files(tmp_path, iterations_per_loop, logged, saved):
  metrics = _train(tmp_path, iterations_per_loop=iterations_per_loop)
  records = _logged(tmp_path)
  assert [r["step"] for r in records] == logged
  assert set(metrics) == {"loss", "mse", "global_gradient_norm"}
  assert metrics["loss"] == records[-1]["loss"]
  assert all(np.isfinite(r["loss"]) for r in records)
  assert _manager(tmp_path).all_steps() == saved
  assert sorted(os.listdir(tmp_path / "checkpoints" / "manifests")) == [
      f"{s}.json" for s in saved]
  assert all(_manager(tmp_path).verify_step(s) for s in saved)


@pytest.mark.parametrize("iterations_per_loop", [1, 3])
def test_final_state_equals_plain_train_steps(tmp_path, iterations_per_loop):
  model = _model(use_ema=True)
  _train(tmp_path, model=model, iterations_per_loop=iterations_per_loop)
  _assert_states_equal(_manager(tmp_path).restore(),
                       _reference_state(model, 7))


def test_resume_continues_from_the_newest_checkpoint(tmp_path):
  model = _model()
  _train(tmp_path, model=model, max_train_steps=4, checkpoint_every_n_steps=2)
  assert _manager(tmp_path).all_steps() == [2, 4]
  # Nothing left to do: no step runs, nothing is logged or saved.
  assert _train(tmp_path, model=model, max_train_steps=4) == {}
  _train(tmp_path, model=model, max_train_steps=6, checkpoint_every_n_steps=2)
  assert [r["step"] for r in _logged(tmp_path)] == [2, 4, 6]
  assert _manager(tmp_path).all_steps() == [2, 4, 6]
  # The resumed run restarts the stream from its seed: steps 5 and 6 see
  # batches 1 and 2 of the stream, after the 4 steps of the first run.
  state = _reference_state(model, 4)
  generator = _generator()
  generator.set_specification_from_model(model, "train")
  stream = generator.create_dataset("train")
  step = train_step.make_train_step(model)
  for _ in range(2):
    batch = next(stream)
    state, _ = step(state, batch["features"], batch["labels"])
  _assert_states_equal(_manager(tmp_path).restore(), state)


def test_resume_skips_a_corrupt_newest_checkpoint(tmp_path):
  model = _model()
  _train(tmp_path, model=model, max_train_steps=4, checkpoint_every_n_steps=2)
  path = tmp_path / "checkpoints" / "4" / checkpoints.STATE_FILENAME
  data = bytearray(path.read_bytes())
  data[len(data) // 2] ^= 0xFF
  path.write_bytes(bytes(data))
  _train(tmp_path, model=model, max_train_steps=4, checkpoint_every_n_steps=2)
  assert _manager(tmp_path).all_steps() == [2, 4]
  assert (tmp_path / "checkpoints" / "quarantine" / "4").is_dir()


def test_other_modes_and_missing_inputs_raise(tmp_path):
  for mode in ("evaluate", "train_and_evaluate", "continuous_eval"):
    with pytest.raises(ValueError, match="input_generator_eval"):
      train_eval.train_eval_model(model=_model(), model_dir=str(tmp_path),
                                  mode=mode, device="cpu",
                                  input_generator_train=_generator())
  with pytest.raises(ValueError, match="Unknown train_eval mode"):
    train_eval.train_eval_model(model=_model(), model_dir=str(tmp_path),
                                mode="dance", device="cpu")
  with pytest.raises(ValueError, match="input_generator_train"):
    train_eval.train_eval_model(model=_model(), model_dir=str(tmp_path),
                                mode="train", device="cpu")


def test_cli_trains_from_the_long_context_config(tmp_path):
  config_file = os.path.join(REPO_ROOT, "tensor2robot_tpu_torch", "configs",
                             "train_longcontext_flash.gin")
  bindings = [f"train_eval_model.model_dir = '{tmp_path}'",
              "train_eval_model.device = 'cpu'",
              "train_eval_model.max_train_steps = 3",
              "train_eval_model.checkpoint_every_n_steps = 2",
              "SequenceRegressionModel.sequence_length = 12",
              "SequenceRegressionModel.hidden_size = 16",
              "SequenceRegressionModel.num_heads = 2"]
  try:
    argv = ["--config_files", config_file]
    for binding in bindings:
      argv += ["--config", binding]
    metrics = run_t2r_trainer.main(argv)
    assert config.query_parameter("SequenceRegressionModel.use_bfloat16")
    assert config.query_parameter(
        "DefaultRandomInputGenerator.batch_size") == 2
  finally:
    config.clear_config()
  assert np.isfinite(metrics["loss"])
  assert [r["step"] for r in _logged(tmp_path)] == [3]
  assert _manager(tmp_path).all_steps() == [2, 3]


def test_checkpoint_predictor_serves_the_newest_verified_step(tmp_path):
  model = _model(use_ema=True)
  _train(tmp_path, model=model, max_train_steps=4, checkpoint_every_n_steps=2)
  predictor = predictors.CheckpointPredictor(
      model=_model(use_ema=True), model_dir=str(tmp_path), device="cpu")
  assert predictor.restore() and predictor.global_step == 4
  state = _manager(tmp_path).restore()
  obs = np.random.RandomState(0).randn(1, 12, 4).astype(np.float32)
  want = train_step.make_predict_fn(model)(
      state, {"observation": torch.from_numpy(obs)})["action"].numpy()
  np.testing.assert_array_equal(predictor.predict({"observation": obs})[
      "action"], want)
  assert predictor.state.opt_state is None  # serving keeps no Adam moments
  empty = predictors.CheckpointPredictor(
      model=_model(), model_dir=str(tmp_path / "nothing"), device="cpu")
  assert not empty.restore()


@pytest.mark.parametrize("depth", [0, 3])
def test_prefetch_depth_does_not_change_the_run(tmp_path, depth):
  model = _model()
  _train(tmp_path / "ref", model=model)
  _train(tmp_path / "depth", model=model, device_prefetch_depth=depth)
  _assert_states_equal(_manager(tmp_path / "depth").restore(),
                       _manager(tmp_path / "ref").restore())


@pytest.mark.parametrize("depth", [2, 0])
def test_no_loader_thread_outlives_a_run_from_records(tmp_path, depth):
  """Three evals and a train stream on `OverlappedLoader`s: every stream
  is closed when its loop ends, so no thread the call started is alive
  right after it returns."""
  import threading

  from tensor2robot_tpu_torch.research.qtopt import models as qtopt_models
  from tests import torch_data_fixtures as fx

  model = qtopt_models.QTOptModel(image_size=32, action_size=4,
                                  network="small")
  train_glob, eval_glob = fx.write_critic_records(tmp_path, model)
  before = set(threading.enumerate())
  metrics = train_eval.train_eval_model(
      model=model, model_dir=str(tmp_path / "run"), device="cpu",
      mode="train_and_evaluate", max_train_steps=6, eval_every_n_steps=2,
      eval_steps=1, checkpoint_every_n_steps=6, log_every_n_steps=2,
      device_prefetch_depth=depth, host_overlap_workers=2,
      input_generator_train=input_generators.DefaultRecordInputGenerator(
          file_patterns=train_glob, batch_size=4, seed=0),
      input_generator_eval=input_generators.DefaultRecordInputGenerator(
          file_patterns=eval_glob, batch_size=4))
  alive = [t.name for t in threading.enumerate() if t not in before]
  assert alive == []
  with open(os.path.join(tmp_path, "run", "train", "metrics.jsonl")) as f:
    evals = [json.loads(line)["step"] for line in f if "eval/loss" in line]
  assert evals == [2, 4, 6] and np.isfinite(metrics["eval/loss"])
