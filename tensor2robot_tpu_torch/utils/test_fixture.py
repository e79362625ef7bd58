"""Model test fixture: train and predict smoke runs and golden-value checks.

Counterpart of `tensor2robot_tpu.utils.test_fixture`: `random_train`
(random inputs, a few steps, the output files asserted), `random_predict`
and `train_and_check_golden_predictions` (a fixed batch's predictions
against a golden .npy), with `assert_output_files`. The runs go through
the port's `train_eval_model` and `predict_from_model`, on CUDA unless
the fixture is given another `device` (tests pass 'cpu').
"""

from __future__ import annotations

import glob
import os
from typing import Dict, Optional

import numpy as np

from tensor2robot_tpu_torch import train_eval
from tensor2robot_tpu_torch.checkpoints import CHECKPOINT_DIRNAME, latest_step
from tensor2robot_tpu_torch.data import input_generators
from tensor2robot_tpu_torch.hooks import core as hooks_lib

__all__ = ["assert_output_files", "T2RModelFixture"]


def assert_output_files(model_dir: str,
                        expect_operative_config: bool = True) -> None:
  """A checkpoint, the operative config and the metrics exist."""
  ckpt_dir = os.path.join(model_dir, CHECKPOINT_DIRNAME)
  if not os.path.isdir(ckpt_dir):
    raise AssertionError(f"no checkpoint dir in {model_dir}")
  if latest_step(ckpt_dir) is None:
    raise AssertionError("no checkpoint written")
  if expect_operative_config and not os.path.isfile(
      os.path.join(model_dir, "operative_config-0.gin")):
    raise AssertionError("operative config not saved")
  if not glob.glob(os.path.join(model_dir, "*", "metrics.jsonl")):
    raise AssertionError("no metrics written")


class T2RModelFixture:
  """Drives a model through short train and predict runs."""

  def __init__(self, model_dir: str, batch_size: int = 4, seed: int = 0,
               device=None):
    self._model_dir = model_dir
    self._batch_size = batch_size
    self._seed = seed
    self._device = device

  def random_train(self, model, max_train_steps: int = 3,
                   **train_kwargs) -> Dict[str, float]:
    """Trains on random spec-shaped data; asserts the output files."""
    train_kwargs.setdefault("device", self._device)
    metrics = train_eval.train_eval_model(
        model=model,
        model_dir=self._model_dir,
        mode="train",
        max_train_steps=max_train_steps,
        checkpoint_every_n_steps=max_train_steps,
        input_generator_train=input_generators.DefaultRandomInputGenerator(
            batch_size=self._batch_size, seed=self._seed),
        hook_builders=[hooks_lib.DefaultHookBuilder()],
        log_every_n_steps=max(1, max_train_steps),
        **train_kwargs)
    assert_output_files(self._model_dir)
    return metrics

  def random_predict(self, model, num_batches: int = 1):
    outputs = train_eval.predict_from_model(
        model=model,
        model_dir=self._model_dir,
        input_generator=input_generators.DefaultRandomInputGenerator(
            batch_size=self._batch_size, seed=self._seed),
        num_batches=num_batches, device=self._device)
    if not outputs:
      raise AssertionError("predict produced no outputs")
    return outputs

  def train_and_check_golden_predictions(
      self, model, golden_path: str,
      max_train_steps: int = 3,
      atol: float = 1e-5,
      update: Optional[bool] = None,
      require: bool = False) -> None:
    """Trains deterministically, then compares a fixed batch's
    predictions to a golden file (1e-5 absolute by default).

    Writes the golden when it is absent (or with update=True, or env
    T2R_UPDATE_GOLDENS=1). With require=True a missing golden is an
    error instead, so a committed golden is compared, never silently
    re-baselined."""
    if update is None and os.environ.get("T2R_UPDATE_GOLDENS") == "1":
      update = True
    if not update and not os.path.isfile(golden_path) and require:
      raise FileNotFoundError(
          f"Golden file {golden_path!r} is missing. Committed goldens "
          "must not be silently re-baselined; regenerate deliberately "
          "with T2R_UPDATE_GOLDENS=1.")
    self.random_train(model, max_train_steps=max_train_steps)
    outputs = train_eval.predict_from_model(
        model=model, model_dir=self._model_dir,
        input_generator=input_generators.DefaultRandomInputGenerator(
            batch_size=self._batch_size, seed=123),
        num_batches=1, device=self._device)[0]
    # The port's outputs are flat (an MDN head's parameters under
    # `mdn_params/<field>`), so every leaf is pinned by its key.
    flat = {key: np.asarray(value) for key, value in outputs.items()}
    if update or not os.path.isfile(golden_path):
      os.makedirs(os.path.dirname(golden_path) or ".", exist_ok=True)
      np.save(golden_path, flat, allow_pickle=True)
      return
    golden = np.load(golden_path, allow_pickle=True).item()
    if set(golden) != set(flat):
      raise AssertionError(f"golden keys {sorted(golden)} != {sorted(flat)}")
    for key in golden:
      np.testing.assert_allclose(
          flat[key], golden[key], atol=atol,
          err_msg=f"golden mismatch for {key!r}")
