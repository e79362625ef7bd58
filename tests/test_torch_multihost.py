"""Multi-host init and the preemption exit, in the port and the JAX
package.

* The two-process case of tests/test_multiprocess.py as a 2-rank gloo
  world: a global batch assembled from each process's local rows and a
  collective sum of 6; a dead coordinator is a clean `RuntimeError`
  within the deadline.
* tests/test_train_eval.py's TestPreemption on both packages, with
  `reached_preemption` patched: exit 42 with a checkpoint at step 7,
  then a resume to 20.
* A real SIGTERM to one rank of a 2-rank world: both ranks save the same
  step and exit 42, rank 0 alone writing; the resume reaches step 10.
* `configs/train_sp_ring.gin` through the trainer CLI in a 4-rank world
  launched the way `torchrun` launches it (its environment variables).
"""

import json
import os
import subprocess
import sys
import time

import pytest
import torch

from tensor2robot_tpu import checkpoints as jax_checkpoints
from tensor2robot_tpu import train_eval as jax_train_eval
from tensor2robot_tpu.utils import mocks as jax_mocks
from tensor2robot_tpu_torch import checkpoints
from tensor2robot_tpu_torch import train_eval
from tensor2robot_tpu_torch.parallel import mesh as mesh_lib
from tensor2robot_tpu_torch.utils import mocks
from tests import test_torch_mesh_world as torch_mesh_world

torch.set_num_threads(1)

REPO_ROOT = torch_mesh_world.REPO_ROOT


def test_two_process_global_batch_and_collective(tmp_path):
  results = torch_mesh_world.run_world(
      2, "tests.test_torch_mesh_cases:global_batch_sum", None, tmp_path)
  for result in results:
    # rank 0 contributes 0 * 6, rank 1 contributes 1 * 6.
    assert result == {"total": 6.0, "size": 2, "world_size": 2}


def test_dead_coordinator_fails_fast_and_clearly():
  port = torch_mesh_world.free_port()  # nothing listens on it
  start = time.monotonic()
  with pytest.raises(RuntimeError, match="did not become reachable") as info:
    mesh_lib.initialize_multihost(
        coordinator_address=f"127.0.0.1:{port}", num_processes=2,
        process_id=1, initialization_timeout_secs=3, backend="gloo")
  assert "127.0.0.1" in str(info.value)
  assert time.monotonic() - start < 30
  assert not torch.distributed.is_initialized()


def test_one_process_is_a_no_op_and_a_bad_address_raises():
  mesh_lib.initialize_multihost(coordinator_address=None, num_processes=1)
  assert not torch.distributed.is_initialized()
  with pytest.raises(ValueError, match="<host>:<port>"):
    mesh_lib.initialize_multihost(coordinator_address="nohostport",
                                  num_processes=2, process_id=1)


class TestPreemption:
  """A preemption signal mid-training checkpoints and exits 42, and the
  next run resumes from it: the JAX package's trainer and the port's."""

  @pytest.mark.parametrize("package", ["jax", "port"])
  def test_preemption_saves_and_exits(self, tmp_path, monkeypatch, package):
    if package == "jax":
      trainer, ckpt, lib, extra = (jax_train_eval, jax_checkpoints,
                                   jax_mocks, {})
      model_kwargs = {"device_type": "cpu"}
    else:
      trainer, ckpt, lib, extra = (train_eval, checkpoints, mocks,
                                   {"device": "cpu"})
      model_kwargs = {}
    fired = {"at": 7}
    monkeypatch.setattr(ckpt.CheckpointManager, "reached_preemption",
                        lambda self, step: step == fired["at"])
    model_dir = str(tmp_path / "m")
    with pytest.raises(SystemExit) as excinfo:
      trainer.train_eval_model(
          model=lib.MockT2RModel(**model_kwargs), model_dir=model_dir,
          mode="train", max_train_steps=100, checkpoint_every_n_steps=100,
          mesh_shape=(1, 1, 1),
          input_generator_train=lib.MockInputGenerator(batch_size=4),
          log_every_n_steps=50, **extra)
    assert excinfo.value.code == 42
    assert ckpt.latest_step(os.path.join(model_dir, "checkpoints")) == 7
    monkeypatch.setattr(ckpt.CheckpointManager, "reached_preemption",
                        lambda self, step: False)
    trainer.train_eval_model(
        model=lib.MockT2RModel(**model_kwargs), model_dir=model_dir,
        mode="train", max_train_steps=20, checkpoint_every_n_steps=20,
        mesh_shape=(1, 1, 1),
        input_generator_train=lib.MockInputGenerator(batch_size=4),
        log_every_n_steps=20, **extra)
    assert ckpt.latest_step(os.path.join(model_dir, "checkpoints")) == 20


def test_sigterm_on_one_rank_saves_one_step_on_every_rank(tmp_path):
  results = torch_mesh_world.run_world(
      2, "tests.test_torch_mesh_cases:preempted_world",
      {"model_dir": str(tmp_path / "m")}, tmp_path / "world")
  codes = [r["code"] for r in results]
  assert codes == [42, 42]
  step = results[0]["latest_after_preemption"]
  # Rank 1's SIGTERM came with its 6th batch: both ranks saved the step
  # they agreed on, and rank 0 alone wrote it.
  assert results[0]["preempted_writes"] == [step] and 4 <= step <= 6
  assert results[1]["preempted_writes"] == [] and results[1]["writes"] == []
  assert results[1]["latest_after_preemption"] == step
  assert results[0]["writes"] == [step, 10]
  assert results[0]["latest"] == 10


def test_sp_ring_config_trains_through_the_cli_on_four_ranks(tmp_path):
  model_dir = str(tmp_path / "m")
  port = torch_mesh_world.free_port()
  procs = []
  for rank in range(4):
    env = {**os.environ, "PYTHONPATH": REPO_ROOT, "OMP_NUM_THREADS": "1",
           "RANK": str(rank), "WORLD_SIZE": "4", "LOCAL_RANK": str(rank),
           "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port)}
    with open(tmp_path / f"rank{rank}.log", "w") as log:
      procs.append(subprocess.Popen(
          [sys.executable, "-m",
           "tensor2robot_tpu_torch.bin.run_t2r_trainer", "--config_files",
           "tensor2robot_tpu_torch/configs/train_sp_ring.gin",
           "--config", f"train_eval_model.model_dir = '{model_dir}'",
           "--config", "train_eval_model.device = 'cpu'",
           "--config", "train_eval_model.max_train_steps = 6",
           "--config", "train_eval_model.checkpoint_every_n_steps = 3",
           "--config", "train_eval_model.log_every_n_steps = 1"],
          stdout=log, stderr=subprocess.STDOUT, cwd=REPO_ROOT, env=env))
  for rank, proc in enumerate(procs):
    proc.wait(timeout=180)
    assert proc.returncode == 0, (tmp_path / f"rank{rank}.log").read_text()
  manager = checkpoints.CheckpointManager(os.path.join(model_dir,
                                                       "checkpoints"))
  assert manager.all_steps() == [3, 6]
  assert all(manager.verify_step(s) is True for s in (3, 6))
  with open(os.path.join(model_dir, "train", "metrics.jsonl")) as f:
    losses = [r["loss"] for r in map(json.loads, f) if "loss" in r]
  # One writer: one row per step.
  assert len(losses) == 6 and losses[-1] < losses[0]
