"""The port's checkpoints and JSONL summaries, on the CPU.

* A `TrainState` (params, EMA, Adam state, step) round-trips exactly.
* The manifest sidecar has the JAX package's schema
  (`graftguard-manifest-v1`: size and crc32 per file) and describes the
  bytes on disk.
* A flipped byte is caught on restore: the step is quarantined and
  `restore(None)` falls back to the previous step; an explicit corrupt
  step raises. A torn step without a manifest falls back too; an intact
  step whose load fails is a caller error and re-raises.
* `max_to_keep` keeps the newest steps.
* These managers save synchronously (`async_checkpointing=False`): the
  tests read and damage the files on disk right after a save. The
  asynchronous default is held in `test_torch_checkpoints_more.py`.
* `SummaryWriter` skips non-scalar and non-finite values, as the JAX
  package's does.
"""

import json
import os
import zlib

import numpy as np
import pytest
import torch

from tensor2robot_tpu_torch import checkpoints
from tensor2robot_tpu_torch.models import sequence_model
from tensor2robot_tpu_torch.obs import metrics as obs_metrics
from tensor2robot_tpu_torch.parallel import train_step
from tensor2robot_tpu_torch.utils import summaries

# The port's tests run in the same worker processes as the JAX suite;
# one torch thread keeps torch from starting its OpenMP and MKL thread
# pools beside XLA's CPU threads.
torch.set_num_threads(1)

WIDTHS = dict(obs_size=4, action_size=2, hidden_size=16, num_blocks=1,
              num_heads=2, sequence_length=8)


def _state(seed, step=0):
  model = sequence_model.SequenceRegressionModel(use_ema=True, **WIDTHS)
  state = train_step.create_train_state(
      model, torch.Generator().manual_seed(seed), torch.device("cpu"))
  features = {"observation": torch.randn(2, 8, 4)}
  labels = {"action": torch.randn(2, 8, 2)}
  state, _ = train_step.make_train_step(model)(state, features, labels)
  return state.replace(step=step)


def _assert_states_equal(a, b):
  assert a.step == b.step
  flat = lambda s: train_step.map_tensors(  # noqa: E731
      lambda x: x.numpy(), (s.params, s.ema_params, s.opt_state))
  np.testing.assert_equal(flat(a), flat(b))


def _flip_byte(path):
  with open(path, "r+b") as f:
    f.seek(os.path.getsize(path) // 2)
    byte = f.read(1)
    f.seek(-1, os.SEEK_CUR)
    f.write(bytes([byte[0] ^ 0xFF]))


def test_round_trip(tmp_path):
  manager = checkpoints.CheckpointManager(str(tmp_path),
                                          async_checkpointing=False)
  state = _state(0, step=7)
  assert manager.save(7, state)
  assert not manager.save(7, state)  # a step is written once
  restored = manager.restore()
  _assert_states_equal(restored, state)
  assert manager.last_restored_step == 7 and manager.latest_step() == 7
  assert restored.opt_state[0]["count"] == 1
  _assert_states_equal(manager.restore(7), state)


def test_manifest_describes_the_bytes_on_disk(tmp_path):
  manager = checkpoints.CheckpointManager(str(tmp_path),
                                          async_checkpointing=False)
  manager.save(3, _state(1, step=3))
  with open(tmp_path / "manifests" / "3.json") as f:
    manifest = json.load(f)
  assert manifest["schema"] == "graftguard-manifest-v1"
  assert manifest["schema_version"] == 1 and manifest["step"] == 3
  path = tmp_path / "3" / checkpoints.STATE_FILENAME
  data = path.read_bytes()
  assert manifest["files"] == {checkpoints.STATE_FILENAME: {
      "size": len(data), "crc32": zlib.crc32(data) & 0xFFFFFFFF}}
  assert manager.verify_step(3) is True


def test_flipped_byte_is_quarantined_and_restore_falls_back(tmp_path):
  manager = checkpoints.CheckpointManager(str(tmp_path),
                                          async_checkpointing=False)
  older, newer = _state(0, step=10), _state(1, step=20)
  manager.save(10, older)
  manager.save(20, newer)
  _flip_byte(tmp_path / "20" / checkpoints.STATE_FILENAME)
  assert manager.verify_step(20) is False
  assert manager.latest_verified_step() == 10
  with obs_metrics.isolated():
    restored = manager.restore()
    assert obs_metrics.snapshot().get("counter/ckpt/quarantined") == 1
  _assert_states_equal(restored, older)
  assert manager.last_restored_step == 10
  assert manager.all_steps() == [10]
  assert (tmp_path / "quarantine" / "20" / checkpoints.STATE_FILENAME).exists()
  assert (tmp_path / "quarantine" / "20" / "graftguard.manifest.json").exists()
  assert not (tmp_path / "manifests" / "20.json").exists()
  # The quarantined step can be written again.
  assert manager.save(20, newer)
  _assert_states_equal(manager.restore(), newer)


def test_explicit_corrupt_or_missing_step_raises(tmp_path):
  manager = checkpoints.CheckpointManager(str(tmp_path),
                                          async_checkpointing=False)
  manager.save(5, _state(0, step=5))
  _flip_byte(tmp_path / "5" / checkpoints.STATE_FILENAME)
  with pytest.raises(checkpoints.CheckpointCorruptionError):
    manager.restore(5)
  with pytest.raises(FileNotFoundError):
    manager.restore(5)
  with pytest.raises(FileNotFoundError):
    manager.restore()


def test_torn_step_without_manifest_falls_back(tmp_path):
  manager = checkpoints.CheckpointManager(str(tmp_path),
                                          async_checkpointing=False)
  older = _state(0, step=1)
  manager.save(1, older)
  manager.save(2, _state(1, step=2))
  os.remove(tmp_path / "manifests" / "2.json")
  path = tmp_path / "2" / checkpoints.STATE_FILENAME
  path.write_bytes(path.read_bytes()[:0])  # torn: empty file
  _assert_states_equal(manager.restore(), older)
  assert manager.all_steps() == [1]
  # An intact-looking step without a manifest whose load fails is not
  # corruption the manager may quarantine: the error surfaces.
  manager.save(3, _state(2, step=3))
  os.remove(tmp_path / "manifests" / "3.json")
  (tmp_path / "3" / checkpoints.STATE_FILENAME).write_bytes(b"not a pickle")
  with pytest.raises(Exception):
    manager.restore()
  assert manager.all_steps() == [1, 3]


def test_max_to_keep(tmp_path):
  manager = checkpoints.CheckpointManager(str(tmp_path), max_to_keep=2,
                                         async_checkpointing=False)
  state = _state(0)
  for step in (1, 2, 3, 4):
    manager.save(step, state.replace(step=step))
  assert manager.all_steps() == [3, 4]
  assert sorted(os.listdir(tmp_path / "manifests")) == ["3.json", "4.json"]
  assert manager.restore().step == 4


def test_summary_writer_skips_bad_values(tmp_path):
  with obs_metrics.isolated():
    with summaries.SummaryWriter(str(tmp_path)) as writer:
      writer.write_scalars(3, {"loss": torch.tensor(1.5), "n": 2,
                               "vector": np.zeros(3), "nan": float("nan"),
                               "inf": torch.tensor(float("inf")),
                               "word": "text"})
    snapshot = obs_metrics.snapshot()
  with open(tmp_path / "metrics.jsonl") as f:
    (record,) = [json.loads(line) for line in f]
  assert record["step"] == 3 and record["loss"] == 1.5 and record["n"] == 2.0
  assert set(record) == {"step", "time", "loss", "n"}
  assert snapshot["counter/summaries/dropped_non_scalar"] == 2
  assert snapshot["counter/summaries/dropped_non_finite"] == 2
