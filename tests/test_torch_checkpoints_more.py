"""The rest of the port's checkpoints module, on the CPU.

* Asynchronous saves (the default): `save` returns before the bytes are
  written, the step in flight is not listed, `wait_until_finished` then
  `restore` gives the state back; two quick saves land in order; a
  failed write is raised by the next wait.
* `checkpoints_iterator` never yields a step before its manifest: a
  writer paused between the rename and the manifest is not seen.
* `backup_checkpoint` survives the writer pruning the source, and the
  backup verifies and restores; `remove_backup` leaves nothing.
* `average_checkpoints` equals the JAX package's on three states carried
  across by the bridge (f32, within 1e-7).
* `warm_start_params`: the restored leaves, the filter and `strict`
  match the JAX package's on the same model (the port names leaves
  `module.weight`, the JAX package `['module']['kernel']`), and the
  merged values are the bridge of JAX's.
"""

import os
import threading

import jax
import numpy as np
import orbax.checkpoint as ocp
import pytest
import torch

from tensor2robot_tpu import checkpoints as jax_checkpoints
from tensor2robot_tpu import specs as jax_specs
from tensor2robot_tpu.parallel import train_step as jax_train_step
from tensor2robot_tpu.research.qtopt import flagship as jax_flagship
from tensor2robot_tpu.research.qtopt import models as jax_models
from tensor2robot_tpu_torch import bridge
from tensor2robot_tpu_torch import checkpoints
from tensor2robot_tpu_torch.parallel import train_step

# The port's tests run in the same worker processes as the JAX suite;
# one torch thread keeps torch from starting its OpenMP and MKL thread
# pools beside XLA's CPU threads.
torch.set_num_threads(1)

AVERAGE_ATOL = 1e-7
WAIT_S = 30


def _state(seed, step=0):
  gen = torch.Generator().manual_seed(seed)
  params = {"w": torch.randn(3, 4, generator=gen),
            "b": torch.randn(4, generator=gen)}
  return train_step.TrainState(
      step=step, params=params,
      ema_params={k: v * 0.5 for k, v in params.items()},
      opt_state=({"count": 1, "mu": {k: v + 1 for k, v in params.items()}},),
      mutable_state={"bn.running_mean": torch.randn(4, generator=gen)})


def _assert_states_equal(got, want):
  assert got.step == want.step
  for name in ("params", "ema_params", "mutable_state"):
    a, b = getattr(got, name), getattr(want, name)
    assert set(a) == set(b)
    for key in b:
      assert torch.equal(a[key], b[key]), (name, key)


def test_async_save_returns_before_the_write(tmp_path, monkeypatch):
  manager = checkpoints.CheckpointManager(str(tmp_path))
  release, writing = threading.Event(), threading.Event()
  plain_save = torch.save

  def slow_save(obj, f):
    writing.set()
    assert release.wait(WAIT_S)
    plain_save(obj, f)

  monkeypatch.setattr(torch, "save", slow_save)
  state = _state(0, step=4)
  assert manager.save(4, state)
  assert writing.wait(WAIT_S)
  # The worker is blocked inside the write: nothing is listed yet.
  assert not (tmp_path / "4").exists()
  assert manager.all_steps() == [] and manager.latest_step() is None
  release.set()
  manager.wait_until_finished()
  assert manager.all_steps() == [4] and manager.verify_step(4) is True
  _assert_states_equal(manager.restore(), state)


def test_two_quick_async_saves_land_in_order(tmp_path):
  manager = checkpoints.CheckpointManager(str(tmp_path), max_to_keep=5)
  first, second = _state(0, step=1), _state(1, step=2)
  assert manager.save(1, first)
  assert manager.save(2, second)  # waits for the first
  assert not manager.save(2, second)  # already on disk once finished
  manager.close()
  assert manager.all_steps() == [1, 2]
  assert all(manager.verify_step(s) is True for s in (1, 2))
  _assert_states_equal(manager.restore(1), first)
  _assert_states_equal(manager.restore(), second)
  assert not any(t.name.startswith("ckpt-save")
                 for t in threading.enumerate())


def test_a_failed_async_save_is_raised(tmp_path, monkeypatch):
  manager = checkpoints.CheckpointManager(str(tmp_path))

  def broken_save(obj, f):
    raise OSError("disk full")

  monkeypatch.setattr(torch, "save", broken_save)
  assert manager.save(3, _state(0, step=3))
  with pytest.raises(RuntimeError, match="asynchronous checkpoint save"):
    manager.wait_until_finished()
  manager.wait_until_finished()  # raised once
  assert manager.all_steps() == []


def test_iterator_waits_for_the_manifest(tmp_path, monkeypatch):
  manager = checkpoints.CheckpointManager(str(tmp_path),
                                          async_checkpointing=False)
  renamed, release = threading.Event(), threading.Event()
  plain_manifest = checkpoints.CheckpointManager._write_manifest

  def paused_manifest(self, step):
    renamed.set()
    assert release.wait(WAIT_S)
    plain_manifest(self, step)

  monkeypatch.setattr(checkpoints.CheckpointManager, "_write_manifest",
                      paused_manifest)
  writer = threading.Thread(target=manager.save, args=(5, _state(0, 5)))
  writer.start()
  try:
    assert renamed.wait(WAIT_S)
    assert (tmp_path / "5" / checkpoints.STATE_FILENAME).is_file()
    assert checkpoints.latest_step(str(tmp_path)) == 5
    assert list(checkpoints.checkpoints_iterator(
        str(tmp_path), timeout_secs=0.01, total_timeout_secs=0.3)) == []
  finally:
    release.set()
    writer.join(WAIT_S)
  assert not writer.is_alive()
  stream = checkpoints.checkpoints_iterator(str(tmp_path), timeout_secs=0.01,
                                            total_timeout_secs=5)
  assert next(stream) == 5


def test_backup_survives_pruning(tmp_path):
  source = tmp_path / "ckpt"
  manager = checkpoints.CheckpointManager(str(source), max_to_keep=1,
                                          async_checkpointing=False)
  state = _state(0, step=10)
  manager.save(10, state)
  backup = checkpoints.backup_checkpoint(str(source), 10)
  assert backup == str(source / "eval_backup" / "10")
  manager.save(20, _state(1, step=20))  # prunes step 10
  assert manager.all_steps() == [20]
  restorer = checkpoints.CheckpointManager(os.path.dirname(backup),
                                           async_checkpointing=False)
  assert restorer.verify_step(10) is True
  _assert_states_equal(restorer.restore(10), state)
  checkpoints.remove_backup(backup)
  assert not (source / "eval_backup").exists()
  assert checkpoints.backup_checkpoint(str(source), 10,
                                       max_attempts=1) is None


@pytest.fixture(scope="module")
def jax_states():
  """Three states of the small critic (seeds 0-2) and the model."""
  model = jax_flagship.make_flagship_model("cpu")
  features = dict(jax_specs.make_random_numpy(
      model.get_feature_specification("train"), batch_size=2, seed=0))
  init = jax.jit(lambda rng, f: jax_train_step.create_train_state(
      model, rng, f)[0])
  return model, [init(jax.random.PRNGKey(seed), features)
                 for seed in range(3)]


def test_average_matches_jax(jax_states, tmp_path):
  _, states = jax_states
  jax_dir, port_dir = tmp_path / "jax", tmp_path / "port"
  jax_manager = jax_checkpoints.CheckpointManager(str(jax_dir),
                                                  async_checkpointing=False)
  port_manager = checkpoints.CheckpointManager(str(port_dir))
  for step, state in zip((10, 20, 30), states):
    jax_manager.save(step, state)
    port_manager.save(step, bridge.train_state_from_jax(state))
  jax_manager.wait_until_finished()
  jax_manager.close()
  port_manager.close()
  for kwargs in ({"last_n": 3}, {"steps": [10, 30]}):
    want = bridge.state_dict_from_flax(
        jax_checkpoints.average_checkpoints(str(jax_dir), **kwargs))
    got = checkpoints.average_checkpoints(str(port_dir), **kwargs)
    assert set(got) == set(want)
    for key in want:
      assert got[key].dtype == torch.float32
      np.testing.assert_allclose(got[key].numpy(), want[key].numpy(),
                                 atol=AVERAGE_ATOL, rtol=0, err_msg=key)
  with pytest.raises(ValueError, match="not found"):
    checkpoints.average_checkpoints(str(port_dir), steps=[999])


def _module(name):
  """The module of a port leaf name or a JAX key path."""
  if name.startswith("["):
    return name.split("']")[0].strip("['")
  return name.rsplit(".", 1)[0]


def test_warm_start_matches_jax(jax_states, tmp_path):
  model, states = jax_states
  # The source: another critic (action 5 widens action_embed) at seed 1.
  wide = jax_models.QTOptModel(device_type="cpu", image_size=32,
                               action_size=5, network="small")
  features = dict(jax_specs.make_random_numpy(
      wide.get_feature_specification("train"), batch_size=2, seed=0))
  source = jax_train_step.create_train_state(wide, jax.random.PRNGKey(1),
                                             features)[0]
  jax_manager = jax_checkpoints.CheckpointManager(str(tmp_path / "jax"),
                                                  async_checkpointing=False)
  jax_manager.save(7, source)
  jax_manager.wait_until_finished()
  jax_manager.close()
  step_dir = tmp_path / "jax" / "7"
  jax_dir = next(str(p) for p in step_dir.iterdir() if p.is_dir())
  port_manager = checkpoints.CheckpointManager(str(tmp_path / "port"),
                                               async_checkpointing=False)
  port_manager.save(7, bridge.train_state_from_jax(source))
  port_dir = str(tmp_path / "port" / "7")

  fresh = jax.device_get(states[0].params)
  port_fresh = bridge.state_dict_from_flax(bridge._numpy_tree(fresh))
  for filters in ((None, None),
                  (lambda p: "fc_" not in p, lambda n: "fc_" not in n)):
    merged, restored = jax_checkpoints.warm_start_params(
        fresh, jax_dir, filter_fn=filters[0])
    port_merged, port_restored = checkpoints.warm_start_params(
        port_fresh, port_dir, filter_fn=filters[1])
    assert len(port_restored) == len(restored)
    assert sorted({_module(n) for n in port_restored}) == sorted(
        {_module(p) for p in restored})
    # A leaf of another shape stays fresh (the action embedding's kernel).
    assert "action_embed.weight" not in port_restored
    assert "action_embed.bias" in port_restored
    want = bridge.state_dict_from_flax(bridge._numpy_tree(merged))
    for key in want:
      assert torch.equal(port_merged[key], want[key]), key

  # strict: a leaf the checkpoint lacks raises in both.
  trimmed = {k: v for k, v in jax.device_get(source.params).items()
             if k != "q"}
  with ocp.StandardCheckpointer() as checkpointer:
    checkpointer.save(str(tmp_path / "trimmed_jax"), {"params": trimmed})
  os.makedirs(tmp_path / "trimmed_port")
  torch.save({"params": bridge.state_dict_from_flax(
      bridge._numpy_tree(trimmed))},
      str(tmp_path / "trimmed_port" / checkpoints.STATE_FILENAME))
  with pytest.raises(ValueError, match="missing"):
    jax_checkpoints.warm_start_params(fresh, str(tmp_path / "trimmed_jax"),
                                      strict=True)
  with pytest.raises(ValueError, match="missing"):
    checkpoints.warm_start_params(port_fresh, str(tmp_path / "trimmed_port"),
                                  strict=True)
  _, restored = jax_checkpoints.warm_start_params(
      fresh, str(tmp_path / "trimmed_jax"))
  _, port_restored = checkpoints.warm_start_params(
      port_fresh, str(tmp_path / "trimmed_port"))
  assert len(port_restored) == len(restored)
