"""`train_eval_model(mode='continuous_eval')`, `predict_from_model` and
warm starts in the port, on the CPU.

* A writer thread lands checkpoints 2, 4 and 6 (asynchronous saves)
  while `continuous_eval` follows them: it evaluates each, its scalars
  equal an 'evaluate' run on that step alone, it stops after
  `max_train_steps`, and it leaves no backup; on an empty directory it
  stops at `continuous_eval_timeout_secs`.
* The port's and the JAX package's `continuous_eval` agree on the same
  weights carried across by the bridge (f32, within 1e-5 relative), as
  do their `predict_from_model`s on the same weights and batches.
* A warm-started fresh run's step-0 parameters equal the source
  checkpoint's on the restored leaves and the fresh init on the
  filtered ones; its EMA stays the fresh init, as in the JAX package.
"""

import json
import os
import threading
import time

import jax
import numpy as np
import pytest
import torch

from tensor2robot_tpu import checkpoints as jax_checkpoints
from tensor2robot_tpu import specs as jax_specs
from tensor2robot_tpu import train_eval as jax_train_eval
from tensor2robot_tpu.data import input_generators as jax_input_generators
from tensor2robot_tpu.parallel import train_step as jax_train_step
from tensor2robot_tpu.research.qtopt import flagship as jax_flagship
from tensor2robot_tpu_torch import bridge
from tensor2robot_tpu_torch import checkpoints
from tensor2robot_tpu_torch import train_eval
from tensor2robot_tpu_torch.data import input_generators
from tensor2robot_tpu_torch.parallel import train_step
from tensor2robot_tpu_torch.research.qtopt import flagship

# The port's tests run in the same worker processes as the JAX suite;
# one torch thread keeps torch from starting its OpenMP and MKL thread
# pools beside XLA's CPU threads.
torch.set_num_threads(1)

METRIC_RTOL = 1e-5
WAIT_S = 60


def _eval_generator(module=input_generators):
  return module.DefaultRandomInputGenerator(batch_size=2, seed=7)


def _train(model_dir, steps=6, **kwargs):
  train_eval.train_eval_model(
      model=flagship.make_flagship_model("cpu"), model_dir=str(model_dir),
      mode="train", max_train_steps=steps, checkpoint_every_n_steps=2,
      log_every_n_steps=2, device="cpu",
      input_generator_train=input_generators.DefaultRandomInputGenerator(
          batch_size=2), **kwargs)


def _evaluated(model_dir):
  path = os.path.join(model_dir, "eval", "metrics.jsonl")
  if not os.path.isfile(path):
    return []
  with open(path) as f:
    return [json.loads(line) for line in f]


def _continuous(model_dir, **kwargs):
  return train_eval.train_eval_model(
      model=flagship.make_flagship_model("cpu"), model_dir=str(model_dir),
      mode="continuous_eval", eval_steps=2, device="cpu",
      input_generator_eval=_eval_generator(), **kwargs)


def test_follows_a_writer_and_matches_evaluate(tmp_path, monkeypatch):
  monkeypatch.setattr(train_eval, "CONTINUOUS_EVAL_POLL_SECS", 0.02)
  _train(tmp_path / "source")
  source = checkpoints.CheckpointManager(
      str(tmp_path / "source" / "checkpoints"))
  states = {step: source.restore(step) for step in (2, 4, 6)}
  target = tmp_path / "target"
  errors = []

  def writer():
    manager = checkpoints.CheckpointManager(str(target / "checkpoints"),
                                            max_to_keep=1)
    try:
      for step, state in states.items():
        manager.save(step, state)
        manager.wait_until_finished()
        deadline = time.time() + WAIT_S
        while time.time() < deadline and step not in [
            r["step"] for r in _evaluated(target)]:
          time.sleep(0.01)
    except Exception as e:  # noqa: BLE001 - re-raised below
      errors.append(e)

  os.makedirs(target / "checkpoints")
  thread = threading.Thread(target=writer)
  thread.start()
  try:
    last = _continuous(target, max_train_steps=6,
                       continuous_eval_timeout_secs=WAIT_S)
  finally:
    thread.join(WAIT_S)
  assert not errors and not thread.is_alive()
  records = _evaluated(target)
  assert [r["step"] for r in records] == [2, 4, 6]
  assert not (target / "checkpoints" / "eval_backup").exists()
  for record in records:
    # 'evaluate' on a directory holding only that step.
    alone = tmp_path / f"alone_{record['step']}"
    checkpoints.CheckpointManager(
        str(alone / "checkpoints"), async_checkpointing=False).save(
            record["step"], states[record["step"]])
    want = train_eval.train_eval_model(
        model=flagship.make_flagship_model("cpu"), model_dir=str(alone),
        mode="evaluate", eval_steps=2, device="cpu",
        input_generator_eval=_eval_generator())
    got = {k: v for k, v in record.items() if k not in ("step", "time")}
    assert got == want
  assert last == {k: v for k, v in records[-1].items()
                  if k not in ("step", "time")}


def test_stops_at_its_timeout(tmp_path, monkeypatch):
  monkeypatch.setattr(train_eval, "CONTINUOUS_EVAL_POLL_SECS", 0.02)
  start = time.monotonic()
  assert _continuous(tmp_path, max_train_steps=6,
                     continuous_eval_timeout_secs=0.2) == {}
  assert time.monotonic() - start < 30
  assert _evaluated(tmp_path) == []


@pytest.fixture(scope="module")
def same_weights(tmp_path_factory):
  """A JAX state of the small critic saved as step 5 by the JAX package,
  and the same state bridged into the port's checkpoint format."""
  root = tmp_path_factory.mktemp("same_weights")
  model = jax_flagship.make_flagship_model("cpu")
  features = dict(jax_specs.make_random_numpy(
      model.get_feature_specification("train"), batch_size=2, seed=0))
  state = jax_train_step.create_train_state(model, jax.random.PRNGKey(3),
                                            features)[0]
  ema = jax.tree_util.tree_map(lambda x: x * 0.9 + 0.01,
                               jax.device_get(state.params))
  state = state.replace(ema_params=ema, step=np.asarray(5, np.int32))
  jax_manager = jax_checkpoints.CheckpointManager(
      str(root / "jax" / "checkpoints"), async_checkpointing=False)
  jax_manager.save(5, state)
  jax_manager.wait_until_finished()
  jax_manager.close()
  checkpoints.CheckpointManager(
      str(root / "port" / "checkpoints"), async_checkpointing=False).save(
          5, bridge.train_state_from_jax(state))
  return root


def _rel(got, want):
  got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
  return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def test_continuous_eval_matches_jax(same_weights, monkeypatch):
  monkeypatch.setattr(train_eval, "CONTINUOUS_EVAL_POLL_SECS", 0.02)
  want = jax_train_eval.train_eval_model(
      model=jax_flagship.make_flagship_model("cpu"),
      model_dir=str(same_weights / "jax"), mode="continuous_eval",
      max_train_steps=5, eval_steps=2,
      input_generator_eval=_eval_generator(jax_input_generators),
      mesh_shape=(1, 1, 1), step_stats_every_n_steps=0,
      executable_cache_dir=None, continuous_eval_timeout_secs=30)
  got = _continuous(same_weights / "port", max_train_steps=5,
                    continuous_eval_timeout_secs=30)
  assert set(got) == set(want)
  for key in want:
    assert _rel(got[key], want[key]) <= METRIC_RTOL, key
  assert [r["step"] for r in _evaluated(same_weights / "port")] == [5]


def test_predict_from_model_matches_jax(same_weights):
  want = jax_train_eval.predict_from_model(
      model=jax_flagship.make_flagship_model("cpu"),
      model_dir=str(same_weights / "jax"), num_batches=2,
      input_generator=jax_input_generators.DefaultRandomInputGenerator(
          batch_size=3, seed=11))
  got = train_eval.predict_from_model(
      model=flagship.make_flagship_model("cpu"),
      model_dir=str(same_weights / "port"), num_batches=2, device="cpu",
      input_generator=input_generators.DefaultRandomInputGenerator(
          batch_size=3, seed=11))
  assert len(got) == len(want) == 2
  for g, w in zip(got, want):
    assert set(g) == set(w)
    for key in w:
      assert g[key].shape == np.asarray(w[key]).shape
      assert _rel(g[key], w[key]) <= METRIC_RTOL, key


def test_warm_start_of_a_fresh_run(tmp_path):
  _train(tmp_path / "source", steps=2)
  source = checkpoints.CheckpointManager(
      str(tmp_path / "source" / "checkpoints")).restore(2)
  model = flagship.make_flagship_model(
      "cpu", init_checkpoint=str(tmp_path / "source" / "checkpoints" / "2"),
      init_checkpoint_filter=lambda name: not name.startswith("q."))
  fresh = train_step.create_train_state(
      model, torch.Generator().manual_seed(5), torch.device("cpu"))
  train_eval.train_eval_model(
      model=model, model_dir=str(tmp_path / "warm2"), mode="train",
      max_train_steps=0, checkpoint_every_n_steps=2, device="cpu", seed=5,
      input_generator_train=input_generators.DefaultRandomInputGenerator(
          batch_size=2))
  step0 = checkpoints.CheckpointManager(
      str(tmp_path / "warm2" / "checkpoints")).restore(0)
  restored = [k for k in step0.params if not k.startswith("q.")]
  assert restored and len(restored) < len(step0.params)
  for key, value in step0.params.items():
    want = fresh.params[key] if key.startswith("q.") else source.params[key]
    assert torch.equal(value, want), key
    assert torch.equal(step0.ema_params[key], fresh.params[key]), key
  # A resumed run keeps its own weights: no second warm start.
  train_eval.train_eval_model(
      model=model, model_dir=str(tmp_path / "warm2"), mode="train",
      max_train_steps=1, checkpoint_every_n_steps=1, device="cpu", seed=5,
      input_generator_train=input_generators.DefaultRandomInputGenerator(
          batch_size=2))
  assert checkpoints.CheckpointManager(
      str(tmp_path / "warm2" / "checkpoints")).all_steps() == [0, 1]
