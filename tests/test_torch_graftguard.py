"""Divergence rewind and checkpoint integrity: the port against the JAX
package under one fault plan, on the CPU.

* Checkpoint integrity (the JAX package's `TestCheckpointIntegrity`
  fault cases): the same saves and the same `FaultPlan` (or the same
  `_corrupt_step_for_faultlab` call) in both managers give the same
  verdicts, the same quarantined steps, the same fallback step and the
  same errors.
* Divergence rewind (its `TestDivergenceRewind`): `MockT2RModel` trained
  by both `train_eval_model`s under the same plan — the same rewind
  targets, quarantined and re-saved checkpoint steps and escalation
  messages (budget exhausted, no verified checkpoint, a NaN right after
  a rewind), and the same `graftguard`, `faultlab` and non-finite
  `sentinel` blocks in the run record. The sentinel's timing detectors
  (step-time spikes, starvation) read wall clocks, so only its
  non-finite kinds are compared.
* Within the port, a rewound run's final state equals a clean resume
  from a copy of its rewind target, bit for bit; the same holds for the
  slice at small widths (`SequenceRegressionModel`, flash backend on
  its plain version, 2 blocks, head_dim 16), whose flash calls count
  the replayed steps.
"""

from __future__ import annotations

import os
import shutil

import numpy as np
import pytest
import torch

from tensor2robot_tpu import checkpoints as jax_checkpoints
from tensor2robot_tpu import train_eval as jax_train_eval
from tensor2robot_tpu.obs import faultlab as jax_faultlab
from tensor2robot_tpu.obs import flightrec as jax_flightrec
from tensor2robot_tpu.obs import runlog as jax_runlog
from tensor2robot_tpu.utils import mocks as jax_mocks
from tensor2robot_tpu_torch import checkpoints
from tensor2robot_tpu_torch import train_eval
from tensor2robot_tpu_torch.data import input_generators
from tensor2robot_tpu_torch.models import sequence_model
from tensor2robot_tpu_torch.obs import faultlab
from tensor2robot_tpu_torch.obs import flightrec
from tensor2robot_tpu_torch.obs import runlog
from tensor2robot_tpu_torch.ops import attention as attention_ops
from tensor2robot_tpu_torch.parallel import train_step
from tensor2robot_tpu_torch.utils import mocks

torch.set_num_threads(1)

NONFINITE_KINDS = ("nonfinite_metric", "nonfinite_params")


def _plans(specs, seed=0):
  """The same plan in both packages: (port plan, JAX plan)."""
  return tuple(module.FaultPlan([module.FaultSpec(**s) for s in specs],
                                seed=seed)
               for module in (faultlab, jax_faultlab))


# -- checkpoint integrity ------------------------------------------------------

def _port_state():
  return train_step.TrainState(
      step=0, params={"a": torch.arange(16.0),
                      "b": torch.zeros(4, dtype=torch.float32)})


def _jax_state():
  return {"a": np.arange(16.0), "b": np.zeros((4,), np.float32)}


class _Both:
  """One integrity scenario run on both managers."""

  def __init__(self, root):
    self.dirs = {"port": str(root / "port"), "jax": str(root / "jax")}

  def manager(self, which):
    if which == "port":
      return checkpoints.CheckpointManager(self.dirs["port"],
                                           async_checkpointing=False)
    return jax_checkpoints.CheckpointManager(self.dirs["jax"],
                                             async_checkpointing=False)

  def save(self, steps):
    for which, state in (("port", _port_state()), ("jax", _jax_state())):
      manager = self.manager(which)
      for step in steps:
        manager.save(step, state)
      manager.wait_until_finished()
      manager.close()

  def corrupt(self, step, mode):
    checkpoints._corrupt_step_for_faultlab(self.dirs["port"], step, mode)
    jax_checkpoints._corrupt_step_for_faultlab(self.dirs["jax"], step, mode)

  def run(self, fn):
    """fn(which, manager) in both; each outcome or error as text."""
    out = {}
    for which in ("port", "jax"):
      manager = self.manager(which)
      try:
        out[which] = fn(which, manager)
      except (checkpoints.CheckpointCorruptionError,
              jax_checkpoints.CheckpointCorruptionError,
              FileNotFoundError) as e:
        out[which] = (type(e).__name__,
                      str(e).replace(self.dirs[which], "<dir>"))
      manager.close()
    return out["port"], out["jax"]

  def quarantined(self):
    lists = []
    for which in ("port", "jax"):
      qdir = os.path.join(self.dirs[which], checkpoints.QUARANTINE_DIRNAME)
      lists.append(sorted(os.listdir(qdir)) if os.path.isdir(qdir) else [])
    return tuple(lists)


def test_bitflip_is_detected_quarantined_and_falls_back(tmp_path):
  both = _Both(tmp_path)
  both.save([1, 2])
  both.corrupt(2, "bitflip")

  def scenario(which, manager):
    verdicts = (manager.verify_step(1), manager.verify_step(2))
    manager.restore()
    return verdicts, manager.last_restored_step, manager.latest_step()

  port, jax = both.run(scenario)
  assert port == jax == ((True, False), 1, 1)
  assert both.quarantined() == (["2"], ["2"])


def test_torn_latest_step_without_manifest_falls_back(tmp_path):
  both = _Both(tmp_path)
  both.save([1])
  # A step dir a crashed writer left without a manifest: an empty state
  # file in the port's layout, unparseable metadata in orbax's.
  os.makedirs(os.path.join(both.dirs["port"], "5"))
  open(os.path.join(both.dirs["port"], "5", checkpoints.STATE_FILENAME),
       "wb").close()
  os.makedirs(os.path.join(both.dirs["jax"], "5"))
  with open(os.path.join(both.dirs["jax"], "5", "_CHECKPOINT_METADATA"),
            "w") as f:
    f.write("{")

  def scenario(which, manager):
    latest = manager.latest_step()
    manager.restore()
    return latest, manager.last_restored_step

  port, jax = both.run(scenario)
  assert port == jax == (5, 1)
  assert both.quarantined() == (["5"], ["5"])


@pytest.mark.parametrize("mode", ["torn", "bitflip"])
def test_explicit_corrupt_step_raises(tmp_path, mode):
  both = _Both(tmp_path)
  both.save([1, 2])
  both.corrupt(2, mode)
  port, jax = both.run(lambda which, manager: manager.restore(2))
  assert port == jax
  assert port[0] == "CheckpointCorruptionError"


def test_every_step_corrupt_raises_and_missing_step_is_not_found(tmp_path):
  both = _Both(tmp_path)
  both.save([1])
  port, jax = both.run(lambda which, manager: manager.restore(7))
  assert port[0] == jax[0] == "FileNotFoundError"
  both.corrupt(1, "bitflip")
  port, jax = both.run(lambda which, manager: manager.restore())
  assert port[0] == jax[0] == "CheckpointCorruptionError"
  assert port[1] == jax[1]


@pytest.mark.parametrize("point", ["ckpt.torn", "ckpt.bitflip"])
def test_fault_plan_corrupts_after_the_manifest(tmp_path, point):
  both = _Both(tmp_path)
  port_plan, jax_plan = _plans([dict(point=point, at=(1,))])

  def save_and_check(which, manager):
    state = _port_state() if which == "port" else _jax_state()
    plan = port_plan if which == "port" else jax_plan
    with plan.activated():
      manager.save(1, state)
      manager.save(2, state)  # <- corrupted by the plan
      manager.wait_until_finished()
    verdicts = (manager.verify_step(1), manager.verify_step(2))
    verified = manager.latest_verified_step()
    manager.restore()
    return verdicts, verified, manager.last_restored_step, plan.summary()

  port, jax = both.run(save_and_check)
  assert port == jax
  assert port[:3] == ((True, False), 1, 1)
  assert port[3]["by_point"] == {point: 1}


# -- divergence rewind -----------------------------------------------------------

def _train_both(root, specs, steps=12, max_rewinds=2, log_every=1):
  """Both trainers on MockT2RModel under one plan: {which: result}, where
  a result is ("ok", run-record extra) or ("error", message)."""
  port_plan, jax_plan = _plans(specs)
  runs = {
      "port": lambda d: train_eval.train_eval_model(
          model=mocks.MockT2RModel(), model_dir=d, mode="train",
          max_train_steps=steps, checkpoint_every_n_steps=4,
          log_every_n_steps=log_every, max_rewinds=max_rewinds,
          device="cpu",
          input_generator_train=mocks.MockInputGenerator(batch_size=8)),
      "jax": lambda d: jax_train_eval.train_eval_model(
          model=jax_mocks.MockT2RModel(device_type="cpu"), model_dir=d,
          mode="train", max_train_steps=steps, checkpoint_every_n_steps=4,
          log_every_n_steps=log_every, executable_cache_dir=None,
          max_rewinds=max_rewinds,
          input_generator_train=jax_mocks.MockInputGenerator(batch_size=8)),
  }
  results = {}
  for which, plan in (("port", port_plan), ("jax", jax_plan)):
    model_dir = str(root / which)
    with plan.activated():
      try:
        metrics = runs[which](model_dir)
      except RuntimeError as e:
        results[which] = ("error", str(e))
        continue
    assert np.isfinite(metrics["loss"])
    record = (runlog if which == "port" else jax_runlog).load_records(
        os.path.join(model_dir, runlog.RUNS_FILENAME))[-1]
    extra = record["extra"]
    results[which] = ("ok", {
        "final_step": extra["final_step"],
        "graftguard": extra["graftguard"], "faultlab": extra["faultlab"],
        "nonfinite": {k: v for k, v in extra["sentinel"]["by_kind"].items()
                      if k in NONFINITE_KINDS}})
  return results


def _on_disk(root, which):
  ckpt_dir = os.path.join(str(root / which), checkpoints.CHECKPOINT_DIRNAME)
  qdir = os.path.join(ckpt_dir, checkpoints.QUARANTINE_DIRNAME)
  return (sorted(int(n) for n in os.listdir(ckpt_dir) if n.isdigit()),
          sorted(os.listdir(qdir)) if os.path.isdir(qdir) else [])


def test_nan_rewinds_to_the_verified_checkpoint_and_completes(tmp_path):
  results = _train_both(tmp_path, [dict(point="train.nonfinite", at=(6,),
                                        count=1)])
  assert results["port"] == results["jax"]
  status, extra = results["port"]
  assert status == "ok" and extra["final_step"] == 12
  assert extra["graftguard"] == {"rewinds": 1, "rewind_steps": [4]}
  assert extra["faultlab"]["by_point"] == {"train.nonfinite": 1}
  assert extra["nonfinite"] == {"nonfinite_metric": 1}
  # The fatal incident dumped a postmortem bundle before the rewind.
  (bundle,) = flightrec.find_bundles(str(tmp_path / "port"))
  assert "incident_nonfinite_metric" in bundle
  assert len(jax_flightrec.find_bundles(str(tmp_path / "jax"))) == 1
  assert _on_disk(tmp_path, "port") == _on_disk(tmp_path, "jax")


def test_rewind_saves_a_quarantined_step_again(tmp_path):
  results = _train_both(tmp_path, [
      dict(point="ckpt.bitflip", at=(1,), count=1),
      dict(point="train.nonfinite", at=(9,), count=1)])
  assert results["port"] == results["jax"]
  assert results["port"][1]["graftguard"]["rewind_steps"] == [4]
  # The bit-flipped step-8 save is quarantined by the rewind's walk and
  # written again when the replay crosses it.
  assert _on_disk(tmp_path, "port") == _on_disk(tmp_path, "jax") == (
      [4, 8, 12], ["8"])


@pytest.mark.parametrize("specs,max_rewinds,message", [
    # Budget exhausted: two NaNs, one rewind allowed.
    ([dict(point="train.nonfinite", at=(6, 8), count=2)], 1,
     "rewind budget exhausted"),
    # A NaN before the first checkpoint: nothing to rewind to.
    ([dict(point="train.nonfinite", at=(1,), count=1)], 2,
     "no verified checkpoint"),
    # Back-to-back NaNs: the second lands on the first observation after
    # the rewind and must re-trigger (the latch is re-armed).
    ([dict(point="train.nonfinite", at=(6, 7), count=2)], 1,
     "rewind budget exhausted"),
])
def test_unrecoverable_divergence_escalates(tmp_path, specs, max_rewinds,
                                            message):
  results = _train_both(tmp_path, specs, max_rewinds=max_rewinds)
  assert results["port"] == results["jax"]
  status, text = results["port"]
  assert status == "error" and message in text and "graftguard" in text
  # The escalation dumped its own bundle beside the incident's.
  assert any("rewind-escalation" in path
             for path in flightrec.find_bundles(str(tmp_path / "port")))


def test_auto_resume_with_a_torn_newest_step_falls_back(tmp_path):
  for steps in (8, 12):
    if steps == 12:
      for which, lib in (("port", checkpoints), ("jax", jax_checkpoints)):
        lib._corrupt_step_for_faultlab(
            os.path.join(str(tmp_path / which),
                         checkpoints.CHECKPOINT_DIRNAME), 8, "torn")
    results = _train_both(tmp_path, [dict(point="serve.dispatch", at=(0,))],
                          steps=steps, log_every=4)
    assert results["port"][0] == results["jax"][0] == "ok"
  assert _on_disk(tmp_path, "port") == _on_disk(tmp_path, "jax") == (
      [4, 8, 12], ["8"])


# -- a rewound run equals a clean resume ------------------------------------------

def _final_state(model_dir, step):
  return checkpoints.CheckpointManager(
      os.path.join(model_dir, checkpoints.CHECKPOINT_DIRNAME)).restore(step)


def _assert_bit_identical(a, b):
  assert a.step == b.step
  flat = lambda s: train_step.map_tensors(  # noqa: E731
      lambda x: x.numpy(), (s.params, s.ema_params, s.opt_state,
                            s.mutable_state))
  np.testing.assert_equal(flat(a), flat(b))


def _copy_step(src_dir, dst_dir, step):
  src = os.path.join(src_dir, checkpoints.CHECKPOINT_DIRNAME)
  dst = os.path.join(dst_dir, checkpoints.CHECKPOINT_DIRNAME)
  shutil.copytree(os.path.join(src, str(step)), os.path.join(dst, str(step)))
  os.makedirs(os.path.join(dst, checkpoints.MANIFEST_DIRNAME))
  shutil.copy2(os.path.join(src, checkpoints.MANIFEST_DIRNAME,
                            f"{step}.json"),
               os.path.join(dst, checkpoints.MANIFEST_DIRNAME))


def _rewound_and_resumed(tmp_path, run, fault_at):
  """Final states of a run rewound by a NaN at log arrival `fault_at`
  and of a clean resume from a copy of its rewind target."""
  plan = faultlab.FaultPlan([faultlab.FaultSpec(
      point=faultlab.TRAIN_NONFINITE, at=(fault_at,), count=1)])
  rewound = str(tmp_path / "rewound")
  with plan.activated():
    run(rewound)
  (record,) = runlog.load_records(os.path.join(rewound, runlog.RUNS_FILENAME))
  (target,) = record["extra"]["graftguard"]["rewind_steps"]
  resumed = str(tmp_path / "resumed")
  _copy_step(rewound, resumed, target)
  run(resumed)
  final = record["extra"]["final_step"]
  return target, _final_state(rewound, final), _final_state(resumed, final)


def test_rewound_run_equals_a_clean_resume(tmp_path):
  run = lambda d: train_eval.train_eval_model(  # noqa: E731
      model=mocks.MockT2RModel(), model_dir=d, mode="train",
      max_train_steps=12, checkpoint_every_n_steps=4, log_every_n_steps=2,
      device="cpu", input_generator_train=mocks.MockInputGenerator(
          batch_size=8))
  target, rewound, resumed = _rewound_and_resumed(tmp_path, run, 2)
  assert target == 4
  _assert_bit_identical(rewound, resumed)


def test_flash_slice_rewinds_and_equals_a_clean_resume(tmp_path,
                                                       monkeypatch):
  calls = {"forward": 0, "backward": 0}
  for name, key in (("_flash_forward_plain", "forward"),
                    ("_flash_backward_plain", "backward")):
    plain = getattr(attention_ops, name)

    def counted(*args, _plain=plain, _key=key, **kwargs):
      calls[_key] += 1
      return _plain(*args, **kwargs)

    monkeypatch.setattr(attention_ops, name, counted)

  def run(model_dir):
    return train_eval.train_eval_model(
        model=sequence_model.SequenceRegressionModel(
            obs_size=4, action_size=2, sequence_length=32, hidden_size=32,
            num_heads=2, num_blocks=2, attention_backend="flash",
            use_ema=True),
        model_dir=model_dir, mode="train", max_train_steps=10,
        checkpoint_every_n_steps=4, log_every_n_steps=2, device="cpu",
        input_generator_train=input_generators.DefaultRandomInputGenerator(
            batch_size=2, seed=3))

  target, rewound, resumed = _rewound_and_resumed(tmp_path, run, 2)
  assert target == 4
  # Steps 1-6, then 5-10 replayed; then the clean resume's 5-10.
  assert calls == {"forward": 2 * (6 + 6 + 6), "backward": 2 * (6 + 6 + 6)}
  _assert_bit_identical(rewound, resumed)
