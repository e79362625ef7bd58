"""A warm-started run of the port against the JAX package's, on the CPU.

Both `train_eval_model`s warm-start the small critic (GraspingCNN at 32,
f32, EMA 0.9999) from the same checkpoint: the JAX package's, and its
bridge in the port's format. The port's fresh init is the JAX fresh init
carried across by `bridge.py` (torch cannot draw JAX's init). At step 0
and after one step on the same batch, `params`, `ema_params` and the
optimizer state (the momentum trace and the schedule count) agree: f32,
1e-6 absolute (1% of the learning rate). The EMA at step 0 is the fresh
init, not the warm-started weights, in both packages; with a filter, the
filtered leaves stay fresh.
"""

import jax
import numpy as np
import pytest
import torch

from tensor2robot_tpu import checkpoints as jax_checkpoints
from tensor2robot_tpu import specs as jax_specs
from tensor2robot_tpu import train_eval as jax_train_eval
from tensor2robot_tpu.data import input_generators as jax_input_generators
from tensor2robot_tpu.parallel import train_step as jax_train_step
from tensor2robot_tpu.research.qtopt import models as jax_models
from tensor2robot_tpu_torch import bridge
from tensor2robot_tpu_torch import checkpoints
from tensor2robot_tpu_torch import train_eval
from tensor2robot_tpu_torch.data import input_generators
from tensor2robot_tpu_torch.research.qtopt import flagship

# The port's tests run in the same worker processes as the JAX suite;
# one torch thread keeps torch from starting its OpenMP and MKL thread
# pools beside XLA's CPU threads.
torch.set_num_threads(1)

PARAM_ATOL = 1e-6
SEED = 5


def _jax_model(**kwargs):
  return jax_models.QTOptModel(device_type="cpu", image_size=32,
                               network="small", action_size=4,
                               use_bfloat16=False, use_ema=True, **kwargs)


def _features(model):
  return dict(jax_specs.make_random_numpy(
      model.get_feature_specification("train"), batch_size=2, seed=0))


def _abstract(model):
  return jax.eval_shape(
      lambda: jax_train_step.create_train_state(
          model, jax.random.PRNGKey(SEED), _features(model))[0])


@pytest.fixture(scope="module")
def source(tmp_path_factory):
  """A critic of the same widths from another seed, saved as step 7 by
  the JAX package and, bridged, by the port; and the JAX fresh init of
  seed `SEED` as the port's flat parameters."""
  root = tmp_path_factory.mktemp("warm_source")
  model = _jax_model()
  state = jax_train_step.create_train_state(model, jax.random.PRNGKey(1),
                                            _features(model))[0]
  manager = jax_checkpoints.CheckpointManager(str(root / "jax"),
                                              async_checkpointing=False)
  manager.save(7, state)
  manager.wait_until_finished()
  manager.close()
  checkpoints.CheckpointManager(str(root / "port"),
                                async_checkpointing=False).save(
                                    7, bridge.train_state_from_jax(state))
  fresh = jax_train_step.create_train_state(
      model, jax.random.PRNGKey(SEED), _features(model))[0]
  # The JAX package's warm start reads the item directory in the step.
  jax_dir = next(str(p) for p in (root / "jax" / "7").iterdir()
                 if p.is_dir())
  return {"jax": jax_dir, "port": str(root / "port" / "7"),
          "source": bridge.state_dict_from_flax(
              bridge._numpy_tree(jax.device_get(state.params))),
          "fresh": bridge.state_dict_from_flax(
              bridge._numpy_tree(jax.device_get(fresh.params)))}


def _jax_run(model_dir, steps, init_checkpoint, jax_filter):
  model = _jax_model(init_checkpoint=init_checkpoint,
                     init_checkpoint_filter=jax_filter)
  jax_train_eval.train_eval_model(
      model=model, model_dir=str(model_dir), mode="train",
      max_train_steps=steps, checkpoint_every_n_steps=1, seed=SEED,
      input_generator_train=jax_input_generators.DefaultRandomInputGenerator(
          batch_size=2, seed=3),
      mesh_shape=(1, 1, 1), step_stats_every_n_steps=0,
      executable_cache_dir=None)
  manager = jax_checkpoints.CheckpointManager(
      str(model_dir / "checkpoints"))
  try:
    restored = manager.restore(steps, abstract_state=_abstract(model))
  finally:
    manager.close()
  return bridge.train_state_from_jax(restored)


def _port_run(model_dir, steps, init_checkpoint, port_filter, fresh,
              monkeypatch):
  model = flagship.make_flagship_model(
      "cpu", init_checkpoint=init_checkpoint,
      init_checkpoint_filter=port_filter)
  # The fresh init is the JAX package's: the port cannot draw threefry.
  monkeypatch.setattr(model, "init_params",
                      lambda generator: {k: v.clone()
                                         for k, v in fresh.items()})
  train_eval.train_eval_model(
      model=model, model_dir=str(model_dir), mode="train",
      max_train_steps=steps, checkpoint_every_n_steps=1, device="cpu",
      seed=SEED,
      input_generator_train=input_generators.DefaultRandomInputGenerator(
          batch_size=2, seed=3))
  return checkpoints.CheckpointManager(
      str(model_dir / "checkpoints")).restore(steps)


def _assert_close(got, want):
  assert set(got) == set(want)
  for name, value in want.items():
    np.testing.assert_allclose(got[name].numpy(), value.numpy(),
                               atol=PARAM_ATOL, rtol=0, err_msg=name)


@pytest.mark.parametrize("filtered", [False, True])
@pytest.mark.parametrize("steps", [0, 1])
def test_warm_start_matches_jax(source, tmp_path, monkeypatch, steps,
                                filtered):
  jax_filter = (lambda path: "fc_" not in path) if filtered else None
  port_filter = (lambda name: "fc_" not in name) if filtered else None
  want = _jax_run(tmp_path / "jax", steps, source["jax"], jax_filter)
  got = _port_run(tmp_path / "port", steps, source["port"], port_filter,
                  source["fresh"], monkeypatch)
  assert got.step == want.step == steps
  _assert_close(got.params, want.params)
  _assert_close(got.ema_params, want.ema_params)
  trace, schedule = got.opt_state
  want_trace, want_schedule = want.opt_state
  _assert_close(trace["trace"], want_trace["trace"])
  assert schedule == want_schedule == {"count": steps}
  if steps == 0:
    # The EMA is the fresh init; the parameters the warm start's.
    for name, value in got.params.items():
      fresh_leaf = filtered and name.startswith("fc_")
      want_leaf = (source["fresh"] if fresh_leaf else source["source"])[name]
      assert torch.equal(value, want_leaf), name
      assert torch.equal(got.ema_params[name], source["fresh"][name]), name
    assert all(not v.any() for v in trace["trace"].values())
