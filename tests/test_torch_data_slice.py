"""The slice as a whole on the CPU: the QT-Opt critic trained from
TFRecords by the JAX package and by the port.

`train_eval_model` of both packages runs `QTOptModel(network='small')`
(the grasping CNN, 32x32 JPEGs, action 4) in 'train_and_evaluate' from
the same record files through `DefaultRecordInputGenerator`; the first
train batch and the first eval batch each package's generator yields are
byte-identical. One train step on that first batch, from the JAX initial
state carried across by `bridge.py`, is held at the tolerances of
`tests/test_torch_qtopt_train.py` (loss 1e-5 relative; parameters, EMA
and the momentum trace 1e-6 absolute).
"""

import jax
import numpy as np
import torch

from tensor2robot_tpu import train_eval as jax_train_eval
from tensor2robot_tpu.data import input_generators as jax_generators
from tensor2robot_tpu.parallel import train_step as jax_train_step
from tensor2robot_tpu.research.qtopt import models as jax_models
from tensor2robot_tpu_torch import bridge, train_eval
from tensor2robot_tpu_torch.data import input_generators
from tensor2robot_tpu_torch.parallel import train_step
from tensor2robot_tpu_torch.research.qtopt import models
from tests import torch_data_fixtures as fx
from tests.test_torch_qtopt_train import (LOSS_RTOL, PARAM_ATOL,
                                          _assert_close, _rel, _state_dict)

torch.set_num_threads(1)

SMALL = dict(image_size=32, action_size=4, network="small")
RUN = dict(mode="train_and_evaluate", max_train_steps=4, eval_steps=2,
           eval_every_n_steps=2, checkpoint_every_n_steps=2,
           log_every_n_steps=2, seed=0)


def _recording(cls):
  """`cls` whose streams keep every batch they yield in `seen[mode]`."""

  class Recording(cls):

    def create_dataset(self, mode):
      stream = super().create_dataset(mode)
      seen = self.seen.setdefault(mode, [])

      def tee():
        try:
          for batch in stream:
            seen.append(batch)
            yield batch
        finally:
          stream.close()
      return tee()

  Recording.seen = None
  return Recording


def _generators(module, train_glob, eval_glob):
  cls = _recording(module.DefaultRecordInputGenerator)
  train = cls(file_patterns=train_glob, batch_size=8, seed=1)
  evaluation = cls(file_patterns=eval_glob, batch_size=8, seed=1)
  train.seen, evaluation.seen = {}, {}
  return train, evaluation


def test_critic_trains_from_records_in_both_packages(tmp_path):
  model = models.QTOptModel(**SMALL)
  jax_model = jax_models.QTOptModel(device_type="cpu", **SMALL)
  train_glob, eval_glob = fx.write_critic_records(tmp_path, model)
  jax_train, jax_eval = _generators(jax_generators, train_glob, eval_glob)
  want = jax_train_eval.train_eval_model(
      model=jax_model, model_dir=str(tmp_path / "jax"),
      input_generator_train=jax_train, input_generator_eval=jax_eval,
      step_stats_every_n_steps=0, executable_cache_dir=None, **RUN)
  train, evaluation = _generators(input_generators, train_glob, eval_glob)
  got = train_eval.train_eval_model(
      model=model, model_dir=str(tmp_path / "port"), device="cpu",
      input_generator_train=train, input_generator_eval=evaluation, **RUN)
  assert set(got) == set(want)
  assert all(np.isfinite(v) for v in got.values())
  fx.assert_same_batch(jax_train.seen["train"][0], train.seen["train"][0])
  fx.assert_same_batch(jax_eval.seen["eval"][0], evaluation.seen["eval"][0])
  # Two evals of the two-batch eval file: each read it whole.
  assert len(evaluation.seen["eval"]) == 4

  # One step on the first batch from the same weights.
  jax_batch = jax_train.seen["train"][0]
  features = dict(jax_batch["features"])
  labels = dict(jax_batch["labels"])
  initial = jax_train_step.create_train_state(
      jax_model, jax.random.PRNGKey(0), features)[0]
  jax_state, jax_metrics = jax_train_step.make_train_step(
      jax_model, donate=False)(initial, features, labels)
  batch = train.seen["train"][0]
  state, metrics = train_step.make_train_step(model)(
      bridge.train_state_from_jax(initial), batch["features"],
      batch["labels"])
  for key in metrics:
    assert _rel(float(metrics[key]), float(jax_metrics[key])) <= LOSS_RTOL
  _assert_close(state.params, _state_dict(jax_state.params), PARAM_ATOL)
  _assert_close(state.ema_params, _state_dict(jax_state.ema_params),
                PARAM_ATOL)
  _assert_close(state.opt_state[0]["trace"],
                _state_dict(jax_state.opt_state[0].trace), PARAM_ATOL)
