"""A finite train stream's exit: the port against the JAX package.

Both trainers run `MockT2RModel` on a stream truncated to a fixed number
of batches, with `max_train_steps` beyond it and a checkpoint cadence
that never fires (the JAX package's
`test_finite_stream_mid_group_batches_are_single_stepped` case and its
neighbours). A finite stream's end is the documented loop exit: each
package trains every batch the stream gave (the batches of an
incomplete last group as single steps), raises `StopIteration`, and
does nothing else — no checkpoint on disk, no `after_checkpoint` call,
no flight-recorder bundle — whether the stream ends mid-group or on a
group boundary, and at either prefetch depth.
"""

from __future__ import annotations

import itertools
import os

import pytest
import torch

from tensor2robot_tpu import train_eval as jax_train_eval
from tensor2robot_tpu.hooks import core as jax_hooks
from tensor2robot_tpu.obs import flightrec as jax_flightrec
from tensor2robot_tpu.utils import config as jax_config
from tensor2robot_tpu.utils import mocks as jax_mocks
from tensor2robot_tpu_torch import checkpoints
from tensor2robot_tpu_torch import train_eval
from tensor2robot_tpu_torch.hooks import core as hooks
from tensor2robot_tpu_torch.obs import flightrec
from tensor2robot_tpu_torch.utils import config
from tensor2robot_tpu_torch.utils import mocks

torch.set_num_threads(1)


def _finite(generator_cls, num_batches):
  class _Finite(generator_cls):
    """The mock generator's train stream truncated to `num_batches`."""

    def create_dataset(self, mode):
      return itertools.islice(super().create_dataset(mode), num_batches)

  return _Finite(batch_size=8)


def _recorder(hooks_module, calls):
  class _Recorder(hooks_module.Hook):

    def after_step(self, ctx, step, metrics):
      calls.append(("step", step))

    def after_checkpoint(self, ctx, step):
      calls.append(("checkpoint", step))

  class _Builder(hooks_module.HookBuilder):

    def create_hooks(self, model, model_dir):
      return [_Recorder()]

  return _Builder()


def _run(which, model_dir, iterations_per_loop, num_batches, prefetch):
  """One package's run: (recorded hook calls, StopIteration message)."""
  calls = []
  kwargs = dict(model_dir=model_dir, mode="train", max_train_steps=20,
                iterations_per_loop=iterations_per_loop,
                device_prefetch_depth=prefetch, log_every_n_steps=100,
                checkpoint_every_n_steps=100)
  if which == "port":
    config.clear_config()
    run = lambda: train_eval.train_eval_model(
        model=mocks.MockT2RModel(), device="cpu",
        input_generator_train=_finite(mocks.MockInputGenerator,
                                      num_batches),
        hook_builders=[_recorder(hooks, calls)], **kwargs)
  else:
    jax_config.clear_config()
    run = lambda: jax_train_eval.train_eval_model(
        model=jax_mocks.MockT2RModel(device_type="cpu"),
        executable_cache_dir=None,
        input_generator_train=_finite(jax_mocks.MockInputGenerator,
                                      num_batches),
        hook_builders=[_recorder(jax_hooks, calls)], **kwargs)
  with pytest.raises(StopIteration) as raised:
    run()
  return calls, str(raised.value)


def _checkpoint_steps(model_dir):
  ckpt_dir = os.path.join(model_dir, checkpoints.CHECKPOINT_DIRNAME)
  if not os.path.isdir(ckpt_dir):
    return []
  return sorted(int(name) for name in os.listdir(ckpt_dir)
                if name.isdigit())


@pytest.mark.parametrize("prefetch", [0, 2])
@pytest.mark.parametrize("iterations_per_loop,num_batches", [
    (4, 6),  # ends mid-group: the last 2 batches train as single steps
    (1, 6),
    (4, 8),  # ends on a group boundary
])
def test_finite_stream_exit_trains_every_batch_and_saves_nothing(
    tmp_path, iterations_per_loop, num_batches, prefetch):
  out = {}
  for which in ("port", "jax"):
    model_dir = str(tmp_path / which)
    calls, message = _run(which, model_dir, iterations_per_loop,
                          num_batches, prefetch)
    bundles = (flightrec if which == "port" else jax_flightrec
               ).find_bundles(model_dir)
    out[which] = (calls, message, _checkpoint_steps(model_dir), bundles)
  assert out["port"] == out["jax"]
  calls, message, saved, bundles = out["port"]
  assert calls == [("step", s) for s in range(1, num_batches + 1)]
  assert message == f"finite train stream exhausted after step {num_batches}"
  assert saved == []
  assert bundles == []
