"""The port's random input generator against the JAX package's, on the
CPU: the same specs (from the model's preprocessor) and seed give the
same batches, byte for byte, step after step — float32 batches and, under
the bfloat16 policy, the bf16 bit patterns of the cast features and
labels.
"""

import numpy as np
import pytest
import torch

from tensor2robot_tpu.data import input_generators as jax_input_generators
from tensor2robot_tpu.models import sequence_model as jax_sequence_model
from tensor2robot_tpu_torch.data import input_generators
from tensor2robot_tpu_torch.models import sequence_model

# The port's tests run in the same worker processes as the JAX suite;
# one torch thread keeps torch from starting its OpenMP and MKL thread
# pools beside XLA's CPU threads.
torch.set_num_threads(1)

WIDTHS = dict(obs_size=4, action_size=3, hidden_size=16, num_blocks=1,
              num_heads=2, sequence_length=12)


def _bytes(value):
  """The raw bytes of a JAX (numpy or jax array) or port (tensor) leaf."""
  if isinstance(value, torch.Tensor):
    if value.dtype == torch.bfloat16:
      value = value.view(torch.int16)
    return value.numpy().tobytes(), tuple(value.shape)
  value = np.asarray(value)
  return value.tobytes(), value.shape


@pytest.mark.parametrize("use_bfloat16", [False, True])
@pytest.mark.parametrize("seed,batch_size", [(0, 2), (17, 3)])
def test_batches_are_byte_identical_to_jax(seed, batch_size, use_bfloat16):
  jax_model = jax_sequence_model.SequenceRegressionModel(
      device_type="cpu", use_bfloat16=use_bfloat16, **WIDTHS)
  model = sequence_model.SequenceRegressionModel(use_bfloat16=use_bfloat16,
                                                 **WIDTHS)
  jax_gen = jax_input_generators.DefaultRandomInputGenerator(
      batch_size=batch_size, seed=seed)
  gen = input_generators.DefaultRandomInputGenerator(batch_size=batch_size,
                                                     seed=seed)
  jax_gen.set_specification_from_model(jax_model, "train")
  gen.set_specification_from_model(model, "train")
  jax_stream, stream = jax_gen.create_dataset("train"), gen.create_dataset(
      "train")
  for _ in range(3):
    want, got = next(jax_stream), next(stream)
    assert sorted(got) == sorted(want)
    for key in want:
      assert _bytes(got[key]) == _bytes(want[key]), key
    expected = torch.bfloat16 if use_bfloat16 else torch.float32
    assert got["features/observation"].dtype == expected
    assert got["labels/action"].dtype == expected


def test_stream_restarts_from_its_seed_and_labels_differ_from_features():
  model = sequence_model.SequenceRegressionModel(**WIDTHS)
  gen = input_generators.DefaultRandomInputGenerator(batch_size=2, seed=5)
  gen.set_specification_from_model(model, "train")
  first = [next(gen.create_dataset("train")) for _ in range(2)]
  assert torch.equal(first[0]["features/observation"],
                     first[1]["features/observation"])
  stream = gen.create_dataset("train")
  a, b = next(stream), next(stream)
  assert not torch.equal(a["features/observation"], b["features/observation"])
  assert not torch.equal(a["features/observation"][..., :3],
                         a["labels/action"])


def test_specs_must_be_set_first():
  gen = input_generators.DefaultRandomInputGenerator()
  with pytest.raises(ValueError, match="specs not set"):
    next(gen.create_dataset("train"))
  with pytest.raises(ValueError):
    gen("bogus_mode")
