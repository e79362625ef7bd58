"""Shared pieces of the port's data-plane parity tests
(`tests/test_torch_data_*.py`): one spec built in both packages, record
files made from a seed, and a byte-for-byte comparison of the JAX
package's numpy batches with the port's numpy arrays or tensors."""

import numpy as np
import torch

from tensor2robot_tpu import specs as jax_specs
from tensor2robot_tpu.data import codec as jax_codec
from tensor2robot_tpu_torch import specs
from tensor2robot_tpu_torch.data import codec, tfrecord

IMAGE = (16, 16, 3)


def spec_pair(leaves):
  """{key: TensorSpec kwargs} -> (JAX SpecStruct, port SpecStruct)."""
  return (jax_specs.SpecStruct({k: jax_specs.TensorSpec(**kw)
                                for k, kw in leaves.items()}),
          specs.SpecStruct({k: specs.TensorSpec(**kw)
                            for k, kw in leaves.items()}))


# A record schema with every kind of leaf the critic's records carry:
# a JPEG image, a float vector, an int scalar and a float label.
FEATURES = {
    "state/image": dict(shape=IMAGE, dtype=np.uint8, name="state/image",
                        data_format="jpeg"),
    "action/action": dict(shape=(3,), dtype=np.float32,
                          name="action/action"),
    "step": dict(shape=(), dtype=np.int64, name="step"),
}
LABELS = {"reward": dict(shape=(1,), dtype=np.float32, name="reward")}


def smooth_image(rng, shape=IMAGE):
  """A smooth uint8 image (JPEG-friendly), random per call."""
  h, w, c = shape
  y, x = np.mgrid[0:h, 0:w] / max(h, w)
  phase = rng.uniform(0, 2 * np.pi, size=(c,))
  freq = rng.uniform(1, 4, size=(2, c))
  planes = [127.5 + 120 * np.sin(freq[0, i] * 2 * np.pi * x
                                 + freq[1, i] * 2 * np.pi * y + phase[i])
            for i in range(c)]
  return np.clip(np.stack(planes, -1), 0, 255).astype(np.uint8)


def record_values(rng, index, image_shape=IMAGE):
  return {"state/image": smooth_image(rng, image_shape),
          "action/action": rng.uniform(-1, 1, 3).astype(np.float32),
          "step": np.array(index, np.int64),
          "reward": rng.uniform(0, 1, 1).astype(np.float32)}


def write_records(path, values_list, spec_structure=None):
  with tfrecord.RecordWriter(str(path)) as writer:
    for values in values_list:
      writer.write(codec.encode_example(values, spec_structure))
  return str(path)


def write_shards(directory, shards, per_shard, seed=0, prefix="shard"):
  """`shards` files of `per_shard` records each; returns their glob."""
  _, port_spec = spec_pair({**FEATURES, **LABELS})
  rng = np.random.RandomState(seed)
  for s in range(shards):
    write_records(directory / f"{prefix}-{s:02d}.tfrecord",
                  [record_values(rng, s * per_shard + i)
                   for i in range(per_shard)], port_spec)
  return str(directory / f"{prefix}-*.tfrecord")


def jax_record(values, leaves):
  """The JAX codec's record of `values` under spec `leaves`."""
  return jax_codec.encode_example(values, spec_pair(leaves)[0])


def as_numpy(value):
  """The bytes-level numpy view of a port leaf (bf16 as uint16)."""
  if isinstance(value, torch.Tensor):
    if value.dtype == torch.bfloat16:
      return value.view(torch.int16).numpy().view(np.uint16)
    return value.numpy()
  return np.asarray(value)


def jax_numpy(value):
  value = np.asarray(value)
  if value.dtype.name == "bfloat16":
    return value.view(np.uint16)
  return value


def assert_same_batch(want, got, context=""):
  """A JAX batch and a port batch hold the same keys and, leaf by leaf,
  the same dtype, shape and bytes."""
  want = jax_specs.flatten_spec_structure(want)
  got = specs.flatten_spec_structure(got)
  assert sorted(want.keys()) == sorted(got.keys()), context
  for key in want.keys():
    a, b = jax_numpy(want[key]), as_numpy(got[key])
    assert a.dtype == b.dtype, (context, key, a.dtype, b.dtype)
    assert a.shape == b.shape, (context, key, a.shape, b.shape)
    if a.dtype == object:
      assert a.tolist() == b.tolist(), (context, key)
    else:
      assert a.tobytes() == b.tobytes(), (context, key)


def write_critic_records(directory, model, counts=(("train-00", 24),
                                                   ("train-01", 24),
                                                   ("eval-00", 16))):
  """Grasp records for `model` (a port QTOptModel): a smooth JPEG image,
  an action in [-1, 1], a reward of 0 or 1. Returns the train and eval
  globs."""
  spec = specs.SpecStruct({
      **model.preprocessor.get_in_feature_specification("train"),
      **model.preprocessor.get_in_label_specification("train")})
  image = spec["state/image"].shape
  actions = spec["action/action"].shape[0]
  rng = np.random.RandomState(0)
  for name, count in counts:
    write_records(directory / f"{name}.tfrecord", [{
        "state/image": smooth_image(rng, image),
        "action/action": rng.uniform(-1, 1, actions).astype(np.float32),
        "reward": np.float32([rng.randint(2)])} for _ in range(count)], spec)
  return (str(directory / "train-*.tfrecord"),
          str(directory / "eval-*.tfrecord"))
