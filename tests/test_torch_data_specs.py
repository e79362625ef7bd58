"""The spec helpers the port's data plane added, against the JAX
package's: `assert_equal`, `assert_required`, `copy_specs`,
`filter_by_dataset`, `dataset_keys` and `make_constant_numpy` give the
same answers, and raise where the JAX package raises."""

import numpy as np
import pytest
import torch

from tensor2robot_tpu import specs as jax_specs
from tensor2robot_tpu_torch import specs
from tests import torch_data_fixtures as fx

torch.set_num_threads(1)

LEAVES = {"a/x": dict(shape=(2,), dtype=np.float32, dataset_key="d1"),
          "a/y": dict(shape=(3, 1), dtype=np.int64, dataset_key="d2"),
          "opt": dict(shape=(4,), is_optional=True, dataset_key="d1")}


def _as_dicts(structure):
  return {k: (v.shape, str(v.dtype), v.is_optional, v.dataset_key)
          for k, v in structure.items()}


def _outcome(fn):
  try:
    fn()
    return None
  except ValueError as e:
    return str(e)


@pytest.mark.parametrize("other, ignore_batch", [
    (LEAVES, False),
    ({**LEAVES, "a/x": dict(shape=(5,))}, False),
    ({k: v for k, v in LEAVES.items() if k != "opt"}, False),
    ({k: dict(v, shape=(7,) + v["shape"][1:]) for k, v in LEAVES.items()
      if v["shape"]}, True),
])
def test_assert_equal_and_required_match_jax(other, ignore_batch):
  jax_a, port_a = fx.spec_pair(LEAVES)
  jax_b, port_b = fx.spec_pair(other)
  for check in ("assert_equal", "assert_required"):
    want = _outcome(lambda: getattr(jax_specs, check)(
        jax_a, jax_b, ignore_batch=ignore_batch))
    got = _outcome(lambda: getattr(specs, check)(
        port_a, port_b, ignore_batch=ignore_batch))
    assert got == want, check


@pytest.mark.parametrize("prefix, batch_size", [("", None), ("p", 4),
                                                ("q/r", 0)])
def test_copy_filter_and_keys_match_jax(prefix, batch_size):
  jax_a, port_a = fx.spec_pair(LEAVES)
  assert _as_dicts(specs.copy_specs(port_a, prefix, batch_size)) == \
      _as_dicts(jax_specs.copy_specs(jax_a, prefix, batch_size))
  assert specs.dataset_keys(port_a) == jax_specs.dataset_keys(jax_a)
  for key in ("d1", "d2", "none"):
    assert _as_dicts(specs.filter_by_dataset(port_a, key)) == \
        _as_dicts(jax_specs.filter_by_dataset(jax_a, key))


def test_make_constant_numpy_matches_jax():
  jax_a, port_a = fx.spec_pair(LEAVES)
  want = jax_specs.make_constant_numpy(jax_a, 3.5, batch_size=2,
                                       sequence_length=5)
  got = specs.make_constant_numpy(port_a, 3.5, batch_size=2,
                                  sequence_length=5)
  fx.assert_same_batch(want, got)
  with pytest.raises(ValueError, match="bfloat16"):
    specs.make_constant_numpy(
        specs.SpecStruct({"b": specs.TensorSpec((2,), "bfloat16")}), 1.0)
