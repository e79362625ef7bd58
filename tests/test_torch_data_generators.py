"""The port's input generators against their JAX twins, on the CPU.

Each record generator (`DefaultRecordInputGenerator`,
`FractionalRecordInputGenerator`, `MultiEvalRecordInputGenerator` with
`multi_eval_name`, `WeightedRecordInputGenerator`) and
`GeneratorInputGenerator` and `DefaultConstantInputGenerator` yield
byte-identical batches to the JAX package's over the same records,
specs and seed (the port's as CPU tensors), with the preprocess function
injected by `set_preprocess_fn` where the twin applies it. The
trainer's `set_overlap_options` reaches the record pipeline.
"""

import itertools
import json

import numpy as np
import pytest
import torch

from tensor2robot_tpu.data import input_generators as jax_generators
from tensor2robot_tpu_torch.data import input_generators
from tests import torch_data_fixtures as fx

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
  directory = tmp_path_factory.mktemp("generators")
  return {"a": fx.write_shards(directory, 4, 12, seed=0, prefix="a"),
          "b": fx.write_shards(directory, 2, 12, seed=1, prefix="b")}


def _pair(make_jax, make_port, mode, count, preprocess=None):
  jax_f, port_f = fx.spec_pair(fx.FEATURES)
  jax_l, port_l = fx.spec_pair(fx.LABELS)
  jax_gen, port_gen = make_jax(), make_port()
  jax_gen.set_specification(jax_f, jax_l)
  port_gen.set_specification(port_f, port_l)
  if preprocess:
    jax_gen.set_preprocess_fn(preprocess[0])
    port_gen.set_preprocess_fn(preprocess[1])
  out = []
  for gen in (jax_gen, port_gen):
    stream = gen(mode)
    out.append(list(itertools.islice(stream, count)))
    if hasattr(stream, "close"):
      stream.close()
  return out


def _assert_equal(want, got, count):
  assert len(want) == len(got) == count
  for i, (a, b) in enumerate(zip(want, got)):
    fx.assert_same_batch(a, b, f"batch {i}")
  for leaf in fx.specs.flatten_spec_structure(got[0]).values():
    assert isinstance(leaf, torch.Tensor)


def _scale(features, labels, mode):
  labels["reward"] = labels["reward"] * 3
  return features, labels


@pytest.mark.parametrize("mode, count", [("train", 9), ("eval", 6)])
def test_record_generator_matches_jax(shards, mode, count):
  kwargs = dict(file_patterns=shards["a"], batch_size=8, seed=11,
                shuffle_buffer_size=10)
  want, got = _pair(
      lambda: jax_generators.DefaultRecordInputGenerator(**kwargs),
      lambda: input_generators.DefaultRecordInputGenerator(**kwargs),
      mode, count + 1, preprocess=(_scale, _scale))
  if mode == "train":
    want, got = want[:count], got[:count]
  _assert_equal(want, got, count)


def test_fractional_generator_matches_jax(shards):
  kwargs = dict(file_patterns=shards["a"], batch_size=8, seed=2,
                file_fraction=0.5)
  want, got = _pair(
      lambda: jax_generators.FractionalRecordInputGenerator(**kwargs),
      lambda: input_generators.FractionalRecordInputGenerator(**kwargs),
      "eval", 5)
  _assert_equal(want, got, 3)  # 2 of 4 files, 24 records


def test_multi_eval_generator_matches_jax(shards, monkeypatch):
  monkeypatch.setenv("T2R_CLUSTER", json.dumps({"multi_eval_name": "held"}))
  assert input_generators.multi_eval_name() == \
      jax_generators.multi_eval_name() == "held"
  kwargs = dict(eval_dataset_map={"held": shards["b"], "eval": shards["a"]},
                batch_size=8, seed=3)
  want, got = _pair(
      lambda: jax_generators.MultiEvalRecordInputGenerator(**kwargs),
      lambda: input_generators.MultiEvalRecordInputGenerator(**kwargs),
      "eval", 4)
  _assert_equal(want, got, 3)
  monkeypatch.setenv("T2R_CLUSTER", json.dumps({"multi_eval_name": "other"}))
  with pytest.raises(ValueError, match="not in eval_dataset_map"):
    input_generators.MultiEvalRecordInputGenerator(**kwargs)


@pytest.mark.parametrize("mode", ["train", "eval"])
def test_weighted_generator_matches_jax(shards, mode):
  kwargs = dict(file_pattern_groups=[shards["a"], shards["b"]],
                weights=[0.25, 0.75], batch_size=8, seed=4,
                shuffle_buffer_size=6)
  want, got = _pair(
      lambda: jax_generators.WeightedRecordInputGenerator(**kwargs),
      lambda: input_generators.WeightedRecordInputGenerator(**kwargs),
      mode, 10)
  _assert_equal(want, got, len(want))


def _examples(mode):
  rng = np.random.RandomState(5)
  for i in range(20):
    values = fx.record_values(rng, i, (4, 4, 3))
    yield ({k: values[k] for k in fx.FEATURES},
           {k: values[k] for k in fx.LABELS})


def test_generator_input_generator_matches_jax():
  want, got = _pair(
      lambda: jax_generators.GeneratorInputGenerator(_examples, batch_size=6),
      lambda: input_generators.GeneratorInputGenerator(_examples,
                                                       batch_size=6),
      "train", 5, preprocess=(_scale, _scale))
  _assert_equal(want, got, 3)  # 20 examples: 3 full batches, then the end


def test_constant_generator_matches_jax():
  want, got = _pair(
      lambda: jax_generators.DefaultConstantInputGenerator(2.0, batch_size=3),
      lambda: input_generators.DefaultConstantInputGenerator(2.0,
                                                             batch_size=3),
      "train", 2)
  _assert_equal(want, got, 2)


def test_overlap_options_reach_the_record_pipeline(shards, monkeypatch):
  from tensor2robot_tpu_torch.data import pipeline

  seen = {}
  original = pipeline.RecordBatchPipeline.__init__

  def spy(self, *args, **kwargs):
    seen.update(kwargs)
    original(self, *args, **kwargs)

  monkeypatch.setattr(pipeline.RecordBatchPipeline, "__init__", spy)
  generator = input_generators.DefaultRecordInputGenerator(
      file_patterns=shards["a"], batch_size=4)
  generator.set_specification(*[fx.spec_pair(s)[1]
                                for s in (fx.FEATURES, fx.LABELS)])
  generator.set_overlap_options(num_parallel_parses=3, overlap_queue_mb=7.5,
                                fused_preprocess=False)
  stream = generator.create_dataset("eval")
  stream.close()
  assert (seen["num_parallel_parses"], seen["overlap_queue_mb"],
          seen["fused_preprocess"], seen["prefetch_size"]) == (3, 7.5,
                                                               False, 2)
