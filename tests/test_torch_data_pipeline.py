"""The port's record pipelines against the JAX package's, on the CPU.

`RecordBatchPipeline` and `WeightedRecordPipeline` of both packages,
over the same files of Example records (16x16 JPEGs, a float vector, an
int, a float label) with the same seed, give byte-identical batches:
train mode (shuffled, repeating past the end of an epoch) and eval mode
(one deterministic pass), on the native stager and the Python chain,
with the overlap plane on and off, with a preprocess function, with
host sharding, for multi-dataset zips, and for weighted mixtures
(a zero weight and an empty source included). The port's batches are
CPU tensors made from the parsed numpy.
"""

import itertools

import pytest
import torch

from tensor2robot_tpu.data import parsing as jax_parsing
from tensor2robot_tpu.data import pipeline as jax_pipeline
from tensor2robot_tpu_torch import native
from tensor2robot_tpu_torch.data import parsing, pipeline
from tests import torch_data_fixtures as fx

torch.set_num_threads(1)

BATCH = 8


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
  """Two globs of 4 and 2 shards of 20 records each, and an empty file."""
  directory = tmp_path_factory.mktemp("records")
  big = fx.write_shards(directory, 4, 20, seed=0, prefix="big")
  small = fx.write_shards(directory, 2, 20, seed=1, prefix="small")
  empty = fx.write_records(directory / "empty.tfrecord", [])
  return {"big": big, "small": small, "empty": empty, "dir": directory}


def _parse_fns(features=fx.FEATURES, labels=fx.LABELS):
  jax_f, port_f = fx.spec_pair(features)
  jax_l, port_l = fx.spec_pair(labels)
  return (jax_parsing.create_parse_fn(jax_f, jax_l),
          parsing.create_parse_fn(port_f, port_l))


def _take_all(pipe, n):
  stream = iter(pipe)
  batches = list(itertools.islice(stream, n))
  if hasattr(stream, "close"):  # the overlapped loader's threads
    stream.close()
  return batches


def _assert_streams_equal(want, got, count):
  assert len(want) == len(got) == count
  for i, (a, b) in enumerate(zip(want, got)):
    fx.assert_same_batch(a, b, f"batch {i}")


def _jax_double(features, labels, mode):
  features["action/action"] = features["action/action"] * 2
  return features, labels


def _port_double(features, labels, mode):
  features["action/action"] = features["action/action"] * 2
  return features, labels


@pytest.mark.parametrize("overlap", [True, False])
@pytest.mark.parametrize("stager", [True, False])
@pytest.mark.parametrize("mode", ["train", "eval"])
def test_record_pipeline_matches_jax(shards, mode, stager, overlap):
  jax_parse, port_parse = _parse_fns()
  # Train: 14 batches cross the end of the 10-batch epoch.
  count = 14 if mode == "train" else 10
  kwargs = dict(batch_size=BATCH, mode=mode, seed=5, shuffle_buffer_size=16,
                use_native_stager=stager, overlap=overlap)
  want = _take_all(jax_pipeline.RecordBatchPipeline(
      shards["big"], jax_parse, **kwargs), count + 1)
  before = native.counters.stager_batches
  got = _take_all(pipeline.RecordBatchPipeline(
      shards["big"], port_parse, **kwargs), count + 1)
  if mode == "eval":
    assert len(want) == count  # one pass, then the stream ends
  else:
    want, got = want[:count], got[:count]
  _assert_streams_equal(want, got, count)
  assert isinstance(got[0]["features"]["state/image"], torch.Tensor)
  staged = native.counters.stager_batches - before
  assert (staged >= count) if stager else staged == 0


@pytest.mark.parametrize("fused", [True, False])
def test_preprocess_fn_applied_as_in_jax(shards, fused):
  jax_parse, port_parse = _parse_fns()
  kwargs = dict(batch_size=BATCH, mode="train", seed=2, fused_preprocess=fused)
  want = _take_all(jax_pipeline.RecordBatchPipeline(
      shards["big"], jax_parse, preprocess_fn=_jax_double, **kwargs), 4)
  got = _take_all(pipeline.RecordBatchPipeline(
      shards["big"], port_parse, preprocess_fn=_port_double, **kwargs), 4)
  _assert_streams_equal(want, got, 4)


@pytest.mark.parametrize("mode", ["train", "eval"])
@pytest.mark.parametrize("process_index", [0, 1])
def test_host_sharding_matches_jax(shards, mode, process_index):
  jax_parse, port_parse = _parse_fns()
  kwargs = dict(batch_size=BATCH, mode=mode, seed=3, process_index=process_index,
                process_count=2)
  assert pipeline.resolve_file_patterns(shards["big"], process_index, 2) == \
      jax_pipeline.resolve_file_patterns(shards["big"], process_index, 2)
  want = _take_all(jax_pipeline.RecordBatchPipeline(
      shards["big"], jax_parse, **kwargs), 6)
  got = _take_all(pipeline.RecordBatchPipeline(
      shards["big"], port_parse, **kwargs), 6)
  _assert_streams_equal(want, got, 5 if mode == "eval" else 6)


@pytest.mark.parametrize("mode", ["train", "eval"])
def test_multi_dataset_zip_matches_jax(shards, mode):
  features = {k: dict(v, dataset_key="obs") for k, v in fx.FEATURES.items()}
  labels = {k: dict(v, dataset_key="outcome") for k, v in fx.LABELS.items()}
  jax_parse, port_parse = _parse_fns(features, labels)
  patterns = {"obs": shards["big"], "outcome": shards["small"]}
  kwargs = dict(batch_size=BATCH, mode=mode, seed=4)
  want = _take_all(jax_pipeline.RecordBatchPipeline(
      patterns, jax_parse, **kwargs), 12)
  got = _take_all(pipeline.RecordBatchPipeline(
      patterns, port_parse, **kwargs), 12)
  # Eval: the zip ends with its shorter stream (40 records).
  _assert_streams_equal(want, got, 5 if mode == "eval" else 12)


@pytest.mark.parametrize("weights, groups", [
    ([0.7, 0.3], ("big", "small")),
    ([0.0, 1.0], ("big", "small")),
    ([0.5, 0.5], ("small", "empty")),
], ids=["mixed", "zero_weight", "empty_source"])
@pytest.mark.parametrize("mode", ["train", "eval"])
def test_weighted_pipeline_matches_jax(shards, mode, weights, groups):
  jax_parse, port_parse = _parse_fns()
  patterns = [shards[g] for g in groups]
  kwargs = dict(batch_size=BATCH, mode=mode, seed=6, shuffle_buffer_size=8)
  want = _take_all(jax_pipeline.WeightedRecordPipeline(
      patterns, weights, jax_parse, **kwargs), 16)
  got = _take_all(pipeline.WeightedRecordPipeline(
      patterns, weights, port_parse, **kwargs), 16)
  assert len(want) == len(got) > 0
  _assert_streams_equal(want, got, len(want))
