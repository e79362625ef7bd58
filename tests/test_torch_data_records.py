"""The port's record layer against the JAX package's, on the CPU.

* TFRecord files: the port's writer is read by the JAX package's
  `iter_records` and JAX's writer by the port's, on the native reader
  and the Python one; the two readers agree; a truncated or corrupt file
  raises IOError on both; the Python CRC32C equals the native one.
* The Example wire format without protobuf: the port's encoder output
  parses under `example_pb2` to the message the JAX codec makes
  (Examples and SequenceExamples, every kind of list, packed and not),
  and the port's decoder reads the JAX codec's bytes. The image codec
  (PIL's encode, decode, batch decode and JPEG recompression) gives the
  JAX codec's bytes and arrays.
* The native library: built at first use by g++ into `_build/` under a
  file lock (three processes building at once load one library), named
  by its sources' hash, with and without libjpeg.
"""

import json
import os
import pathlib
import struct
import subprocess
import sys

import numpy as np
import pytest
import torch

from tensor2robot_tpu.data import codec as jax_codec
from tensor2robot_tpu.data import example_pb2
from tensor2robot_tpu.data import tfrecord as jax_tfrecord
from tensor2robot_tpu_torch import native
from tensor2robot_tpu_torch.data import codec, example_wire, tfrecord
from tests import torch_data_fixtures as fx

torch.set_num_threads(1)

REPO_ROOT = pathlib.Path(__file__).resolve().parent.parent
RECORDS = [b"hello", b"", b"x" * 1000, bytes(range(256)) * 9]


def _write_jax(path, records):
  with jax_tfrecord.RecordWriter(str(path)) as writer:
    for record in records:
      writer.write(record)
  return str(path)


@pytest.mark.parametrize("reader", ["native", "python"])
def test_records_cross_read_between_packages(tmp_path, reader):
  read = (tfrecord.iter_records if reader == "native"
          else tfrecord.iter_python_records)
  ours = str(tmp_path / "ours.tfrecord")
  with tfrecord.RecordWriter(ours) as writer:
    for record in RECORDS:
      writer.write(record)
  theirs = _write_jax(tmp_path / "theirs.tfrecord", RECORDS)
  assert pathlib.Path(ours).read_bytes() == pathlib.Path(theirs).read_bytes()
  assert list(jax_tfrecord.iter_records(ours, verify_crc=True)) == RECORDS
  assert list(read(theirs, verify_crc=True)) == RECORDS
  assert tfrecord.count_records(theirs) == len(RECORDS)
  assert native.available()


@pytest.mark.parametrize("cut", [2, 7, 13])
@pytest.mark.parametrize("reader", ["native", "python"])
def test_truncated_and_corrupt_files_raise(tmp_path, reader, cut):
  read = (tfrecord.read_records if reader == "native"
          else lambda p, **kw: list(tfrecord.iter_python_records(p, **kw)))
  path = _write_jax(tmp_path / "data.tfrecord", [b"hello", b"world!"])
  data = pathlib.Path(path).read_bytes()
  pathlib.Path(path).write_bytes(data[:-cut])
  with pytest.raises(IOError):
    read(path)
  corrupt = bytearray(data)
  corrupt[14] ^= 0xFF  # a byte of the first record's body
  pathlib.Path(path).write_bytes(bytes(corrupt))
  assert len(read(path)) == 2  # no CRC check: the bytes are read
  with pytest.raises(IOError):
    read(path, verify_crc=True)
  pathlib.Path(path).write_bytes(struct.pack("<Q", 1 << 40) + data[8:])
  with pytest.raises(IOError):
    read(path)


def test_python_crc32c_equals_native():
  rng = np.random.RandomState(0)
  for n in (0, 1, 7, 8, 9, 64, 1001):
    payload = rng.randint(0, 256, n).astype(np.uint8).tobytes()
    assert tfrecord._mask(tfrecord._crc32c(payload)) == \
        native.masked_crc32c(payload)
  assert tfrecord._crc32c(b"123456789") == 0xE3069283  # the check value


def _values(rng):
  return {"floats": rng.randn(5).astype(np.float32),
          "doubles": rng.randn(3),
          "ints": np.array([0, -1, 2**40, -(2**62), 7], np.int64),
          "flags": np.array([True, False]),
          "text": "héllo",
          "blob": b"\x00\x01\xff",
          "strings": np.array([b"a", b"bc"]),
          "empty": np.zeros((0,), np.float32),
          "image": fx.smooth_image(rng, (8, 8, 3))}


def _leaves():
  return {"image": dict(shape=(8, 8, 3), dtype=np.uint8, name="img",
                        data_format="jpeg"),
          "plane": dict(shape=(2, 2), dtype="bfloat16", name="plane",
                        data_format="png", is_extracted=True)}


def test_example_encoder_matches_the_jax_codec():
  rng = np.random.RandomState(1)
  values = _values(rng)
  values["plane"] = np.array([[1.5, -2.0], [0.25, 8.0]], np.float32)
  jax_spec, port_spec = fx.spec_pair(_leaves())
  want = example_pb2.Example.FromString(
      jax_codec.encode_example(values, jax_spec))
  got = example_pb2.Example.FromString(codec.encode_example(values, port_spec))
  assert got == want
  assert set(got.features.feature) == set(values) - {"image"} | {"img"}
  assert example_wire.encode_example({}) == example_pb2.Example(
  ).SerializeToString() == b""


def test_sequence_example_encoder_matches_the_jax_codec():
  rng = np.random.RandomState(2)
  context = {"task": np.array(3, np.int64), "goal": rng.randn(2)}
  sequences = {"obs": rng.randn(4, 3).astype(np.float32),
               "image": np.stack([fx.smooth_image(rng, (8, 8, 3))
                                  for _ in range(2)]),
               "none": np.zeros((0, 2), np.float32)}
  jax_spec, port_spec = fx.spec_pair(_leaves())
  want = example_pb2.SequenceExample.FromString(
      jax_codec.encode_sequence_example(context, sequences, jax_spec))
  got = example_pb2.SequenceExample.FromString(
      codec.encode_sequence_example(context, sequences, port_spec))
  assert got == want
  assert len(got.feature_lists.feature_list["none"].feature) == 0


def _as_wire(feature):
  kind = feature.WhichOneof("kind")
  if kind is None:
    return example_wire.Feature()
  return example_wire.Feature(kind, getattr(feature, kind).value)


def test_decoder_reads_the_jax_codec_bytes():
  rng = np.random.RandomState(3)
  message = example_pb2.Example.FromString(
      jax_codec.encode_example(_values(rng)))
  message.features.feature["missing"].Clear()
  got = example_wire.decode_example(message.SerializeToString())
  assert got == {k: _as_wire(f) for k, f in message.features.feature.items()}
  assert got["missing"].kind is None
  seq = example_pb2.SequenceExample.FromString(
      jax_codec.encode_sequence_example(
          {"task": np.array(1, np.int64)},
          {"obs": rng.randn(3, 2).astype(np.float32)}))
  context, lists = example_wire.decode_sequence_example(
      seq.SerializeToString())
  assert context == {"task": example_wire.Feature("int64_list", [1])}
  assert lists["obs"] == [_as_wire(f)
                          for f in seq.feature_lists.feature_list["obs"].feature]


def test_decoder_reads_unpacked_lists_merges_and_skips_unknown_fields():
  def field(number, wire_type, payload):
    key = example_wire._varint((number << 3) | wire_type)
    if wire_type == 2:
      return key + example_wire._varint(len(payload)) + payload
    return key + payload

  floats = b"".join(field(1, 5, struct.pack("<f", v)) for v in (1.5, -2.0))
  ints = b"".join(field(1, 0, example_wire._varint(v)) for v in (3, -4))
  feature = (field(2, 2, floats) + field(2, 2, field(1, 2, struct.pack(
      "<f", 4.0))) + field(9, 0, b"\x05"))
  assert example_wire.decode_feature(feature) == example_wire.Feature(
      "float_list", [1.5, -2.0, 4.0])
  # A later member of the oneof replaces the earlier one.
  assert example_wire.decode_feature(feature + field(3, 2, ints)) == \
      example_wire.Feature("int64_list", [3, -4])
  with pytest.raises(ValueError, match="Truncated"):
    example_wire.decode_example(field(1, 2, b"\x0a\x05ab"))


_BUILD = """
import json, pathlib, sys
from tensor2robot_tpu_torch import native
native.BUILD_DIR = pathlib.Path(sys.argv[1])
if sys.argv[2] == "nojpeg":
  native._JPEG_SOURCE = "missing_jpeg_decode.cc"
  native.library_path = lambda: pathlib.Path(sys.argv[1]) / "t2r_native-x.so"
print(json.dumps({"available": native.available(),
                  "jpeg": native.has_jpeg(),
                  "path": str(native.library_path()),
                  "built": bool(native.build_log())}))
"""


def _build_in(directory, variant, count):
  env = dict(os.environ, PYTHONPATH=str(REPO_ROOT))
  procs = [subprocess.Popen([sys.executable, "-c", _BUILD, str(directory),
                             variant], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env,
                            cwd=REPO_ROOT) for _ in range(count)]
  outs = []
  for proc in procs:
    stdout, stderr = proc.communicate(timeout=300)
    assert proc.returncode == 0, stderr
    outs.append(json.loads(stdout.strip().splitlines()[-1]))
  return outs


def test_concurrent_builds_load_one_library(tmp_path):
  outs = _build_in(tmp_path, "jpeg", 3)
  assert all(o["available"] and o["jpeg"] for o in outs)
  assert len({o["path"] for o in outs}) == 1
  assert sum(o["built"] for o in outs) == 1  # one built, two waited
  # No temporary file is left behind.
  path = pathlib.Path(outs[0]["path"])
  assert {p.name for p in tmp_path.iterdir()} == {
      path.name, path.with_suffix(".lock").name}
  assert path.name == native.library_path().name


def test_build_without_libjpeg_serves_reader_parser_and_stager(tmp_path):
  (out,) = _build_in(tmp_path, "nojpeg", 1)
  assert out["available"] and not out["jpeg"]


@pytest.mark.parametrize("max_side", [None, 12])
def test_image_codec_matches_the_jax_codec(max_side):
  rng = np.random.RandomState(4)
  image = fx.smooth_image(rng, (20, 24, 3))
  for fmt in ("jpeg", "png"):
    data = codec.encode_image(image, fmt)
    assert data == jax_codec.encode_image(image, fmt)
    np.testing.assert_array_equal(codec.decode_image(data, channels=3),
                                  jax_codec.decode_image(data, channels=3))
  assert codec.maybe_recompress_jpeg(data, quality=80, max_side=max_side) \
      == jax_codec.maybe_recompress_jpeg(data, quality=80, max_side=max_side)
  gray = codec.decode_image_batch([data, data], channels=1)
  assert gray.shape == (2, 20, 24, 1)
  np.testing.assert_array_equal(
      gray, jax_codec.decode_image_batch([data, data], channels=1))
