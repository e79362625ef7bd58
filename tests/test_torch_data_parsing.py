"""The port's `ParseFn` against the JAX package's, on the CPU.

Every spec case of `tests/test_data.py` (`TestCodecAndParsing`,
`TestExtractedAndMultiDatasetTraining`, `TestDuplicateWireNames`,
`TestCompatibleDuplicateNames`), plus the shapes only the native route
takes (fixed-T sequences, image lists and image sequences, a JPEG batch),
parsed by both packages from the same records on both routes: the
native columnar parser (with the native JPEG decoder) and the
per-record Python route. The batches are byte-identical, leaf by leaf,
dtype and shape included; where the JAX package raises, the port raises
the same error. The port's native JPEG output equals PIL's.
"""

import numpy as np
import pytest
import torch

from tensor2robot_tpu.data import codec as jax_codec
from tensor2robot_tpu.data import example_pb2
from tensor2robot_tpu.data import parsing as jax_parsing
from tensor2robot_tpu_torch import native
from tensor2robot_tpu_torch.data import codec, parsing
from tests import torch_data_fixtures as fx

torch.set_num_threads(1)

F32, I64, U8 = np.float32, np.int64, np.uint8


def _seq(context, sequences, leaves):
  return jax_codec.encode_sequence_example(context, sequences,
                                           fx.spec_pair(leaves)[0])


def _case_example_roundtrip():
  leaves = {"pose": dict(shape=(3,), dtype=F32, name="pose"),
            "count": dict(shape=(), dtype=I64, name="count"),
            "image": dict(shape=(6, 8, 3), dtype=U8, name="img/encoded",
                          data_format="png"),
            "target": dict(shape=(2,))}
  image = np.random.RandomState(0).randint(0, 255, (6, 8, 3), np.uint8)
  record = fx.jax_record({"pose": np.array([1., 2., 3.], F32),
                          "count": np.array(5, I64), "image": image,
                          "target": np.array([0.5, -0.5], F32)}, leaves)
  labels = {"target": leaves.pop("target")}
  return leaves, labels, [record, record]


def _case_jpeg_decode():
  leaves = {"image": dict(shape=(16, 16, 3), dtype=U8, data_format="jpeg")}
  rng = np.random.RandomState(1)
  return leaves, None, [fx.jax_record({"image": fx.smooth_image(rng)}, leaves)
                        for _ in range(4)]


def _case_empty_image():
  leaves = {"image": dict(shape=(4, 4, 3), dtype=U8, data_format="jpeg")}
  return leaves, None, [fx.jax_record({"image": b""}, leaves)]


def _case_varlen():
  leaves = {"v": dict(shape=(4,), dtype=F32, varlen_default_value=-1.0)}
  return leaves, None, [
      fx.jax_record({"v": np.array([1., 2.], F32)}, leaves),
      fx.jax_record({"v": np.arange(6, dtype=F32)}, leaves)]


def _case_missing_required():
  leaves = {"a": dict(shape=(1,), name="a"), "b": dict(shape=(1,), name="b")}
  return leaves, None, [jax_codec.encode_example({"a": np.zeros(1, F32)})]


def _case_optional_missing():
  leaves = {"a": dict(shape=(1,), name="a"),
            "opt": dict(shape=(1,), name="opt", is_optional=True)}
  return leaves, None, [jax_codec.encode_example({"a": np.zeros(1, F32)})]


def _case_optional_mixed():
  leaves = {"a": dict(shape=(1,), name="a"),
            "opt": dict(shape=(1,), name="opt", is_optional=True)}
  return leaves, None, [
      fx.jax_record({"a": np.zeros(1, F32), "opt": np.ones(1, F32)}, leaves),
      jax_codec.encode_example({"a": np.zeros(1, F32)})]


def _case_extracted_wire_dtype():
  leaves = {"plane": dict(shape=(3,), dtype=F32, name="plane",
                          data_format="jpeg", is_extracted=True)}
  return leaves, None, [fx.jax_record({"plane": np.array([1, 2, 3], np.int32)},
                                      leaves)]


def _case_extracted_bfloat16():
  leaves = {"plane": dict(shape=(2, 2), dtype="bfloat16", name="plane",
                          data_format="jpeg", is_extracted=True)}
  values = np.array([[0.5, 1.5], [-2.0, 4.0]], F32)
  return leaves, None, [fx.jax_record({"plane": values}, leaves)] * 2


def _case_bfloat16_spec():
  leaves = {"x": dict(shape=(2,), dtype="bfloat16")}
  return leaves, None, [
      jax_codec.encode_example({"x": np.array([1.5, 2.5], F32)}),
      jax_codec.encode_example({"x": np.array([1 / 3, -7.1], F32)})]


def _case_sequence_example():
  leaves = {"obs": dict(shape=(None, 2), dtype=F32, name="obs",
                        is_sequence=True),
            "task": dict(shape=(), dtype=I64, name="task")}
  records = [_seq({"task": np.array(1, I64)},
                  {"obs": np.arange(n * 2, dtype=F32).reshape(n, 2)}, leaves)
             for n in (2, 4)]
  return leaves, None, records


def _case_fixed_t_sequence():
  leaves = {"obs": dict(shape=(3, 2), dtype=F32, name="obs",
                        is_sequence=True),
            "task": dict(shape=(), dtype=I64, name="task")}
  records = [_seq({"task": np.array(n, I64)},
                  {"obs": np.arange(n * 2, dtype=F32).reshape(n, 2)}, leaves)
             for n in (2, 3, 5)]
  return leaves, None, records


def _case_image_list_and_sequence():
  leaves = {"views": dict(shape=(2, 8, 8, 3), dtype=U8, name="views",
                          data_format="jpeg"),
            "frames": dict(shape=(3, 8, 8, 3), dtype=U8, name="frames",
                           data_format="jpeg", is_sequence=True)}
  rng = np.random.RandomState(2)
  records = []
  for steps in (3, 2):
    frames = np.stack([fx.smooth_image(rng, (8, 8, 3)) for _ in range(steps)])
    message = example_pb2.SequenceExample.FromString(
        _seq({}, {"frames": frames}, leaves))
    # A context image list: one bytes value per view.
    message.context.feature["views"].bytes_list.value.extend(
        jax_codec.encode_image(fx.smooth_image(rng, (8, 8, 3)))
        for _ in range(2))
    records.append(message.SerializeToString())
  return leaves, None, records


def _case_multi_dataset():
  leaves = {"a": dict(shape=(1,), name="a", dataset_key="d1"),
            "b": dict(shape=(1,), name="b", dataset_key="d2")}
  return leaves, None, {
      "d1": [jax_codec.encode_example({"a": np.array([1.0], F32)})],
      "d2": [jax_codec.encode_example({"b": np.array([2.0], F32)})]}


def _case_spec_name_as_wire_key():
  leaves = {"nested/deep": dict(shape=(1,), name="custom_name")}
  return leaves, None, [fx.jax_record({"nested/deep": np.ones(1, F32)},
                                      leaves)]


def _case_extracted_raw_bytes():
  raw = np.arange(4 * 4 * 3, dtype=U8).reshape(4, 4, 3)
  leaves = {"image": dict(shape=(4, 4, 3), dtype=U8, name="image",
                          data_format="png", is_extracted=True)}
  return leaves, None, [jax_codec.encode_example({"image": raw.tobytes()}),
                        jax_codec.encode_example({"image": raw[::-1].tobytes()})]


def _case_colliding_names():
  leaves = {"a": dict(shape=(1,), name="same"),
            "b": dict(shape=(2,), name="same")}
  return leaves, None, []


def _case_compatible_duplicates():
  leaves = {"condition/features/x": dict(shape=(3,), name="x"),
            "inference/features/x": dict(shape=(3,), name="x")}
  return leaves, None, [
      jax_codec.encode_example({"x": np.array([1., 2., 3.], F32)})]


CASES = {name[len("_case_"):]: fn for name, fn in sorted(globals().items())
         if name.startswith("_case_")}


def _parse(module, leaves, label_leaves, records, route):
  index = 0 if module is jax_parsing else 1
  features = fx.spec_pair(leaves)[index]
  labels = fx.spec_pair(label_leaves)[index] if label_leaves else None
  try:
    parse_fn = module.create_parse_fn(features, labels)
    if route == "python":
      parse_fn._native_parsers = {k: None for k in parse_fn._native_parsers}
    return parse_fn, parse_fn.parse_batch(records), None
  except ValueError as e:
    return None, None, e


@pytest.mark.parametrize("route", ["native", "python"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_parse_fn_matches_jax(case, route):
  leaves, label_leaves, records = CASES[case]()
  _, want, want_error = _parse(jax_parsing, leaves, label_leaves, records,
                               route)
  before = native.counters.as_dict()
  parse_fn, got, got_error = _parse(parsing, leaves, label_leaves, records,
                                    route)
  if want_error is not None:
    assert got_error is not None and str(got_error) == str(want_error)
    return
  assert got_error is None, got_error
  fx.assert_same_batch(want, got, case)
  native_parsers = [p for p in parse_fn._native_parsers.values()
                    if p is not None]
  parsed = native.counters.parser_batches - before["parser_batches"]
  # The native route parsed each dataset's batch once; the Python route
  # never called the native parser.
  assert parsed == (len(native_parsers) if route == "native" else 0)


def test_the_native_route_covers_the_critic_records():
  leaves, _, records = _case_jpeg_decode()
  parse_fn = parsing.create_parse_fn(fx.spec_pair(leaves)[1])
  assert native.has_jpeg()
  before = native.counters.as_dict()
  out = parse_fn.parse_batch(records)
  after = native.counters.as_dict()
  assert after["parser_batches"] - before["parser_batches"] == 1
  assert after["jpeg_images"] - before["jpeg_images"] == len(records)
  assert out["features/image"].shape == (4, 16, 16, 3)


@pytest.mark.parametrize("channels", [3, 1])
def test_native_jpeg_equals_pil(channels):
  rng = np.random.RandomState(3)
  shape = (24, 20, channels)
  images = [fx.smooth_image(rng, shape) if channels == 3
            else fx.smooth_image(rng, (24, 20, 3))[..., :1]
            for _ in range(5)]
  datas = [codec.encode_image(image, "jpeg") for image in images]
  before = codec.decode_image.images
  want = codec.decode_image_batch(datas, channels=channels)
  assert codec.decode_image.images - before == len(datas)
  out = np.zeros((5,) + shape, np.uint8)
  got = native.decode_jpeg_batch(datas, *shape, out=out)
  assert got is out
  np.testing.assert_array_equal(got, want)
  # A payload that is not a JPEG of that shape: None, for the PIL path.
  assert native.decode_jpeg_batch(datas[:2] + [b"not a jpeg"], *shape) is None
  assert native.decode_jpeg_batch(datas, 8, 8, channels) is None
