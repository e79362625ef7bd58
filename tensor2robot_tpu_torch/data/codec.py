"""Encoding numpy data to tf.Example records, driven by specs.

The port's copy of `tensor2robot_tpu.data.codec`, on the pure-Python
wire format of `example_wire` (no protobuf): the writer side of the
parser, used by the replay writer and by tests and smoke runs to make
records. Images are JPEG/PNG/BMP/GIF bytes made and read by PIL, which
is imported where an image is encoded or decoded.
`decode_image.images` counts the images PIL decoded.
"""

from __future__ import annotations

import io
import threading
from typing import Any, Mapping, Optional

import numpy as np
import torch

from tensor2robot_tpu_torch import specs as specs_lib
from tensor2robot_tpu_torch.data import example_wire

__all__ = ["encode_image", "decode_image", "decode_image_batch",
           "maybe_recompress_jpeg", "set_feature", "encode_example",
           "encode_sequence_example"]

_count_lock = threading.Lock()
_PIL_FORMATS = {"jpg": "JPEG", "jpeg": "JPEG", "png": "PNG", "bmp": "BMP",
                "gif": "GIF"}


def encode_image(array: np.ndarray, data_format: str = "jpeg") -> bytes:
  """Encodes an HWC uint8 array to compressed image bytes via PIL, at
  PIL's default settings (JPEG quality 75)."""
  from PIL import Image

  array = np.asarray(array)
  if array.ndim == 3 and array.shape[-1] == 1:
    array = array[..., 0]
  buf = io.BytesIO()
  Image.fromarray(array).save(buf, format=_PIL_FORMATS[data_format.lower()])
  return buf.getvalue()


def decode_image(data: bytes, channels: Optional[int] = None) -> np.ndarray:
  """Decodes image bytes to an HWC uint8 array."""
  from PIL import Image

  img = Image.open(io.BytesIO(data))
  if channels == 3 and img.mode != "RGB":
    img = img.convert("RGB")
  elif channels == 1 and img.mode != "L":
    img = img.convert("L")
  array = np.asarray(img)
  with _count_lock:  # parse workers decode in parallel
    decode_image.images += 1
  if array.ndim == 2:
    array = array[..., None]
  return array


decode_image.images = 0


def decode_image_batch(datas, channels: Optional[int] = None) -> np.ndarray:
  """Decodes a list of image byte strings to one [N, H, W, C] array."""
  return np.stack([decode_image(d, channels=channels) for d in datas])


def maybe_recompress_jpeg(data: bytes, quality: int = 95,
                          max_side: Optional[int] = None) -> bytes:
  """Re-encodes image bytes as JPEG, optionally capping the resolution:
  shrinks replay and log storage."""
  from PIL import Image

  img = Image.open(io.BytesIO(data))
  if img.mode != "RGB":
    img = img.convert("RGB")
  if max_side is not None and max(img.size) > max_side:
    scale = max_side / max(img.size)
    img = img.resize((int(img.width * scale), int(img.height * scale)))
  buf = io.BytesIO()
  img.save(buf, format="JPEG", quality=quality)
  return buf.getvalue()


def _wire_dtype(spec: specs_lib.TensorSpec) -> np.dtype:
  """The dtype an extracted plane rides the wire in: the spec's, except
  bfloat16, which rides as float32 (the parser's dtype policy)."""
  return (np.dtype(np.float32) if spec.dtype is torch.bfloat16
          else np.dtype(spec.dtype))


def set_feature(feature: example_wire.Feature, value: Any,
                spec: Optional[specs_lib.TensorSpec] = None) -> None:
  """Fills one Feature from a numpy value according to its spec."""
  if spec is not None and spec.is_extracted:
    # Pre-extracted planes ship as raw bytes, never re-encoded, whatever
    # data_format says about their origin.
    if isinstance(value, bytes):
      feature.add_bytes([value])
      return
    wire_dtype = _wire_dtype(spec)
    if wire_dtype.kind in "SUO" or wire_dtype.itemsize == 0:
      # String planes: one bytes value per item, payloads untouched.
      if isinstance(value, np.ndarray):
        items = value.reshape(-1).tolist()
      elif isinstance(value, (list, tuple)):
        items = value
      else:
        items = [value]
      feature.add_bytes([item.encode("utf-8") if isinstance(item, str)
                         else bytes(item) for item in items])
      return
    feature.add_bytes([np.ascontiguousarray(
        np.asarray(value, dtype=wire_dtype)).tobytes()])
    return
  if spec is not None and spec.is_image:
    feature.add_bytes([value if isinstance(value, bytes) else
                       encode_image(np.asarray(value), spec.data_format)])
    return
  if isinstance(value, bytes):
    feature.add_bytes([value])
    return
  if isinstance(value, str):
    feature.add_bytes([value.encode("utf-8")])
    return
  array = np.asarray(value)
  if array.dtype.kind in "SU":
    feature.add_bytes([item if isinstance(item, bytes)
                       else str(item).encode("utf-8")
                       for item in array.ravel()])
  elif array.dtype.kind in "iub":
    feature.add_ints(array.ravel())
  else:
    feature.add_floats(array.ravel())


def _flat_specs(spec_structure) -> Optional[specs_lib.SpecStruct]:
  return (None if spec_structure is None
          else specs_lib.flatten_spec_structure(spec_structure))


def _features(values: Mapping[str, Any], flat_specs, make_feature):
  """{wire name: filled value} for a flat dict of values. Feature keys
  use `spec.name` when set, else the flat path key."""
  out = {}
  for key, value in specs_lib.flatten_spec_structure(dict(values)).items():
    spec = flat_specs.get(key) if flat_specs is not None \
        and key in flat_specs else None
    name = spec.name if spec is not None and spec.name else key
    out[name] = make_feature(value, spec)
  return out


def _feature(value, spec) -> example_wire.Feature:
  feature = example_wire.Feature()
  set_feature(feature, value, spec)
  return feature


def encode_example(values: Mapping[str, Any],
                   spec_structure: Optional[specs_lib.SpecStructLike] = None
                   ) -> bytes:
  """Serializes a flat dict of values to Example wire bytes."""
  return example_wire.encode_example(
      _features(values, _flat_specs(spec_structure), _feature))


def encode_sequence_example(
    context: Mapping[str, Any],
    sequences: Mapping[str, Any],
    spec_structure: Optional[specs_lib.SpecStructLike] = None) -> bytes:
  """Serializes context values and per-step sequence values (each with a
  leading time dimension) to SequenceExample wire bytes."""
  flat_specs = _flat_specs(spec_structure)
  return example_wire.encode_sequence_example(
      _features(context, flat_specs, _feature),
      _features(sequences, flat_specs,
                lambda value, spec: [_feature(v, spec) for v in value]))
