"""tf.train.Example wire format in pure Python, with no protobuf runtime.

Encodes and decodes `Example`, `SequenceExample`, `Features`,
`FeatureLists`, `FeatureList` and `Feature` (bytes, float and int64
lists) as `example.proto` beside this file defines them. The encoder
writes what protobuf's deterministic serialization writes for these
messages: float and int64 lists packed, every map entry with its key and
value, map entries in key order, an empty list as a present empty
submessage. (Protobuf's default serialization writes map entries in its
hash table's order; the message is the same.) The decoder reads packed and unpacked lists
alike, merges repeated submessages, lets the last of duplicate map keys
win and skips unknown fields, as protobuf does.

Messages are plain Python:
* a `Feature` has a `kind` ('bytes_list', 'float_list', 'int64_list' or
  None for an empty feature) and its `value` list;
* `Features` are a dict of name -> Feature;
* `FeatureLists` are a dict of name -> list of Feature.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Mapping, Optional, Sequence, Tuple

import numpy as np

__all__ = ["Feature", "encode_example", "encode_sequence_example",
           "decode_example", "decode_sequence_example", "encode_feature",
           "decode_feature"]

BYTES_LIST, FLOAT_LIST, INT64_LIST = "bytes_list", "float_list", "int64_list"
_KIND_FIELDS = {BYTES_LIST: 1, FLOAT_LIST: 2, INT64_LIST: 3}
_FIELD_KINDS = {v: k for k, v in _KIND_FIELDS.items()}
_VARINT, _FIXED64, _LEN, _FIXED32 = 0, 1, 2, 5
_U64 = (1 << 64) - 1


class Feature:
  """One Feature message: a oneof of three lists. Adding values of
  another kind replaces the list, as setting a oneof member does."""

  __slots__ = ("kind", "value")

  def __init__(self, kind: Optional[str] = None,
               value: Optional[Sequence] = None):
    self.kind = kind
    self.value = list(value) if value is not None else []

  def _become(self, kind: str) -> None:
    if self.kind != kind:
      self.kind, self.value = kind, []

  def add_bytes(self, values: Sequence[bytes]) -> None:
    self._become(BYTES_LIST)
    self.value.extend(bytes(v) for v in values)

  def add_floats(self, values) -> None:
    self._become(FLOAT_LIST)
    # float32 on the wire, as protobuf rounds a Python float.
    self.value.extend(np.asarray(values, np.float64).reshape(-1)
                      .astype(np.float32).tolist())

  def add_ints(self, values) -> None:
    self._become(INT64_LIST)
    self.value.extend(int(v) for v in values)

  def __eq__(self, other) -> bool:
    return (isinstance(other, Feature) and self.kind == other.kind
            and list(self.value) == list(other.value))

  def __repr__(self) -> str:
    return f"Feature({self.kind!r}, {self.value!r})"


# -- encoding -----------------------------------------------------------------


def _varint(n: int) -> bytes:
  n &= _U64
  out = bytearray()
  while n > 0x7F:
    out.append((n & 0x7F) | 0x80)
    n >>= 7
  out.append(n)
  return bytes(out)


def _field(number: int, payload: bytes) -> bytes:
  """A length-delimited field."""
  return _varint((number << 3) | _LEN) + _varint(len(payload)) + payload


def encode_feature(feature: Feature) -> bytes:
  if feature.kind is None:
    return b""
  if feature.kind == BYTES_LIST:
    inner = b"".join(_field(1, v) for v in feature.value)
  elif feature.kind == FLOAT_LIST:
    packed = np.asarray(feature.value, "<f4").tobytes()
    inner = _field(1, packed) if packed else b""
  else:
    packed = b"".join(_varint(v) for v in feature.value)
    inner = _field(1, packed) if packed else b""
  return _field(_KIND_FIELDS[feature.kind], inner)


def _encode_map(entries: Mapping[str, bytes]) -> bytes:
  encoded = sorted((key.encode("utf-8"), value)
                   for key, value in entries.items())
  return b"".join(_field(1, _field(1, key) + _field(2, value))
                  for key, value in encoded)


def _encode_features(features: Mapping[str, Feature]) -> bytes:
  return _encode_map({k: encode_feature(f) for k, f in features.items()})


def encode_example(features: Mapping[str, Feature]) -> bytes:
  """Example { Features features = 1 }: absent when there is no feature."""
  return _field(1, _encode_features(features)) if features else b""


def encode_sequence_example(
    context: Mapping[str, Feature],
    feature_lists: Mapping[str, Sequence[Feature]]) -> bytes:
  """SequenceExample { Features context = 1; FeatureLists
  feature_lists = 2 }, each absent when empty."""
  out = b""
  if context:
    out += _field(1, _encode_features(context))
  if feature_lists:
    out += _field(2, _encode_map({
        k: b"".join(_field(1, encode_feature(f)) for f in steps)
        for k, steps in feature_lists.items()}))
  return out


# -- decoding -----------------------------------------------------------------


def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
  result = shift = 0
  while True:
    if pos >= len(buf):
      raise ValueError("Truncated varint in an Example record")
    byte = buf[pos]
    pos += 1
    result |= (byte & 0x7F) << shift
    if not byte & 0x80:
      return result & _U64, pos
    shift += 7
    if shift >= 70:
      raise ValueError("Varint too long in an Example record")


def _fields(buf: bytes) -> Iterator[Tuple[int, int, object]]:
  """(field number, wire type, value) of each field of one message:
  an int for varints, else a view into `buf` (a memoryview: nested
  messages are walked without copies)."""
  pos, end = 0, len(buf)
  while pos < end:
    key, pos = _read_varint(buf, pos)
    number, wire_type = key >> 3, key & 7
    if wire_type == _VARINT:
      value, pos = _read_varint(buf, pos)
    elif wire_type == _LEN:
      size, pos = _read_varint(buf, pos)
      value = buf[pos:pos + size]
      if len(value) < size:
        raise ValueError("Truncated field in an Example record")
      pos += size
    elif wire_type in (_FIXED64, _FIXED32):
      size = 8 if wire_type == _FIXED64 else 4
      value = buf[pos:pos + size]
      if len(value) < size:
        raise ValueError("Truncated field in an Example record")
      pos += size
    else:
      raise ValueError(f"Unsupported wire type {wire_type} in an Example "
                       "record")
    yield number, wire_type, value


def _signed(n: int) -> int:
  return n - (1 << 64) if n >= (1 << 63) else n


def _list_values(kind: str, buf: bytes) -> List:
  values: List = []
  for number, wire_type, value in _fields(buf):
    if number != 1:
      continue
    if kind == BYTES_LIST and wire_type == _LEN:
      values.append(bytes(value))
    elif kind == FLOAT_LIST and wire_type in (_LEN, _FIXED32):
      values.extend(np.frombuffer(value, "<f4").tolist())
    elif kind == INT64_LIST and wire_type == _LEN:
      pos = 0
      while pos < len(value):
        n, pos = _read_varint(value, pos)
        values.append(_signed(n))
    elif kind == INT64_LIST and wire_type == _VARINT:
      values.append(_signed(value))
  return values


def decode_feature(buf: bytes) -> Feature:
  feature = Feature()
  for number, wire_type, value in _fields(memoryview(buf)):
    kind = _FIELD_KINDS.get(number)
    if kind is None or wire_type != _LEN:
      continue
    feature._become(kind)  # a repeated member of the same kind merges
    feature.value.extend(_list_values(kind, value))
  return feature


def _decode_map(buf: bytes, decode_value) -> Dict[str, object]:
  out: Dict[str, object] = {}
  for number, wire_type, entry in _fields(buf):
    if number != 1 or wire_type != _LEN:
      continue
    key, value = "", b""
    for n, wt, v in _fields(entry):
      if n == 1 and wt == _LEN:
        key = bytes(v).decode("utf-8")
      elif n == 2 and wt == _LEN:
        value = v
    out[key] = decode_value(value)  # the last of duplicate keys wins
  return out


def _decode_feature_list(buf: bytes) -> List[Feature]:
  return [decode_feature(v) for n, wt, v in _fields(buf)
          if n == 1 and wt == _LEN]


def decode_example(buf: bytes) -> Dict[str, Feature]:
  """The features of one Example record."""
  features: Dict[str, Feature] = {}
  for number, wire_type, value in _fields(memoryview(buf)):
    if number == 1 and wire_type == _LEN:
      features.update(_decode_map(value, decode_feature))
  return features


def decode_sequence_example(buf: bytes
                            ) -> Tuple[Dict[str, Feature],
                                       Dict[str, List[Feature]]]:
  """(context features, feature lists) of one SequenceExample record."""
  context: Dict[str, Feature] = {}
  feature_lists: Dict[str, List[Feature]] = {}
  for number, wire_type, value in _fields(memoryview(buf)):
    if number == 1 and wire_type == _LEN:
      context.update(_decode_map(value, decode_feature))
    elif number == 2 and wire_type == _LEN:
      feature_lists.update(_decode_map(value, _decode_feature_list))
  return context, feature_lists
