"""Spec type system: the subset of `tensor2robot_tpu.specs` the serving
path uses, for PyTorch.

* `TensorSpec` — a frozen dataclass of shape/dtype/name plus the
  data-pipeline attributes (is_optional, is_sequence, ...) and a
  `sharding` annotation: one mesh axis name (or None) per dim of the
  spec's own shape, a partition spec without a jax type.
* `SpecStruct` — an ordered mapping that is both flat (`'a/b/c'` path
  keys) and hierarchical (indexing an intermediate path returns a live
  view onto the parent store).
* The spec algebra the preprocessor contract and the data plane need:
  flatten / pack / validate / compare / copy / filter (required, by
  dataset) / sequence-length specs / dtype rewrites.
* `make_random_numpy`, with the same numpy RNG stream as the JAX package,
  so one seed gives one batch in both, and `make_constant_numpy`.
* The `t2r_assets` sidecar of an export bundle: `Assets` (specs and
  global step) as `t2r_assets.json`, and as the text-format `T2RAssets`
  proto `assets.extra/t2r_assets.pbtxt` that robot stacks read. The port
  imports no protobuf: the text format is written and parsed here, with
  the JAX package's field numbers, the TF `DataType` enum and the float
  formatting of protobuf's `text_format`, byte for byte.

dtypes: numpy has no bfloat16, so a bfloat16 spec carries
`torch.bfloat16`; every other dtype is a `np.dtype`. A torch tensor's
dtype is mapped onto the same scale before it is compared with a spec.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import struct
from collections import OrderedDict
from typing import (Any, Dict, Iterator, List, Mapping, MutableMapping,
                    Optional, Tuple, Union)

import numpy as np
import torch

__all__ = [
    "TensorSpec",
    "SpecStruct",
    "flatten_spec_structure",
    "pack_flat_sequence_to_spec_structure",
    "validate",
    "validate_and_pack",
    "validate_and_flatten",
    "assert_equal",
    "assert_required",
    "copy_specs",
    "filter_required",
    "filter_by_dataset",
    "dataset_keys",
    "add_sequence_length_specs",
    "replace_dtype",
    "cast_float32_to_bfloat16",
    "make_random_numpy",
    "make_constant_numpy",
    "Assets",
    "ASSET_FILENAME",
    "PBTXT_ASSET_FILENAME",
    "write_assets",
    "load_assets",
    "assets_to_pbtxt",
    "assets_from_pbtxt",
    "write_assets_pbtxt",
    "sharding_axes",
    "partition_specs",
]

_VALID_IMAGE_FORMATS = ("jpeg", "jpg", "png", "bmp", "gif")


def _canonical_dtype(dtype: Any) -> Any:
  """A dtype-like as a `np.dtype`, or `torch.bfloat16` for bfloat16."""
  if dtype == "bfloat16" or dtype is torch.bfloat16:
    return torch.bfloat16
  if isinstance(dtype, torch.dtype):
    # torch dtypes other than bfloat16 have a numpy twin of the same
    # name (read from the name, so that it works under a fake-tensor
    # mode too).
    return np.dtype(str(dtype).removeprefix("torch."))
  return np.dtype(dtype)


def _dtype_name(dtype: Any) -> str:
  return "bfloat16" if dtype is torch.bfloat16 else dtype.name


@dataclasses.dataclass(frozen=True)
class TensorSpec:
  """Shape/dtype spec with data-pipeline metadata. Shapes are tuples with
  `None` for unknown dims; batch dims are not part of model specs."""

  shape: Tuple[Optional[int], ...]
  dtype: Any = np.float32
  name: Optional[str] = None
  is_optional: bool = False
  is_sequence: bool = False
  is_extracted: bool = False
  data_format: Optional[str] = None
  dataset_key: str = ""
  varlen_default_value: Optional[float] = None
  sharding: Optional[Tuple[Optional[str], ...]] = None

  def __post_init__(self):
    object.__setattr__(self, "shape", tuple(self.shape))
    object.__setattr__(self, "dtype", _canonical_dtype(self.dtype))
    if self.data_format is not None:
      fmt = self.data_format.lower()
      if fmt not in _VALID_IMAGE_FORMATS:
        raise ValueError(
            f"Unsupported data_format {self.data_format!r}; expected one of "
            f"{_VALID_IMAGE_FORMATS}.")
      object.__setattr__(self, "data_format", fmt)
    if self.sharding is not None:
      object.__setattr__(self, "sharding", tuple(self.sharding))

  def replace(self, **overrides) -> "TensorSpec":
    return dataclasses.replace(self, **overrides)

  def with_batch(self, batch_size: Optional[int] = None) -> "TensorSpec":
    """The spec with a leading batch dimension prepended; a sharding
    annotation gains an unannotated batch dim."""
    sharding = (None,) + self.sharding if self.sharding is not None else None
    return self.replace(shape=(batch_size,) + self.shape, sharding=sharding)

  def without_batch(self) -> "TensorSpec":
    """The spec with its leading dimension stripped (and its sharding
    annotation's)."""
    if not self.shape:
      raise ValueError(f"Spec {self} has no batch dimension to strip.")
    sharding = self.sharding[1:] if self.sharding is not None else None
    return self.replace(shape=self.shape[1:], sharding=sharding)

  def partition_spec(self) -> Tuple[Optional[str], ...]:
    """The sharding annotation as a partition spec: a tuple of mesh axis
    names or None, () when unannotated (replicated)."""
    return () if self.sharding is None else tuple(self.sharding)

  @property
  def is_image(self) -> bool:
    return self.data_format is not None

  def is_compatible_with(self, array: Any, ignore_batch: bool = False) -> bool:
    shape = tuple(array.shape) if hasattr(array, "shape") \
        else tuple(np.shape(array))
    if hasattr(array, "dtype"):
      dtype = _canonical_dtype(array.dtype)
    else:
      dtype = _canonical_dtype(np.asarray(array).dtype)
    if ignore_batch:
      if not shape:
        return False
      shape = shape[1:]
    if len(shape) != len(self.shape):
      return False
    for dim, spec_dim in zip(shape, self.shape):
      if spec_dim is not None and dim != spec_dim:
        return False
    return dtype == self.dtype

  def to_dict(self) -> dict:
    """The JSON form of the JAX package's `TensorSpec.to_dict`: shape and
    dtype name, then each other field that differs from its default."""
    d = {"shape": [d if d is None else int(d) for d in self.shape],
         "dtype": _dtype_name(self.dtype)}
    for field in ("name", "is_optional", "is_sequence", "is_extracted",
                  "data_format", "dataset_key", "varlen_default_value",
                  "sharding"):
      value = getattr(self, field)
      if value != TensorSpec.__dataclass_fields__[field].default:
        d[field] = list(value) if field == "sharding" else value
    return d

  @classmethod
  def from_dict(cls, d: Mapping[str, Any]) -> "TensorSpec":
    """Inverse of `to_dict` (a JAX spec's `sharding` included)."""
    kwargs = dict(d)
    kwargs["shape"] = tuple(kwargs["shape"])
    if kwargs.get("sharding") is not None:
      kwargs["sharding"] = tuple(kwargs["sharding"])
    return cls(**kwargs)

  def __repr__(self) -> str:
    extras = []
    for field in ("name", "is_optional", "is_sequence", "data_format",
                  "dataset_key", "varlen_default_value", "sharding"):
      value = getattr(self, field)
      if value not in (None, False, ""):
        extras.append(f"{field}={value!r}")
    extra = (", " + ", ".join(extras)) if extras else ""
    return f"TensorSpec({self.shape}, {_dtype_name(self.dtype)}{extra})"


_PATH_SEP = "/"


def _bisect_left(keys: List[str], key: str) -> int:
  """`bisect.bisect_left` in Python: the C builtin cannot be traced into
  a compiled graph, and a model's forward builds SpecStructs."""
  lo, hi = 0, len(keys)
  while lo < hi:
    mid = (lo + hi) // 2
    if keys[mid] < key:
      lo = mid + 1
    else:
      hi = mid
  return lo


def _normalize_key(key: str) -> str:
  if not isinstance(key, str):
    raise TypeError(f"SpecStruct keys must be str, got {type(key)}")
  key = key.replace(".", _PATH_SEP).strip(_PATH_SEP)
  if not key:
    raise KeyError("Empty SpecStruct key.")
  return key


class SpecStruct(MutableMapping):
  """Flat/hierarchical dual-view ordered mapping: values live under flat
  `'a/b/c'` keys; an intermediate path returns a live view sharing the
  parent's storage."""

  def __init__(self, *args, **kwargs):
    object.__setattr__(self, "_store", OrderedDict())
    object.__setattr__(self, "_index", [])  # sorted flat keys, shared by views
    object.__setattr__(self, "_prefix", "")
    for arg in args:
      if isinstance(arg, Mapping):
        for key, value in arg.items():
          self[key] = value
      elif arg is not None:
        raise TypeError(f"Cannot build SpecStruct from {type(arg)}")
    for key, value in kwargs.items():
      self[key] = value

  @classmethod
  def _view(cls, parent: "SpecStruct", prefix: str) -> "SpecStruct":
    view = cls.__new__(cls)
    object.__setattr__(view, "_store", parent._store)
    object.__setattr__(view, "_index", parent._index)
    object.__setattr__(view, "_prefix", prefix)
    return view

  def _children(self, child_prefix: str) -> list:
    i = _bisect_left(self._index, child_prefix)
    out = []
    while i < len(self._index) and self._index[i].startswith(child_prefix):
      out.append(self._index[i])
      i += 1
    return out

  def _insert(self, full: str, value: Any) -> None:
    if full not in self._store:
      self._index.insert(_bisect_left(self._index, full), full)
    self._store[full] = value

  def _remove(self, full: str) -> None:
    del self._store[full]
    self._index.pop(_bisect_left(self._index, full))

  def __getitem__(self, key: str) -> Any:
    full = self._prefix + _normalize_key(key)
    if full in self._store:
      return self._store[full]
    if self._children(full + _PATH_SEP):
      return SpecStruct._view(self, full + _PATH_SEP)
    raise KeyError(key)

  def __setitem__(self, key: str, value: Any) -> None:
    full = self._prefix + _normalize_key(key)
    child_prefix = full + _PATH_SEP
    if isinstance(value, Mapping):
      if not value:
        raise ValueError(
            f"Cannot assign an empty mapping to {full!r}: ambiguous between "
            "delete and empty subtree. Use `del` to remove a subtree.")
      for k in self._children(child_prefix):
        self._remove(k)
      if full in self._store:
        self._remove(full)
      for sub_key, sub_value in value.items():
        SpecStruct._view(self, child_prefix)[sub_key] = sub_value
      return
    if self._children(child_prefix):
      raise KeyError(
          f"Cannot assign a leaf to {full!r}: it is an intermediate node.")
    parts = full.split(_PATH_SEP)
    for i in range(1, len(parts)):
      ancestor = _PATH_SEP.join(parts[:i])
      if ancestor in self._store:
        raise KeyError(
            f"Cannot assign {full!r}: ancestor {ancestor!r} is a leaf.")
    self._insert(full, value)

  def __delitem__(self, key: str) -> None:
    full = self._prefix + _normalize_key(key)
    if full in self._store:
      self._remove(full)
      return
    children = self._children(full + _PATH_SEP)
    if not children:
      raise KeyError(key)
    for k in children:
      self._remove(k)

  def __iter__(self) -> Iterator[str]:
    plen = len(self._prefix)
    for k in list(self._store):
      if k.startswith(self._prefix):
        yield k[plen:]

  def __len__(self) -> int:
    return sum(1 for _ in self)

  def __contains__(self, key: object) -> bool:
    try:
      self[key]  # type: ignore[index]
      return True
    except (KeyError, TypeError):
      return False

  def __getattr__(self, name: str) -> Any:
    if name.startswith("_"):
      raise AttributeError(name)
    try:
      return self[name]
    except KeyError as e:
      raise AttributeError(name) from e

  def __setattr__(self, name: str, value: Any) -> None:
    if name.startswith("_"):
      object.__setattr__(self, name, value)
    else:
      self[name] = value

  def __repr__(self) -> str:
    items = ", ".join(f"{k!r}: {v!r}" for k, v in self.items())
    return f"SpecStruct({{{items}}})"


SpecStructLike = Union[SpecStruct, Mapping[str, Any]]


def flatten_spec_structure(structure: SpecStructLike) -> SpecStruct:
  """Flattens any nested mapping (or SpecStruct) into a flat SpecStruct."""
  if not isinstance(structure, Mapping):
    raise TypeError(f"Cannot flatten {type(structure)}")
  out = SpecStruct()
  for key, value in structure.items():
    out[key] = value  # __setitem__ recurses into mappings
  return out


def pack_flat_sequence_to_spec_structure(
    spec_structure: SpecStructLike,
    flat_values: Mapping[str, Any]) -> SpecStruct:
  """Packs flat values into the layout of `spec_structure`; optional specs
  with no value are left out, values not in the spec are dropped."""
  specs = flatten_spec_structure(spec_structure)
  values = flatten_spec_structure(flat_values)
  packed = SpecStruct()
  for key, spec in specs.items():
    if key in values and values[key] is not None:
      packed[key] = values[key]
    elif isinstance(spec, TensorSpec) and spec.is_optional:
      continue
    else:
      raise ValueError(
          f"Required spec {key!r} has no matching value. Available: "
          f"{sorted(values.keys())}")
  return packed


def validate(spec_structure: SpecStructLike,
             values: SpecStructLike,
             ignore_batch: bool = False) -> None:
  """Validates values against specs; raises ValueError on any mismatch."""
  specs = flatten_spec_structure(spec_structure)
  flat_values = flatten_spec_structure(values)
  errors = []
  for key, spec in specs.items():
    if not isinstance(spec, TensorSpec):
      raise TypeError(f"Spec leaf {key!r} is not a TensorSpec: {spec!r}")
    value = flat_values[key] if key in flat_values else None
    if value is None:
      if not spec.is_optional:
        errors.append(f"missing required value for {key!r} (spec {spec!r})")
      continue
    if not spec.is_compatible_with(value, ignore_batch=ignore_batch):
      errors.append(
          f"value for {key!r} with shape {tuple(value.shape)} dtype "
          f"{value.dtype} is incompatible with {spec!r} "
          f"(ignore_batch={ignore_batch})")
  if errors:
    raise ValueError("Spec validation failed:\n  " + "\n  ".join(errors))


def validate_and_pack(spec_structure: SpecStructLike,
                      values: SpecStructLike,
                      ignore_batch: bool = False) -> SpecStruct:
  packed = pack_flat_sequence_to_spec_structure(spec_structure, values)
  validate(spec_structure, packed, ignore_batch=ignore_batch)
  return packed


def validate_and_flatten(spec_structure: SpecStructLike,
                         values: SpecStructLike,
                         ignore_batch: bool = False) -> SpecStruct:
  validate(spec_structure, values, ignore_batch=ignore_batch)
  return pack_flat_sequence_to_spec_structure(
      spec_structure, flatten_spec_structure(values))


def _check_pairs(pairs, ignore_batch: bool, what: str) -> None:
  for key, sa, sb in pairs:
    shape_a, shape_b = sa.shape, sb.shape
    if ignore_batch:
      shape_a, shape_b = shape_a[1:], shape_b[1:]
    if shape_a != shape_b or sa.dtype != sb.dtype:
      raise ValueError(f"{what} mismatch at {key!r}: {sa!r} vs {sb!r}")


def assert_equal(spec_a: SpecStructLike, spec_b: SpecStructLike,
                 ignore_batch: bool = False) -> None:
  """Raises unless two spec structures have the same keys, shapes and
  dtypes."""
  a = flatten_spec_structure(spec_a)
  b = flatten_spec_structure(spec_b)
  if set(a.keys()) != set(b.keys()):
    raise ValueError(
        f"Spec key sets differ: only_in_a={sorted(set(a) - set(b))}, "
        f"only_in_b={sorted(set(b) - set(a))}")
  _check_pairs(((k, a[k], b[k]) for k in a), ignore_batch, "Spec")


def assert_required(required: SpecStructLike, actual: SpecStructLike,
                    ignore_batch: bool = False) -> None:
  """Raises unless every non-optional spec of `required` is in `actual`
  with its shape and dtype."""
  req = filter_required(required)
  act = flatten_spec_structure(actual)
  for key in req:
    if key not in act:
      raise ValueError(f"Required spec {key!r} missing from actual structure "
                       f"with keys {sorted(act.keys())}")
  _check_pairs(((k, req[k], act[k]) for k in req), ignore_batch,
               "Required spec")


def copy_specs(spec_structure: SpecStructLike, prefix: str = "",
               batch_size: Optional[int] = None) -> SpecStruct:
  """A copy of a spec structure, under a key prefix and with a leading
  batch dim (None for batch_size <= 0) where asked."""
  out = SpecStruct()
  for key, spec in flatten_spec_structure(spec_structure).items():
    if batch_size is not None:
      spec = spec.replace(
          shape=(batch_size if batch_size > 0 else None,) + spec.shape)
    out[f"{prefix}/{key}" if prefix else key] = spec
  return out


def filter_required(spec_structure: SpecStructLike) -> SpecStruct:
  """Drops optional specs."""
  out = SpecStruct()
  for key, spec in flatten_spec_structure(spec_structure).items():
    if not spec.is_optional:
      out[key] = spec
  return out


def filter_by_dataset(spec_structure: SpecStructLike,
                      dataset_key: str) -> SpecStruct:
  """The specs of one dataset."""
  out = SpecStruct()
  for key, spec in flatten_spec_structure(spec_structure).items():
    if spec.dataset_key == dataset_key:
      out[key] = spec
  return out


def dataset_keys(spec_structure: SpecStructLike) -> Tuple[str, ...]:
  """The dataset keys of a spec structure, in first-seen order."""
  keys = []
  for spec in flatten_spec_structure(spec_structure).values():
    if spec.dataset_key not in keys:
      keys.append(spec.dataset_key)
  return tuple(keys)


def add_sequence_length_specs(spec_structure: SpecStructLike) -> SpecStruct:
  """Adds `<key>_length` int64 scalar specs for every sequence spec."""
  out = SpecStruct()
  for key, spec in flatten_spec_structure(spec_structure).items():
    out[key] = spec
    if spec.is_sequence:
      out[key + "_length"] = TensorSpec(
          shape=(), dtype=np.int64, name=(spec.name or key) + "_length",
          dataset_key=spec.dataset_key)
  return out


def replace_dtype(spec_structure: SpecStructLike,
                  from_dtype: Any,
                  to_dtype: Any) -> SpecStruct:
  from_dtype = _canonical_dtype(from_dtype)
  out = SpecStruct()
  for key, spec in flatten_spec_structure(spec_structure).items():
    if spec.dtype == from_dtype:
      spec = spec.replace(dtype=to_dtype)
    out[key] = spec
  return out


def cast_float32_to_bfloat16(values: SpecStructLike) -> SpecStruct:
  """float32 tensors -> bfloat16; every other leaf as it is."""
  out = SpecStruct()
  for key, value in flatten_spec_structure(values).items():
    if isinstance(value, torch.Tensor) and value.dtype == torch.float32:
      value = value.to(torch.bfloat16)
    out[key] = value
  return out


def _concrete_shape(spec: TensorSpec, batch_size: Optional[int],
                    unknown_dim: int = 1) -> Tuple[int, ...]:
  shape = tuple(unknown_dim if d is None else d for d in spec.shape)
  if batch_size is not None:
    shape = (batch_size,) + shape
  return shape


def make_random_numpy(spec_structure: SpecStructLike,
                      batch_size: Optional[int] = None,
                      sequence_length: int = 3,
                      seed: Optional[int] = None) -> SpecStruct:
  """Random numpy data matching a spec structure: the JAX package's
  generator, draw for draw."""
  rng = np.random.RandomState(seed)
  out = SpecStruct()
  for key, spec in filter_required(spec_structure).items():
    if spec.dtype is torch.bfloat16:
      raise ValueError(f"{key!r}: numpy has no bfloat16; make float32 "
                       "data and cast it on the device.")
    shape = _concrete_shape(spec, batch_size, unknown_dim=sequence_length)
    if np.issubdtype(spec.dtype, np.integer):
      high = 255 if spec.is_image else 10
      out[key] = rng.randint(0, high, size=shape).astype(spec.dtype)
    elif spec.dtype == np.bool_:
      out[key] = rng.rand(*shape) > 0.5
    else:
      out[key] = rng.rand(*shape).astype(spec.dtype)
  return out


def make_constant_numpy(spec_structure: SpecStructLike,
                        constant_value: float,
                        batch_size: Optional[int] = None,
                        sequence_length: int = 3) -> SpecStruct:
  """Constant numpy data matching a spec structure."""
  out = SpecStruct()
  for key, spec in filter_required(spec_structure).items():
    if spec.dtype is torch.bfloat16:
      raise ValueError(f"{key!r}: numpy has no bfloat16; make float32 "
                       "data and cast it on the device.")
    shape = _concrete_shape(spec, batch_size, unknown_dim=sequence_length)
    out[key] = np.full(shape, constant_value, dtype=spec.dtype)
  return out


# -- sharding annotations -----------------------------------------------------


def sharding_axes(spec_structure: SpecStructLike
                  ) -> "OrderedDict[str, Tuple[Optional[str], ...]]":
  """Flat key -> `TensorSpec.sharding` tuple, for annotated leaves only."""
  out: "OrderedDict[str, Tuple[Optional[str], ...]]" = OrderedDict()
  for key, spec in flatten_spec_structure(spec_structure).items():
    if isinstance(spec, TensorSpec) and spec.sharding is not None:
      out[key] = spec.sharding
  return out


def partition_specs(spec_structure: SpecStructLike,
                    batch_axis: Optional[str] = "data") -> SpecStruct:
  """Partition spec (a tuple of mesh axis names or None) of each batched
  value of an unbatched model spec: the batch dim over `batch_axis`, the
  remaining dims by the leaf's `sharding` annotation (positional over the
  spec's own shape)."""
  out = SpecStruct()
  for key, spec in flatten_spec_structure(spec_structure).items():
    out[key] = (batch_axis,) + tuple(spec.sharding or ())
  return out


# -- the t2r_assets sidecar ---------------------------------------------------

ASSET_FILENAME = "t2r_assets.json"
PBTXT_ASSET_FILENAME = "t2r_assets.pbtxt"


@dataclasses.dataclass
class Assets:
  """An export bundle's sidecar: the serving feature and label specs and
  the global step, everything a predictor needs to build feeds."""

  feature_spec: Optional[SpecStruct] = None
  label_spec: Optional[SpecStruct] = None
  global_step: Optional[int] = None
  extra: dict = dataclasses.field(default_factory=dict)

  def to_json(self) -> str:
    def _spec_dict(struct):
      if struct is None:
        return None
      return {k: v.to_dict() for k, v in
              flatten_spec_structure(struct).items()}

    return json.dumps({
        "feature_spec": _spec_dict(self.feature_spec),
        "label_spec": _spec_dict(self.label_spec),
        "global_step": self.global_step,
        "extra": self.extra,
    }, indent=2, sort_keys=True)

  @classmethod
  def from_json(cls, text: str) -> "Assets":
    data = json.loads(text)

    def _spec_struct(d):
      if d is None:
        return None
      return SpecStruct({k: TensorSpec.from_dict(v) for k, v in d.items()})

    return cls(feature_spec=_spec_struct(data.get("feature_spec")),
               label_spec=_spec_struct(data.get("label_spec")),
               global_step=data.get("global_step"),
               extra=data.get("extra", {}))


def _write_text(path: str, text: str) -> None:
  os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
  with open(path, "w") as f:
    f.write(text)


def write_assets(assets: Assets, path: str) -> None:
  _write_text(path, assets.to_json())


def write_assets_pbtxt(assets: Assets, path: str) -> None:
  _write_text(path, assets_to_pbtxt(assets))


def load_assets(path: str) -> Assets:
  """Reads a sidecar, JSON or pbtxt by its extension. When `path` is
  missing, its sibling with the other extension, or
  `assets.extra/t2r_assets.pbtxt` beside it, is read instead."""
  if not os.path.isfile(path):
    base, ext = os.path.splitext(path)
    sibling = base + (".json" if ext == ".pbtxt" else ".pbtxt")
    for candidate in (sibling, os.path.join(os.path.dirname(path),
                                            "assets.extra",
                                            PBTXT_ASSET_FILENAME)):
      if os.path.isfile(candidate):
        path = candidate
        break
  with open(path) as f:
    text = f.read()
  if path.endswith(".pbtxt"):
    return assets_from_pbtxt(text)
  return Assets.from_json(text)


# The text format of the JAX package's `T2RAssets` proto:
#   ExtendedTensorSpec {1 repeated int32 shape; 2 int32 dtype; 3 string
#     name; 4 bool is_optional; 5 bool is_extracted; 6 string data_format;
#     7 string dataset_key; 8 float varlen_default_value}
#   TensorSpecStruct {1 map<string, ExtendedTensorSpec> key_value}
#   T2RAssets {1 TensorSpecStruct feature_spec; 2 TensorSpecStruct
#     label_spec; 3 int32 global_step}
# Fields print in number order, map entries by sorted key, a submessage
# as `name {` ... `}` indented by two.

# tensorflow/core/framework/types.proto DataType values.
_NP_TO_TF_ENUM = {
    "float32": 1, "float64": 2, "int32": 3, "uint8": 4, "int16": 5,
    "int8": 6, "object": 7, "complex64": 8, "int64": 9, "bool": 10,
    "bfloat16": 14, "uint16": 17, "complex128": 18, "float16": 19,
    "uint32": 22, "uint64": 23,
}
_TF_ENUM_TO_NP = {v: k for k, v in _NP_TO_TF_ENUM.items()}
_SPEC_FIELDS = (  # (name, kind) in field-number order after shape/dtype
    ("name", "string"), ("is_optional", "bool"), ("is_extracted", "bool"),
    ("data_format", "string"), ("dataset_key", "string"),
    ("varlen_default_value", "float"))


def _escape(text: str) -> str:
  """protobuf's `CEscape` as `text_format` applies it by default
  (as_utf8): quotes, backslash and the ASCII controls escaped, every
  other character as it is."""
  out = []
  for char in text:
    if char in '"\\\'':
      out.append("\\" + char)
    elif char in "\n\r\t":
      out.append({"\n": "\\n", "\r": "\\r", "\t": "\\t"}[char])
    elif ord(char) < 32 or ord(char) == 127:
      out.append("\\%03o" % ord(char))
    else:
      out.append(char)
  return "".join(out)


def _shortest_float(value: float) -> str:
  """A float field as `text_format` prints it: the shortest decimal that
  rounds to the same 4-byte float."""
  if math.isnan(value):
    return str(value)
  original = struct.unpack("<f", struct.pack("<f", value))[0]
  precision = 6
  while True:
    rounded = float(f"{original:.{precision}g}")
    if struct.unpack("<f", struct.pack("<f", rounded))[0] == original:
      return str(rounded)
    precision += 1


def _spec_lines(spec: TensorSpec, indent: str) -> List[str]:
  lines = [f"{indent}shape: {-1 if d is None else int(d)}"
           for d in spec.shape]
  enum = _NP_TO_TF_ENUM.get(_dtype_name(spec.dtype))
  if enum is None:
    raise ValueError(f"dtype {spec.dtype} has no TF DataType enum; cannot "
                     f"serialize to {PBTXT_ASSET_FILENAME}")
  lines.append(f"{indent}dtype: {enum}")
  for field, kind in _SPEC_FIELDS:
    value = getattr(spec, field)
    if kind == "string" and value is not None and (
        field != "dataset_key" or value):
      lines.append(f'{indent}{field}: "{_escape(value)}"')
    elif kind == "bool" and value:
      lines.append(f"{indent}{field}: true")
    elif kind == "float" and value is not None:
      lines.append(f"{indent}{field}: {_shortest_float(float(value))}")
  return lines


def assets_to_pbtxt(assets: Assets) -> str:
  """`assets` as text-format `T2RAssets`, as protobuf's
  `text_format.MessageToString` prints it."""
  lines: List[str] = []
  for field, struct_ in (("feature_spec", assets.feature_spec),
                         ("label_spec", assets.label_spec)):
    flat = None if struct_ is None else flatten_spec_structure(struct_)
    if not flat:  # an empty map leaves the submessage unset
      continue
    lines.append(f"{field} {{")
    for key in sorted(flat):
      lines += ["  key_value {", f'    key: "{_escape(key)}"', "    value {"]
      lines += _spec_lines(flat[key], " " * 6)
      lines += ["    }", "  }"]
    lines.append("}")
  if assets.global_step is not None:
    lines.append(f"global_step: {int(assets.global_step)}")
  return "".join(line + "\n" for line in lines)


def _pbtxt_tokens(text: str) -> Iterator[str]:
  """Tokens of protobuf text format: names, numbers, quoted strings
  (unescaped) and the punctuation `{ } < > :`; comments and the optional
  separators `,` `;` are dropped."""
  i, n = 0, len(text)
  while i < n:
    char = text[i]
    if char.isspace() or char in ",;":
      i += 1
    elif char == "#":
      while i < n and text[i] != "\n":
        i += 1
    elif char in "{}<>:":
      yield char
      i += 1
    elif char in "\"'":
      quote, i, raw = char, i + 1, bytearray()
      while text[i] != quote:
        if text[i] != "\\":
          raw += text[i].encode("utf-8")
          i += 1
          continue
        esc = text[i + 1]
        if esc in "01234567":
          j = i + 1
          while j < min(i + 4, n) and text[j] in "01234567":
            j += 1
          raw.append(int(text[i + 1:j], 8))
          i = j
        elif esc == "x":
          j = i + 2
          while j < min(i + 4, n) and text[j] in "0123456789abcdefABCDEF":
            j += 1
          raw.append(int(text[i + 2:j], 16))
          i = j
        else:
          raw += {"n": b"\n", "r": b"\r", "t": b"\t", "a": b"\a",
                  "b": b"\b", "f": b"\f", "v": b"\v"}.get(
                      esc, esc.encode("utf-8"))
          i += 2
      yield '"' + raw.decode("utf-8")
      i += 1
    else:
      start = i
      while i < n and not text[i].isspace() and text[i] not in "{}<>:,;#":
        i += 1
      yield text[start:i]


def _parse_message(tokens: Iterator[str], close: Optional[str]) -> list:
  """[(field, value)] of one message: a value is a token or a nested list."""
  fields = []
  for token in tokens:
    if token == close:
      return fields
    if token in "{}<>:" or token.startswith('"'):
      raise ValueError(f"{PBTXT_ASSET_FILENAME}: unexpected {token!r}")
    value = next(tokens)
    if value == ":":
      value = next(tokens)
    if value in ("{", "<"):
      value = _parse_message(tokens, "}" if value == "{" else ">")
    fields.append((token, value))
  if close is not None:
    raise ValueError(f"{PBTXT_ASSET_FILENAME}: unterminated message")
  return fields


def _spec_from_fields(fields: list) -> TensorSpec:
  kwargs: Dict[str, Any] = {"shape": []}
  dtype_name = "float32"
  for field, value in fields:
    if field == "shape":
      kwargs["shape"].append(None if int(value) == -1 else int(value))
    elif field == "dtype":
      dtype_name = _TF_ENUM_TO_NP.get(int(value))
      if dtype_name is None:
        raise ValueError(f"{PBTXT_ASSET_FILENAME}: TF DataType enum "
                         f"{value} has no numpy equivalent")
    elif field in ("name", "data_format", "dataset_key"):
      kwargs[field] = value[1:]
    elif field in ("is_optional", "is_extracted"):
      kwargs[field] = value in ("true", "True", "t", "1")
    elif field == "varlen_default_value":
      # A proto float: the value the 4-byte field holds.
      kwargs[field] = struct.unpack(
          "<f", struct.pack("<f", float(value.rstrip("fF"))))[0]
    else:
      raise ValueError(f"{PBTXT_ASSET_FILENAME}: unknown spec field "
                       f"{field!r}")
  kwargs["dtype"] = np.dtype(object) if dtype_name == "object" \
      else dtype_name
  return TensorSpec(**kwargs)


def assets_from_pbtxt(text: str) -> Assets:
  """Parses text-format `T2RAssets` (the inverse of `assets_to_pbtxt`,
  and reads what the JAX package's writer and `text_format` write)."""
  assets = Assets()
  for field, value in _parse_message(_pbtxt_tokens(text), None):
    if field in ("feature_spec", "label_spec"):
      struct_ = getattr(assets, field) or SpecStruct()
      for entry_field, entry in value:
        if entry_field != "key_value":
          raise ValueError(f"{PBTXT_ASSET_FILENAME}: unknown field "
                           f"{entry_field!r} in {field}")
        entry = dict(entry)
        struct_[entry["key"][1:]] = _spec_from_fields(entry.get("value", []))
      setattr(assets, field, struct_)
    elif field == "global_step":
      assets.global_step = int(value)
    else:
      raise ValueError(f"{PBTXT_ASSET_FILENAME}: unknown field {field!r}")
  return assets
