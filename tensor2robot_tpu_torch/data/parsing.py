"""Spec-driven batched record parsing.

The port's copy of `tensor2robot_tpu.data.parsing`: from feature/label
spec structures it makes a parse function mapping a batch of serialized
records to a SpecStruct of batched numpy arrays, handling:

* Example and SequenceExample records (`is_sequence` specs);
* fixed-length and variable-length features (pad/clip with
  `varlen_default_value`);
* batched image decode for jpeg/png/bmp/gif specs, with an empty string
  decoding to zeros;
* bfloat16 specs parsed as float32 and cast: numpy has no bfloat16, so
  those leaves come back as bfloat16 CPU tensors;
* multi-dataset joins: specs with different `dataset_key`s parse from
  separate record streams zipped together;
* `<key>_length` side outputs for sequence specs.

Two routes, as in the JAX package: the native columnar parser
(`native/example_parser.cc`) where every leaf fits its profile, JPEGs
then decoded by the native libjpeg decoder where that is built (PIL
otherwise); and the per-record Python route over `example_wire`, with
PIL decoding images. Both give the same bytes. The parse runs on host
threads, off the device, so it overlaps device compute.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from tensor2robot_tpu_torch import native
from tensor2robot_tpu_torch import specs as specs_lib
from tensor2robot_tpu_torch.data import codec, example_wire

__all__ = ["create_parse_fn", "ParseFn"]

# Native-path bytes-value capacity for is_extracted raw planes: planes
# split across more values than this re-parse on the Python path (the
# native parser stores at most `cap` values per feature), with a logged
# warning when mismatches disable the fast path for the stream.
_EXTRACTED_VALUE_CAP = 4

# Consecutive mismatched batches before the native parser is disabled
# for a stream. A single anomalous record only downgrades ITS batch;
# a stream that is legacy-format throughout stops paying for the wasted
# native pass after this many batches in a row fall back.
_NATIVE_DISABLE_STREAK = 3
# Non-consecutive mismatch budget: a shuffle-merge of legacy and
# new-format shards interleaves mismatches with good batches, so the
# streak alone would never trip. Disable once this many batches have
# fallen back overall AND mismatches are at least _NATIVE_DISABLE_RATIO
# of all batches attempted natively — the ratio guard keeps a
# multi-day stream with rare anomalous records (say 1 bad batch per
# 10k) on the fast path for its lifetime, while a genuinely mixed
# stream (a legacy shard merge runs ~50% mismatched) still trips.
_NATIVE_DISABLE_TOTAL = 20
_NATIVE_DISABLE_RATIO = 0.25


class _NativeFormatMismatch(Exception):
  """Wire data the native columnar parser cannot surface (e.g. a raw
  plane stored as float_list by legacy writers): retry on the Python
  path, which parses any wire kind."""


@dataclasses.dataclass
class _LeafPlan:
  out_key: str
  feature_name: str
  spec: specs_lib.TensorSpec
  parse_dtype: np.dtype  # dtype to materialize from the wire


def _plan_for(flat_specs: specs_lib.SpecStruct) -> List[_LeafPlan]:
  plans = []
  for key, spec in flat_specs.items():
    name = spec.name or key.rsplit("/", 1)[-1]
    parse_dtype = (np.dtype(np.float32) if spec.dtype is torch.bfloat16
                   else spec.dtype)
    plans.append(_LeafPlan(key, name, spec, parse_dtype))
  return plans


def _feature_values(feature: example_wire.Feature
                    ) -> Tuple[str, Sequence]:
  if feature.kind is None:
    return "missing", ()
  return feature.kind, feature.value


def _num_image_channels(spec: specs_lib.TensorSpec) -> Optional[int]:
  if spec.shape and spec.shape[-1] in (1, 3):
    return spec.shape[-1]
  return None


def _shaped(values: Sequence, plan: _LeafPlan,
            shape: Tuple[Optional[int], ...]) -> np.ndarray:
  """Reshapes/pads/clips raw wire values to the spec shape."""
  spec = plan.spec
  array = np.asarray(values, dtype=plan.parse_dtype)
  expected = int(np.prod([d for d in shape if d is not None], dtype=np.int64))
  has_unknown = any(d is None for d in shape)
  if not has_unknown:
    if array.size == expected:
      return array.reshape(shape)
    if spec.varlen_default_value is not None:
      flat = np.full(expected, spec.varlen_default_value,
                     dtype=plan.parse_dtype)
      n = min(array.size, expected)
      flat[:n] = array.ravel()[:n]  # clip or pad
      return flat.reshape(shape)
    raise ValueError(
        f"Feature {plan.feature_name!r} has {array.size} values, spec "
        f"{plan.out_key!r} expects {expected} ({spec!r}). Set "
        "varlen_default_value to enable pad/clip.")
  # Unknown leading dim: infer it from the payload.
  known = int(np.prod([d for d in shape if d is not None], dtype=np.int64))
  if known == 0 or array.size % known != 0:
    raise ValueError(
        f"Cannot infer unknown dim for {plan.out_key!r}: {array.size} "
        f"values vs known element count {known}.")
  inferred = array.size // known
  concrete = tuple(inferred if d is None else d for d in shape)
  return array.reshape(concrete)


def _native_jpeg_batch(flat_values: List[bytes], plan: _LeafPlan
                       ) -> Optional[np.ndarray]:
  """GIL-free libjpeg batch decode for fixed-shape uint8 jpeg specs;
  None -> caller uses the PIL path (empty/pad payloads, other formats,
  dynamic shapes, or no libjpeg build)."""
  spec = plan.spec
  if (spec.data_format or "").lower() not in ("jpeg", "jpg"):
    return None
  if plan.parse_dtype != np.uint8:
    return None
  shape = spec.shape[-3:]
  if len(shape) != 3 or any(d is None for d in shape) \
      or shape[-1] not in (1, 3):
    return None
  return native.decode_jpeg_batch(flat_values, *shape)


def _decode_image_feature(values: Sequence[bytes], plan: _LeafPlan
                          ) -> np.ndarray:
  spec = plan.spec
  channels = _num_image_channels(spec)
  if len(values) == 0 or (len(values) == 1 and len(values[0]) == 0):
    # An empty string decodes to zeros.
    concrete = tuple(1 if d is None else d for d in spec.shape)
    return np.zeros(concrete, dtype=plan.parse_dtype)
  if len(values) == 1:
    img = codec.decode_image(values[0], channels=channels)
    return img.astype(plan.parse_dtype)
  imgs = [codec.decode_image(v, channels=channels) for v in values]
  return np.stack(imgs).astype(plan.parse_dtype)


def _plane_from_values(values: Sequence[bytes],
                       plan: _LeafPlan) -> np.ndarray:
  """Raw-bytes tensor payload (e.g. pre-extracted uint8 image planes) —
  shared by the Python and native paths so value-join semantics cannot
  diverge. The common single-element case reads zero-copy from the
  proto bytes; joining would duplicate the whole plane."""
  buffer = values[0] if len(values) == 1 else b"".join(values)
  array = np.frombuffer(buffer, dtype=plan.parse_dtype)
  return _shaped(array, plan, plan.spec.shape)


def _parse_leaf_from_feature(feature, plan: _LeafPlan) -> np.ndarray:
  spec = plan.spec
  kind, values = _feature_values(feature)
  if spec.is_image and not spec.is_extracted:
    if kind not in ("bytes_list", "missing"):
      raise ValueError(
          f"Image spec {plan.out_key!r} expects bytes, got {kind}.")
    return _decode_image_feature(values, plan)
  if kind == "missing":
    if spec.is_optional:
      return None  # type: ignore[return-value]
    if spec.varlen_default_value is not None:
      return _shaped([], plan, spec.shape)
    raise ValueError(
        f"Record is missing required feature {plan.feature_name!r} "
        f"for spec {plan.out_key!r}.")
  if kind == "bytes_list" and plan.parse_dtype.kind in "SUO":
    array = np.asarray(list(values), dtype=object)
    return array if array.size != 1 else array.reshape(spec.shape or (1,))
  if kind == "bytes_list":
    return _plane_from_values(values, plan)
  return _shaped(values, plan, spec.shape)


def _pad_time(arrays: List[np.ndarray], time_dim: Optional[int],
              plan: _LeafPlan) -> np.ndarray:
  """Stacks per-record sequence arrays, padding/clipping the time dim."""
  max_t = time_dim if time_dim is not None else max(a.shape[0] for a in arrays)
  fill = plan.spec.varlen_default_value or 0
  out = []
  for a in arrays:
    if a.shape[0] > max_t:
      a = a[:max_t]
    elif a.shape[0] < max_t:
      pad_shape = (max_t - a.shape[0],) + a.shape[1:]
      a = np.concatenate(
          [a, np.full(pad_shape, fill, dtype=a.dtype)], axis=0)
    out.append(a)
  return np.stack(out)


class ParseFn:
  """Callable parsing batches of serialized records into spec layout."""

  def __init__(self,
               feature_spec: specs_lib.SpecStructLike,
               label_spec: Optional[specs_lib.SpecStructLike] = None):
    self._feature_spec = specs_lib.flatten_spec_structure(feature_spec)
    self._label_spec = (specs_lib.flatten_spec_structure(label_spec)
                        if label_spec is not None else specs_lib.SpecStruct())
    merged = specs_lib.SpecStruct()
    for key, spec in self._feature_spec.items():
      merged["features/" + key] = spec
    for key, spec in self._label_spec.items():
      merged["labels/" + key] = spec
    self._dataset_keys = specs_lib.dataset_keys(merged)
    self._plans: Dict[str, List[_LeafPlan]] = {}
    self._sequence_datasets: Dict[str, bool] = {}
    self._native_parsers: Dict[str, Any] = {}
    self._native_mismatch_streak: Dict[str, int] = {}
    self._native_mismatch_total: Dict[str, int] = {}
    self._native_batches_attempted: Dict[str, int] = {}
    for dkey in self._dataset_keys:
      subset = specs_lib.filter_by_dataset(merged, dkey)
      self._plans[dkey] = _plan_for(subset)
      # Two *incompatible* specs mapping to one wire key would silently
      # read the same feature; surface that at construction time.
      # Compatible duplicates are legal and intentional — e.g. MAML's
      # condition/ and inference/ subtrees both read the base feature.
      names: Dict[str, _LeafPlan] = {}
      for plan in self._plans[dkey]:
        other = names.get(plan.feature_name)
        if other is not None:
          compatible = (other.spec.shape == plan.spec.shape
                        and other.spec.dtype == plan.spec.dtype
                        and other.spec.is_sequence == plan.spec.is_sequence)
          if not compatible:
            raise ValueError(
                f"Specs {other.out_key!r} and {plan.out_key!r} both map to "
                f"wire feature {plan.feature_name!r} in dataset {dkey!r} "
                "with different shapes/dtypes; give them distinct names.")
          continue
        names[plan.feature_name] = plan
      self._sequence_datasets[dkey] = any(
          spec.is_sequence for spec in subset.values())
      self._native_parsers[dkey] = self._maybe_native_parser(
          self._plans[dkey])
      self._native_mismatch_streak[dkey] = 0
      self._native_mismatch_total[dkey] = 0
      self._native_batches_attempted[dkey] = 0

  def _maybe_native_parser(self, plans: List[_LeafPlan]):
    """Builds the C++ columnar parser when every leaf fits its profile:
    fixed-shape float/int features (context or fixed-T sequence),
    bytes/image features with a static value capacity (single images,
    multi-image lists, fixed-T image sequences), fixed-shape
    `is_extracted` raw planes (one contiguous single-copy batch
    buffer). Optionals, varlen, dynamic time dims, sequence/string
    extracted planes and string dtypes take the Python path."""
    if len({p.feature_name for p in plans}) != len(plans):
      # Duplicate wire names (e.g. MAML split subtrees): the native
      # name index is one-to-one, so take the Python path.
      return None
    native_plan = []
    for plan in plans:
      spec = plan.spec
      if spec.is_optional or spec.varlen_default_value is not None:
        return None
      if spec.is_extracted:
        # Pre-extracted raw planes: the wire value is a bytes blob. The
        # declared byte size makes the wrapper return the whole batch as
        # one contiguous buffer (single memmove per record) when every
        # record carries exactly one full-size value; planes split
        # across a few bytes values (cap 4, Python-path value-joining
        # parity) take the per-value path. Sequences, dynamic shapes and
        # non-numeric dtypes keep the Python path (frombuffer cannot
        # read strings/objects).
        if (spec.is_sequence or any(d is None for d in spec.shape)
            or plan.parse_dtype.kind in "SUO"
            or plan.parse_dtype.itemsize == 0):
          return None
        nbytes = (int(np.prod(spec.shape, dtype=np.int64))
                  * plan.parse_dtype.itemsize)
        native_plan.append(
            (plan.feature_name, native.KIND_BYTES, nbytes, False, 0,
             _EXTRACTED_VALUE_CAP))
        continue
      if spec.is_image:
        # Only the dims that size native buffers must be concrete: the
        # time dim for sequences and the leading N of multi-image lists.
        # H/W/C may stay dynamic (decode discovers them).
        if spec.is_sequence:
          if spec.shape[0] is None:
            return None  # dynamic time dim: python path
          cap = seq_len = int(spec.shape[0])
        elif len(spec.shape) >= 4:
          if spec.shape[0] is None:
            return None
          seq_len, cap = 0, int(spec.shape[0])  # [N, H, W, C] list
        else:
          seq_len, cap = 0, 1
        # Context images zero-fill when absent (empty string -> zeros,
        # as on the Python path);
        # missing sequence features are an error on both paths.
        missing_ok = not spec.is_sequence
        native_plan.append(
            (plan.feature_name, native.KIND_BYTES, 0, missing_ok, seq_len,
             cap))
        continue
      if any(d is None for d in spec.shape):
        return None  # dynamic dims (incl. dynamic time): python path
      seq_len = int(spec.shape[0]) if spec.is_sequence else 0
      step_shape = spec.shape[1:] if spec.is_sequence else spec.shape
      size = (int(np.prod(step_shape, dtype=np.int64))
              if step_shape else 1)
      if plan.parse_dtype == np.float32:
        native_plan.append(
            (plan.feature_name, native.KIND_FLOAT, size, False, seq_len, 0))
      elif np.issubdtype(plan.parse_dtype, np.integer):
        native_plan.append(
            (plan.feature_name, native.KIND_INT64, size, False, seq_len, 0))
      else:
        return None
    try:
      if not native.available():
        return None
      return native.BatchExampleParser(native_plan)
    except Exception:
      return None

  def _parse_batch_native(self, dkey: str,
                          serialized_list: Sequence[bytes]
                          ) -> Dict[str, np.ndarray]:
    """Fast path: columnar native parse producing full batch arrays."""
    parser = self._native_parsers[dkey]
    plans = self._plans[dkey]
    if hasattr(serialized_list, "arena"):
      # Staged arena batch (data/stager.py): the parser reads straight
      # out of the contiguous arena — no per-record bytes objects on
      # the whole records->parsed-batch path.
      parsed = parser.parse_arena(serialized_list.arena,
                                  serialized_list.offsets,
                                  serialized_list.lengths)
    else:
      parsed = parser.parse(list(serialized_list))
    batch = len(serialized_list)
    out: Dict[str, np.ndarray] = {}
    for i, plan in enumerate(plans):
      spec = plan.spec
      if spec.is_extracted:
        planes_buf = parsed["bytes_planes"].get(i)
        if planes_buf is not None:
          # Contiguous single-copy path: the wrapper already memmoved
          # each full-size plane into one [batch, nbytes] buffer —
          # viewing/reshaping here costs nothing further.
          out[plan.out_key] = planes_buf.view(plan.parse_dtype).reshape(
              (batch,) + tuple(spec.shape))
          continue
        counts = parsed["bytes_counts"][i]
        if int(counts.max(initial=0)) > _EXTRACTED_VALUE_CAP:
          # The native parser stored only the first CAP values; the
          # Python path joins any number, so re-parse there.
          raise _NativeFormatMismatch(plan.feature_name)
        planes = []
        for values in parsed["bytes"][i]:
          if not values:
            # No bytes_list on the wire: legacy writers stored numeric
            # planes as float_list/int64_list, which the columnar
            # parser cannot surface — re-parse on the Python path.
            raise _NativeFormatMismatch(plan.feature_name)
          # Python-path parity via the shared helper (multiple values
          # concatenate; single values read without a join copy).
          planes.append(_plane_from_values(values, plan))
        out[plan.out_key] = np.stack(planes)
        continue
      if spec.is_image and not spec.is_extracted:
        if spec.is_sequence:
          step_plan = _LeafPlan(plan.out_key, plan.feature_name,
                                spec.replace(shape=spec.shape[1:]),
                                plan.parse_dtype)
          t = spec.shape[0]
          flat = [v for values in parsed["bytes"][i] for v in values]
          decoded = _native_jpeg_batch(flat, step_plan)
          if decoded is not None:
            out[plan.out_key] = decoded.reshape(
                (batch, t) + decoded.shape[1:])
          else:
            out[plan.out_key] = np.stack([
                np.stack([_decode_image_feature([v], step_plan)
                          for v in values])
                for values in parsed["bytes"][i]])
          # Python-path parity: lengths report the full step count, even
          # when the stored data is clipped to the spec's time dim.
          out[plan.out_key + "_length"] = parsed["step_counts"][i]
        elif len(spec.shape) >= 4:
          # The native parser stores at most `cap` values; more values on
          # the wire than the spec's leading dim is a loud error (the
          # Python path would stack them all and fail shape validation).
          counts = parsed["bytes_counts"][i]
          if int(counts.max(initial=0)) > spec.shape[0]:
            raise ValueError(
                f"Feature {plan.feature_name!r} has {int(counts.max())} "
                f"bytes values but spec {plan.out_key!r} expects at most "
                f"{spec.shape[0]}.")
          out[plan.out_key] = np.stack(
              [_decode_image_feature(values, plan)
               for values in parsed["bytes"][i]])
        else:
          counts = parsed["bytes_counts"][i]
          if int(counts.max(initial=0)) > 1:
            raise ValueError(
                f"Feature {plan.feature_name!r} has {int(counts.max())} "
                f"bytes values but spec {plan.out_key!r} is a single "
                "image.")
          flat = [values[0] if values else b""
                  for values in parsed["bytes"][i]]
          decoded = _native_jpeg_batch(flat, plan)
          if decoded is not None:
            out[plan.out_key] = decoded
          else:
            out[plan.out_key] = np.stack(
                [_decode_image_feature(values[:1] or [b""], plan)
                 for values in parsed["bytes"][i]])
        continue
      buf = parsed["float"].get(i)
      if buf is None:
        buf = parsed["int"][i]
      out[plan.out_key] = buf.reshape((batch,) + spec.shape)
      if spec.is_sequence:
        out[plan.out_key + "_length"] = parsed["step_counts"][i]
    return out

  @property
  def dataset_keys(self) -> Tuple[str, ...]:
    return self._dataset_keys

  def parse_single(self, records: Union[bytes, Mapping[str, bytes]]
                   ) -> specs_lib.SpecStruct:
    """Parses one record (or one record per dataset_key)."""
    batch = self.parse_batch(
        {k: [v] for k, v in records.items()}
        if isinstance(records, Mapping) else [records])
    out = specs_lib.SpecStruct()
    for key, value in batch.items():
      out[key] = value[0] if value is not None else None
    return out

  def parse_batch(self,
                  records: Union[Sequence[bytes],
                                 Mapping[str, Sequence[bytes]]]
                  ) -> specs_lib.SpecStruct:
    """Parses a batch; returns `features/...` + `labels/...` SpecStruct.

    `records` (or any mapping value) may be a sequence of serialized
    records OR a `data.stager.StagedBatch` arena — the native columnar
    parser then reads records in place (`parse_arena`); fallback paths
    materialize per-record bytes first.
    """
    if not isinstance(records, Mapping):
      if len(self._dataset_keys) > 1:
        raise ValueError(
            f"Multi-dataset specs {self._dataset_keys} require a mapping of "
            "dataset_key -> records.")
      records = {self._dataset_keys[0]: records}
    columns: Dict[str, List[Any]] = {}
    lengths: Dict[str, List[int]] = {}
    batched: Dict[str, np.ndarray] = {}  # native fast-path outputs
    batch_sizes = {k: len(v) for k, v in records.items()}
    if len(set(batch_sizes.values())) > 1:
      raise ValueError(f"Dataset batch sizes differ: {batch_sizes}")
    for dkey, serialized_list in records.items():
      if self._native_parsers.get(dkey) is not None:
        attempted = self._native_batches_attempted.get(dkey, 0) + 1
        self._native_batches_attempted[dkey] = attempted
        try:
          batched.update(self._parse_batch_native(dkey, serialized_list))
          self._native_mismatch_streak[dkey] = 0
          continue
        except _NativeFormatMismatch as mismatch:
          # Legacy wire kind (e.g. float_list plane) or over-cap value
          # splits: the Python path parses any wire format. Only THIS
          # batch falls back — one anomalous record must not downgrade
          # the whole stream. Two disable triggers bound the wasted
          # native passes: _NATIVE_DISABLE_STREAK mismatches in a row
          # (the stream carries that format throughout) and the
          # _NATIVE_DISABLE_TOTAL + _NATIVE_DISABLE_RATIO pair (legacy
          # shards shuffle-merged with new-format ones, where good
          # batches keep resetting the streak; the ratio guard keeps a
          # long stream with RARE anomalies on the fast path forever).
          # Loud on first fallback and on disable, debug in between:
          # the Python path is orders of magnitude slower, and a silent
          # downgrade would be undiagnosable — but one warning per
          # mismatched batch would spam a multi-hour run.
          streak = self._native_mismatch_streak.get(dkey, 0) + 1
          self._native_mismatch_streak[dkey] = streak
          total = self._native_mismatch_total.get(dkey, 0) + 1
          self._native_mismatch_total[dkey] = total
          detail = (
              f"feature {mismatch} uses a wire format it cannot surface "
              "(legacy float_list/int64_list plane, or a plane split "
              f"across >{_EXTRACTED_VALUE_CAP} bytes values)")
          if (streak >= _NATIVE_DISABLE_STREAK
              or (total >= _NATIVE_DISABLE_TOTAL
                  and total >= _NATIVE_DISABLE_RATIO * attempted)):
            logging.warning(
                "Native columnar parser disabled for dataset %r: %s in "
                "%d consecutive / %d total batches. Falling back to the "
                "Python parser for the rest of this stream — expect much "
                "lower host throughput.", dkey, detail, streak, total)
            self._native_parsers[dkey] = None
          elif total == 1:
            logging.warning(
                "Native columnar parser fell back to the Python path for "
                "one batch of dataset %r: %s. The native path stays "
                "enabled; %d consecutive mismatches, or %d total at "
                ">=%d%% of attempted batches, disable it (further "
                "per-batch fallbacks log at debug).",
                dkey, detail, _NATIVE_DISABLE_STREAK,
                _NATIVE_DISABLE_TOTAL,
                int(_NATIVE_DISABLE_RATIO * 100))
          else:
            logging.debug(
                "Native parser per-batch fallback for dataset %r: %s "
                "(streak %d, total %d).", dkey, detail, streak, total)
      plans = self._plans[dkey]
      is_sequence = self._sequence_datasets[dkey]
      if hasattr(serialized_list, "records"):
        # Python path over a staged arena batch (no native parser for
        # these specs, or a format-mismatch fallback): materialize the
        # per-record bytes the proto walk below needs.
        serialized_list = serialized_list.records()
      for serialized in serialized_list:
        if is_sequence:
          context_features, feature_lists = (
              example_wire.decode_sequence_example(serialized))
        else:
          context_features = example_wire.decode_example(serialized)
          feature_lists = {}
        for plan in plans:
          if plan.spec.is_sequence:
            if plan.feature_name not in feature_lists:
              if plan.spec.is_optional:
                columns.setdefault(plan.out_key, []).append(None)
                continue
              raise ValueError(
                  f"Record missing sequence feature {plan.feature_name!r}.")
            steps = [
                _parse_leaf_from_feature(f, _LeafPlan(
                    plan.out_key, plan.feature_name,
                    plan.spec.replace(shape=plan.spec.shape[1:]),
                    plan.parse_dtype))
                for f in feature_lists[plan.feature_name]
            ]
            seq = np.stack(steps) if steps else np.zeros(
                (0,) + tuple(d or 0 for d in plan.spec.shape[1:]),
                dtype=plan.parse_dtype)
            columns.setdefault(plan.out_key, []).append(seq)
            lengths.setdefault(plan.out_key, []).append(len(steps))
          else:
            if plan.feature_name not in context_features:
              value = _parse_leaf_from_feature(
                  example_wire.Feature(), plan)  # missing-feature path
            else:
              value = _parse_leaf_from_feature(
                  context_features[plan.feature_name], plan)
            columns.setdefault(plan.out_key, []).append(value)

    out = specs_lib.SpecStruct()
    merged_specs = {**{f"features/{k}": v for k, v in
                       self._feature_spec.items()},
                    **{f"labels/{k}": v for k, v in self._label_spec.items()}}
    for out_key, array in batched.items():
      if out_key.endswith("_length") and out_key not in merged_specs:
        out[out_key] = array  # sequence length side outputs
      else:
        out[out_key] = self._maybe_cast(array, merged_specs[out_key])
    for out_key, values in columns.items():
      spec = merged_specs[out_key]
      if all(v is None for v in values):
        continue  # optional, absent everywhere
      if any(v is None for v in values):
        present = sum(1 for v in values if v is not None)
        raise ValueError(
            f"Optional feature {spec.name or out_key!r} ({out_key!r}) is "
            f"present in only {present}/{len(values)} records of the "
            "batch; optional features must be present batch-wide or "
            "absent batch-wide.")
      if spec.is_sequence:
        time_dim = spec.shape[0] if spec.shape and spec.shape[0] is not None \
            else None
        plan = next(p for p in self._plans[spec.dataset_key]
                    if p.out_key == out_key)
        array = _pad_time(values, time_dim, plan)
        out[out_key] = self._maybe_cast(array, spec)
        out[out_key + "_length"] = np.asarray(
            lengths[out_key], dtype=np.int64)
      else:
        array = np.stack(values)
        out[out_key] = self._maybe_cast(array, spec)
    return out

  def _maybe_cast(self, array: np.ndarray, spec: specs_lib.TensorSpec):
    if spec.dtype is torch.bfloat16:
      return torch.from_numpy(np.ascontiguousarray(array, np.float32)).to(
          torch.bfloat16)
    if array.dtype != spec.dtype and array.dtype.kind not in "SUO":
      return array.astype(spec.dtype)
    return array

  def __call__(self, records):
    return self.parse_batch(records)


def create_parse_fn(feature_spec: specs_lib.SpecStructLike,
                    label_spec: Optional[specs_lib.SpecStructLike] = None
                    ) -> ParseFn:
  """The parse function of a feature and a label spec structure."""
  return ParseFn(feature_spec, label_spec)
