"""Converter: legacy pickled feature/label specs -> the port's asset
sidecar (counterpart of `tensor2robot_tpu.utils.convert_pkl_assets`).

A pickle holds {'feature_spec': ..., 'label_spec': ...}, each a (nested)
mapping whose leaves are `TensorSpec`s or legacy `(shape, dtype[, name])`
tuples.
"""

from __future__ import annotations

import pickle

from tensor2robot_tpu_torch import specs as specs_lib

__all__ = ["convert_pickle_assets"]


def _to_spec_struct(obj) -> specs_lib.SpecStruct:
  out = specs_lib.SpecStruct()
  for key, value in specs_lib.flatten_spec_structure(dict(obj)).items():
    if isinstance(value, specs_lib.TensorSpec):
      out[key] = value
    else:  # (shape, dtype[, name]) tuples
      shape, dtype = value[0], value[1]
      name = value[2] if len(value) > 2 else None
      out[key] = specs_lib.TensorSpec(shape=tuple(shape), dtype=dtype,
                                      name=name)
  return out


def convert_pickle_assets(pickle_path: str, output_path: str,
                          global_step: int = 0) -> specs_lib.Assets:
  """Reads the pickle at `pickle_path`, writes the JSON asset file at
  `output_path` and returns the `Assets`."""
  with open(pickle_path, "rb") as f:
    payload = pickle.load(f)
  assets = specs_lib.Assets(
      feature_spec=_to_spec_struct(payload["feature_spec"]),
      label_spec=_to_spec_struct(payload.get("label_spec", {})),
      global_step=global_step)
  specs_lib.write_assets(assets, output_path)
  return assets
