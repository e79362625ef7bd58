"""The port's SavedModel: a `torch.export` program of the predict function.

Counterpart of the jax2tf SavedModel that the JAX package's
`DefaultExportGenerator(write_saved_model=True)` writes. A bundle's
`saved_model/` holds:

* `program.pt2`: `torch.export.save` of the eval-time predict function
  with the bundle's parameters and mutable state inside it. It takes the
  dense feeds of `filter_required(feature_spec)` positionally, in that
  order, each with a dynamic batch dimension, and returns the serving
  outputs as a dict of tensors. The preprocessor runs inside it when the
  export embeds it (`preprocessor_embedded`), and outside it otherwise.
  The flash attention forward is recorded as the operator
  `t2r::flash_fwd`: the CUDA kernel on the card, the plain version on the
  CPU. Loading needs that operator registered (`load_program` imports
  `ops.attention` first);
* `signature.json`: the inputs (feature key, feed name, dtype, shape,
  image channels), the output keys and `preprocessor_embedded`;
* `assets.extra/t2r_assets.pbtxt`: the bundle's specs, as beside it.

`tf_example_feeds` is the host side of the JAX package's tf_example
receiver: serialized `tf.train.Example`s in, the program's dense feeds
out (images decoded, lists reshaped and cast to their spec's dtype), so
the same protos give the same outputs as the dense feeds.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Mapping, Sequence

import numpy as np
import torch

from tensor2robot_tpu_torch import modes as modes_lib
from tensor2robot_tpu_torch import specs as specs_lib
from tensor2robot_tpu_torch.data import codec
from tensor2robot_tpu_torch.data import example_wire
from tensor2robot_tpu_torch.parallel import train_step as ts

__all__ = ["SAVED_MODEL_DIRNAME", "PROGRAM_FILENAME",
           "SAVED_MODEL_SIGNATURE", "write_saved_model", "load_program",
           "read_signature", "feed_name", "tf_example_feeds",
           "preprocess_is_traceable"]

SAVED_MODEL_DIRNAME = "saved_model"
PROGRAM_FILENAME = "program.pt2"
SAVED_MODEL_SIGNATURE = "signature.json"
# The batch of the example feeds the program is traced with. A batch of 1
# would specialise the dynamic dimension to 1.
EXAMPLE_BATCH = 2


def feed_name(key: str, spec: specs_lib.TensorSpec) -> str:
  """The serving feed name of a feature: its spec name, else the last
  part of its key."""
  return spec.name or key.rsplit("/", 1)[-1]


def _torch_dtype(dtype) -> torch.dtype:
  if dtype is torch.bfloat16:
    return dtype
  return torch.from_numpy(np.zeros((), np.dtype(dtype))).dtype


def preprocess_is_traceable(preprocessor) -> bool:
  """True when the PREDICT-mode preprocessor runs on fake tensors (torch
  ops only): it can then run inside the exported program. A preprocessor
  that computes on the host (numpy, PIL) fails on them."""
  from torch._subclasses.fake_tensor import FakeTensorMode

  try:
    in_spec = specs_lib.filter_required(
        preprocessor.get_in_feature_specification(modes_lib.PREDICT))
    with FakeTensorMode():
      features = specs_lib.SpecStruct({
          key: torch.zeros((EXAMPLE_BATCH,) + tuple(
              d if d is not None else 3 for d in spec.shape),
                           dtype=_torch_dtype(spec.dtype))
          for key, spec in in_spec.items()})
      preprocessor.preprocess(features, specs_lib.SpecStruct(),
                              modes_lib.PREDICT)
    return True
  except Exception:  # noqa: BLE001 - any failure means "not embeddable"
    return False


class _PredictProgram(torch.nn.Module):
  """The exported function: dense feeds -> serving outputs, with the
  eval-time parameters and mutable state as buffers."""

  def __init__(self, model, state: ts.TrainState, keys: Sequence[str],
               embed: bool):
    super().__init__()
    self._model = model
    self._keys = list(keys)
    self._embed = embed
    self._step = int(state.step)
    self._params = list(state.eval_params(use_ema=True))
    self._mutable = list(state.mutable_state)
    for prefix, names, tree in (
        ("param", self._params, state.eval_params(use_ema=True)),
        ("mutable", self._mutable, state.mutable_state)):
      for i, name in enumerate(names):
        self.register_buffer(f"{prefix}_{i}", tree[name].detach())

  def forward(self, *arrays):
    features = specs_lib.SpecStruct(dict(zip(self._keys, arrays)))
    if self._embed:
      features, _ = self._model.preprocessor.preprocess(
          features, specs_lib.SpecStruct(), modes_lib.PREDICT)
    state = ts.TrainState(
        step=self._step,
        params={n: getattr(self, f"param_{i}")
                for i, n in enumerate(self._params)},
        mutable_state={n: getattr(self, f"mutable_{i}")
                       for i, n in enumerate(self._mutable)})
    outputs = ts.eval_outputs(self._model, state, features,
                              modes_lib.PREDICT, use_ema=False)
    return dict(self._model.create_export_outputs_fn(features, outputs))


def write_saved_model(model, state: ts.TrainState,
                      feature_spec: specs_lib.SpecStruct, embed: bool,
                      directory: str) -> Dict[str, Any]:
  """Exports the predict function of `model` on `state` into `directory`
  (module docstring); returns the signature it wrote. The program is
  traced on the state's device with example feeds of `EXAMPLE_BATCH`
  rows."""
  flat_spec = specs_lib.filter_required(feature_spec)
  keys = list(flat_spec.keys())
  device = next(iter(state.params.values())).device
  sample = specs_lib.make_random_numpy(flat_spec, batch_size=EXAMPLE_BATCH,
                                       seed=0)
  args = tuple(torch.as_tensor(np.asarray(sample[k]), device=device)
               for k in keys)
  batch = torch.export.Dim("batch", min=1)
  program = torch.export.export(
      _PredictProgram(model, state, keys, embed), args,
      dynamic_shapes=(tuple({0: batch} for _ in keys),), strict=False)
  os.makedirs(directory, exist_ok=True)
  torch.export.save(program, os.path.join(directory, PROGRAM_FILENAME))
  with torch.no_grad():
    outputs = program.module()(*args)
  signature = {
      "format": "torch.export",
      "program": PROGRAM_FILENAME,
      "inputs": [{"key": k, "name": feed_name(k, flat_spec[k]),
                  "dtype": specs_lib._dtype_name(flat_spec[k].dtype),
                  "shape": [d for d in flat_spec[k].shape],
                  "is_image": bool(flat_spec[k].is_image)} for k in keys],
      "outputs": sorted(outputs),
      "preprocessor_embedded": bool(embed),
      "global_step": int(state.step),
  }
  with open(os.path.join(directory, SAVED_MODEL_SIGNATURE), "w") as f:
    json.dump(signature, f, indent=2)
  return signature


def read_signature(directory: str) -> Dict[str, Any]:
  with open(os.path.join(directory, SAVED_MODEL_SIGNATURE)) as f:
    return json.load(f)


def load_program(directory: str, device: torch.device):
  """The exported program of `directory` as a callable module on
  `device`."""
  from torch.export import passes

  from tensor2robot_tpu_torch.ops import attention  # noqa: F401 - t2r ops

  program = torch.export.load(os.path.join(directory, PROGRAM_FILENAME))
  program = passes.move_to_device_pass(program, device)
  return program.module()


def tf_example_feeds(serialized: Sequence[bytes],
                     inputs: Sequence[Mapping[str, Any]]
                     ) -> List[np.ndarray]:
  """Serialized Examples -> the program's dense feeds, in the order of
  `inputs` (the signature's). Each feature is read under its feed name:
  an image as one encoded string decoded to its spec's channels, an
  integer feature as an int64 list, any other as a float list, each
  reshaped to [-1] + shape and cast to the spec's dtype."""
  examples = [example_wire.decode_example(bytes(s)) for s in serialized]
  feeds = []
  for spec in inputs:
    shape = [int(d) for d in spec["shape"]]
    if spec["is_image"]:
      values = np.stack([
          codec.decode_image(ex[spec["name"]].value[0],
                             channels=shape[-1]) for ex in examples])
    else:
      values = np.asarray([list(ex[spec["name"]].value) for ex in examples])
    feeds.append(values.reshape([-1] + shape).astype(spec["dtype"]))
  return feeds
