"""MetaExample record construction: merge episode Examples under
`<prefix>_ep<i>/` key prefixes.

Counterpart of `tensor2robot_tpu.meta_learning.meta_example`, on the
port's pure-Python wire format (`data/example_wire.py`) in place of
`example_pb2`: a MetaExample is one record carrying N condition episodes
and M inference episodes, each episode's features renamed with its split
and index, so `FixedLenMetaExamplePreprocessor` can restack them. The
bytes are protobuf's deterministic serialization of the JAX package's
MetaExample.
"""

from __future__ import annotations

from typing import Dict, Sequence

from tensor2robot_tpu_torch.data import example_wire

__all__ = ["make_meta_example"]


def _merge_with_prefix(target: Dict[str, example_wire.Feature],
                       source_bytes: bytes, prefix: str) -> None:
  for name, feature in example_wire.decode_example(source_bytes).items():
    target[f"{prefix}/{name}"] = feature


def make_meta_example(condition_examples: Sequence[bytes],
                      inference_examples: Sequence[bytes]) -> bytes:
  """Merges serialized episode Examples into one serialized MetaExample."""
  merged: Dict[str, example_wire.Feature] = {}
  for i, episode in enumerate(condition_examples):
    _merge_with_prefix(merged, episode, f"condition_ep{i}")
  for i, episode in enumerate(inference_examples):
    _merge_with_prefix(merged, episode, f"inference_ep{i}")
  return example_wire.encode_example(merged)
