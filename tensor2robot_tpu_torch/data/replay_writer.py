"""Replay writers: stream episode transitions to TFRecord files.

The port's copy of `tensor2robot_tpu.data.replay_writer`: actors write
collected transitions as Example records that the learner's record
input generators read back.
"""

from __future__ import annotations

from typing import Any, Sequence

from tensor2robot_tpu_torch.data import codec, tfrecord

__all__ = ["TFRecordReplayWriter"]


class TFRecordReplayWriter:
  """Writes transitions (flat dicts of numpy values) as Example records."""

  def __init__(self, path: str, spec_structure=None):
    self._writer = tfrecord.RecordWriter(path)
    self._spec_structure = spec_structure

  def write(self, transitions: Sequence[Any]) -> None:
    """Writes a list of transitions; each is either a flat mapping of
    values or pre-serialized bytes."""
    for transition in transitions:
      if isinstance(transition, bytes):
        self._writer.write(transition)
      else:
        self._writer.write(
            codec.encode_example(transition, self._spec_structure))

  def flush(self) -> None:
    self._writer.flush()

  def close(self) -> None:
    self._writer.close()

  def __enter__(self):
    return self

  def __exit__(self, *exc):
    self.close()
