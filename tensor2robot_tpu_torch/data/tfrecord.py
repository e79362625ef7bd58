"""TFRecord container IO without TensorFlow.

The port's copy of `tensor2robot_tpu.data.tfrecord`: length-prefixed
records with masked CRC32C checksums, written and read directly, the
native reader (`native/tfrecord_io.cc`) first and a pure-Python reader
where the library cannot be built. Files written by either package read
back in the other.

Record layout (the public TFRecord framing):
  uint64 length
  uint32 masked_crc32c(length)
  bytes  data[length]
  uint32 masked_crc32c(data)
"""

from __future__ import annotations

import os
import struct
from typing import Iterator, List

import numpy as np

from tensor2robot_tpu_torch import native

__all__ = ["RecordWriter", "read_records", "iter_records", "count_records"]

# Records larger than this are corruption, as in the native reader
# (`native/record_framing.h` kMaxRecordBytes): a garbage length prefix
# raises IOError on both paths.
_MAX_RECORD_BYTES = 1 << 31

# -- CRC32C (Castagnoli), slicing-by-8 --------------------------------------
# The native library is the fast path; this runs where it cannot be
# built. Eight derived tables fold 8 input bytes per iteration, with
# numpy reading the payload as little-endian uint64 words.

_CRC_TABLES = None


def _crc_tables() -> List[List[int]]:
  global _CRC_TABLES
  if _CRC_TABLES is None:
    poly = np.uint64(0x82F63B78)
    table = np.arange(256, dtype=np.uint64)
    for _ in range(8):
      table = (table >> np.uint64(1)) ^ (poly * (table & np.uint64(1)))
    tables = [table]
    # tables[k][b] = tables[0][tables[k-1][b] & 0xFF] ^ (tables[k-1][b] >> 8)
    for _ in range(7):
      prev = tables[-1]
      tables.append(tables[0][(prev & np.uint64(0xFF)).astype(np.int64)]
                    ^ (prev >> np.uint64(8)))
    _CRC_TABLES = [t.tolist() for t in tables]
  return _CRC_TABLES


def _crc32c(data: bytes) -> int:
  t0, t1, t2, t3, t4, t5, t6, t7 = _crc_tables()
  crc = 0xFFFFFFFF
  n_words = len(data) // 8
  if n_words:
    words = np.frombuffer(data, dtype="<u8", count=n_words)
    for word in words.tolist():
      word ^= crc
      crc = (t7[word & 0xFF] ^ t6[(word >> 8) & 0xFF]
             ^ t5[(word >> 16) & 0xFF] ^ t4[(word >> 24) & 0xFF]
             ^ t3[(word >> 32) & 0xFF] ^ t2[(word >> 40) & 0xFF]
             ^ t1[(word >> 48) & 0xFF] ^ t0[word >> 56])
  for byte in data[n_words * 8:]:
    crc = t0[(crc ^ byte) & 0xFF] ^ (crc >> 8)
  return crc ^ 0xFFFFFFFF


def _mask(crc: int) -> int:
  return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
  value = native.masked_crc32c(data)
  return value if value is not None else _mask(_crc32c(data))


class RecordWriter:
  """Writes one TFRecord file."""

  def __init__(self, path: str):
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    self._file = open(path, "wb")

  def write(self, record: bytes) -> None:
    length = struct.pack("<Q", len(record))
    self._file.write(length)
    self._file.write(struct.pack("<I", _masked_crc(length)))
    self._file.write(record)
    self._file.write(struct.pack("<I", _masked_crc(record)))

  def flush(self) -> None:
    self._file.flush()

  def close(self) -> None:
    self._file.close()

  def __enter__(self) -> "RecordWriter":
    return self

  def __exit__(self, *exc) -> None:
    self.close()


def _read_header(f, path: str):
  """The next record's length, or None at a clean end of file."""
  header = f.read(12)
  if not header:
    return None, header
  if len(header) < 12:
    raise IOError(f"Truncated record header in {path}")
  (length,) = struct.unpack("<Q", header[:8])
  if length > _MAX_RECORD_BYTES:
    raise IOError(f"Implausible record length in {path} (corrupt file?)")
  return length, header


def iter_python_records(path: str, verify_crc: bool = False
                        ) -> Iterator[bytes]:
  """Streams records from one file with the pure-Python reader."""
  with open(path, "rb") as f:
    while True:
      length, header = _read_header(f, path)
      if length is None:
        return
      if verify_crc:
        (expected,) = struct.unpack("<I", header[8:12])
        if _masked_crc(header[:8]) != expected:
          raise IOError(f"Corrupt length CRC in {path}")
      data = f.read(length)
      if len(data) < length:
        raise IOError(f"Truncated record body in {path}")
      footer = f.read(4)
      if len(footer) < 4:
        raise IOError(f"Truncated record footer in {path}")
      if verify_crc:
        (expected,) = struct.unpack("<I", footer)
        if _masked_crc(data) != expected:
          raise IOError(f"Corrupt data CRC in {path}")
      yield data


def iter_records(path: str, verify_crc: bool = False) -> Iterator[bytes]:
  """Streams records from one file: the native reader where the library
  is built, the Python reader otherwise."""
  if native.available():
    yield from native.iter_records_native(path, verify_crc=verify_crc)
  else:
    yield from iter_python_records(path, verify_crc=verify_crc)


def read_records(path: str, verify_crc: bool = False) -> List[bytes]:
  return list(iter_records(path, verify_crc=verify_crc))


def count_records(path: str) -> int:
  """Counts records by seeking over bodies (no payload reads)."""
  n = 0
  with open(path, "rb") as f:
    while True:
      length, _ = _read_header(f, path)
      if length is None:
        return n
      f.seek(length + 4, os.SEEK_CUR)
      n += 1
