"""The port's native (C++) data plane, built with g++ and loaded by ctypes.

The port's own copy of the JAX package's native sources, beside this
file: `tfrecord_io.cc` (record reader and CRC32C), `example_parser.cc`
(columnar Example parser), `batch_stager.cc` (GIL-free interleave,
shuffle and batch assembly on C++ threads), `jpeg_decode.cc` (batched
libjpeg decode on a thread pool) and `record_framing.h`.

The shared library is built on first use into `tensor2robot_tpu_torch/
_build/t2r_native-<hash>.so`, the hash covering every source and the
flags, so an edited source is never served from a stale library. The
build writes a temporary file and `os.replace`s it into place under a
file lock, so processes that build at once (test workers) all load one
finished library. Where libjpeg's headers or library are missing the
build is made again without `jpeg_decode.cc`: the reader, parser and
stager do not depend on it, and `has_jpeg()` says which build loaded.

What happened is visible: `available()`, `has_jpeg()`, `build_log()`
(g++'s output of each attempt this process made), and `counters`, the
calls of each entry point: batches the stager staged
(`stager_batches`), batches the columnar parser parsed
(`parser_batches`) and images the native decoder decoded
(`jpeg_images`). Nothing is built or loaded at import.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import pathlib
import subprocess
import threading
from typing import Iterator, List, Optional

import numpy as np

__all__ = ["available", "has_jpeg", "build_log", "library_path", "counters",
           "masked_crc32c", "iter_records_native", "decode_jpeg_batch",
           "RecordStager", "BatchExampleParser", "KIND_FLOAT", "KIND_INT64",
           "KIND_BYTES"]

_DIR = pathlib.Path(__file__).resolve().parent
BUILD_DIR = _DIR.parent / "_build"
_SOURCES = ("tfrecord_io.cc", "example_parser.cc", "batch_stager.cc")
_JPEG_SOURCE = "jpeg_decode.cc"
_HEADERS = ("record_framing.h",)
_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
_BUILD_TIMEOUT_S = 300

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_load_failed = False
_build_log: List[str] = []


class Counters:
  """Calls of each native entry point since the last `reset()`; each
  wrapper adds to its count where it calls its entry and nowhere else."""

  _NAMES = ("stager_batches", "parser_batches", "jpeg_images")

  def __init__(self):
    self._lock = threading.Lock()
    self.reset()

  def reset(self) -> None:
    with self._lock:
      for name in self._NAMES:
        setattr(self, name, 0)

  def add(self, name: str, n: int = 1) -> None:
    with self._lock:
      setattr(self, name, getattr(self, name) + n)

  def as_dict(self) -> dict:
    with self._lock:
      return {name: getattr(self, name) for name in self._NAMES}


counters = Counters()


def library_path() -> pathlib.Path:
  """The library's path, named by a hash of every source, header and
  flag."""
  digest = hashlib.sha256(" ".join(_FLAGS).encode())
  for name in (*_SOURCES, _JPEG_SOURCE, *_HEADERS):
    digest.update(name.encode() + b"\0" + (_DIR / name).read_bytes())
  return BUILD_DIR / f"t2r_native-{digest.hexdigest()[:12]}.so"


def _build(path: pathlib.Path) -> bool:
  """g++ into a temporary file, then `os.replace` into `path`: with
  libjpeg first, without it if that fails. Records g++'s output."""
  sources = [str(_DIR / s) for s in _SOURCES]
  tmp = path.with_suffix(f".{os.getpid()}.tmp")
  # -lpthread in both: the stager and the decoder start std::threads.
  attempts = (
      ("with libjpeg", [*sources, str(_DIR / _JPEG_SOURCE), "-ljpeg"]),
      ("without libjpeg", sources))
  for label, inputs in attempts:
    cmd = ["g++", *_FLAGS, *inputs, "-o", str(tmp), "-lpthread"]
    try:
      proc = subprocess.run(cmd, capture_output=True, text=True,
                            timeout=_BUILD_TIMEOUT_S)
    except (OSError, subprocess.TimeoutExpired) as e:
      _build_log.append(f"[{label}] {' '.join(cmd)}\n{e}")
      continue
    _build_log.append(f"[{label}] {' '.join(cmd)} -> exit "
                      f"{proc.returncode}\n{proc.stdout}{proc.stderr}")
    if proc.returncode == 0:
      os.replace(tmp, path)
      return True
  tmp.unlink(missing_ok=True)
  return False


def _build_locked(path: pathlib.Path, force: Optional[str]) -> bool:
  """`_build(path)` under the build directory's file lock. Unless
  `force`, a library another process finished while this one waited is
  taken as it is."""
  BUILD_DIR.mkdir(parents=True, exist_ok=True)
  with open(path.with_suffix(".lock"), "w") as lock_file:
    fcntl.flock(lock_file, fcntl.LOCK_EX)
    try:
      return (not force and path.is_file()) or _build(path)
    finally:
      fcntl.flock(lock_file, fcntl.LOCK_UN)


def _declare(lib: ctypes.CDLL) -> None:
  c = ctypes
  sigs = {
      "t2r_crc32c": (c.c_uint32, [c.c_char_p, c.c_int64]),
      "t2r_masked_crc32c": (c.c_uint32, [c.c_char_p, c.c_int64]),
      "t2r_reader_open": (c.c_void_p, [c.c_char_p, c.c_int]),
      "t2r_reader_close": (None, [c.c_void_p]),
      "t2r_reader_next_batch": (c.c_int64, [c.c_void_p, c.c_int64]),
      "t2r_reader_data": (c.POINTER(c.c_uint8), [c.c_void_p]),
      "t2r_reader_offsets": (c.POINTER(c.c_int64), [c.c_void_p]),
      "t2r_reader_lengths": (c.POINTER(c.c_int64), [c.c_void_p]),
      "t2r_reader_error": (c.c_char_p, [c.c_void_p]),
      "t2r_parser_create": (c.c_void_p, [
          c.POINTER(c.c_char_p), c.POINTER(c.c_int), c.POINTER(c.c_int64),
          c.POINTER(c.c_int64), c.POINTER(c.c_int64), c.c_int]),
      "t2r_parser_destroy": (None, [c.c_void_p]),
      "t2r_parser_error": (c.c_char_p, [c.c_void_p]),
      "t2r_parser_bytes_ptrs": (c.POINTER(c.c_void_p), [c.c_void_p]),
      "t2r_parser_bytes_lens": (c.POINTER(c.c_int64), [c.c_void_p]),
      "t2r_parser_bytes_counts": (c.POINTER(c.c_int64), [c.c_void_p]),
      "t2r_parser_step_counts": (c.POINTER(c.c_int64), [c.c_void_p]),
      "t2r_parser_parse_batch": (c.c_int, [
          c.c_void_p, c.POINTER(c.c_char_p), c.POINTER(c.c_int64),
          c.c_int64, c.POINTER(c.c_void_p), c.POINTER(c.c_void_p),
          c.POINTER(c.c_uint8)]),
      "t2r_parser_gather_plane": (c.c_int, [
          c.c_void_p, c.c_int, c.c_int64, c.POINTER(c.c_uint8)]),
      "t2r_stager_open": (c.c_void_p, [
          c.POINTER(c.c_char_p), c.c_int64, c.c_int64, c.c_int64,
          c.c_uint64, c.c_int64, c.c_int, c.c_int, c.c_int64, c.c_int64]),
      "t2r_stager_next_batch": (c.c_void_p, [c.c_void_p]),
      "t2r_stager_error": (c.c_char_p, [c.c_void_p]),
      "t2r_stager_queue_depth": (c.c_int64, [c.c_void_p]),
      "t2r_stager_close": (None, [c.c_void_p]),
      "t2r_staged_count": (c.c_int64, [c.c_void_p]),
      "t2r_staged_data": (c.POINTER(c.c_uint8), [c.c_void_p]),
      "t2r_staged_offsets": (c.POINTER(c.c_int64), [c.c_void_p]),
      "t2r_staged_lengths": (c.POINTER(c.c_int64), [c.c_void_p]),
      "t2r_staged_arena_bytes": (c.c_int64, [c.c_void_p]),
      "t2r_staged_free": (None, [c.c_void_p]),
  }
  if hasattr(lib, "t2r_decode_jpeg_batch"):  # the libjpeg build
    sigs["t2r_decode_jpeg_batch"] = (c.c_int, [
        c.POINTER(c.c_char_p), c.POINTER(c.c_int64), c.c_int64,
        c.POINTER(c.c_uint8), c.c_int64, c.c_int64, c.c_int64, c.c_int])
  for name, (restype, argtypes) in sigs.items():
    fn = getattr(lib, name)
    fn.restype = restype
    fn.argtypes = argtypes


def load() -> Optional[ctypes.CDLL]:
  """The native library, built first if needed; None where it cannot
  be built or loaded (`build_log()` says why)."""
  global _lib, _load_failed
  with _lock:
    if _lib is not None or _load_failed:
      return _lib
    path = library_path()
    lib = None
    for stale in (None, "rebuild"):
      if (stale or not path.is_file()) and not _build_locked(path, stale):
        break
      try:
        lib = ctypes.CDLL(str(path))
        break
      except OSError as e:
        # A library built on another machine (a copied tree) may link a
        # libjpeg this one lacks: build it here once more.
        _build_log.append(f"[load] {path}: {e}")
    if lib is None:
      _load_failed = True
      return None
    _declare(lib)
    _lib = lib
    return _lib


def available() -> bool:
  return load() is not None


def has_jpeg() -> bool:
  """True when the loaded library carries the libjpeg batch decoder."""
  lib = load()
  return lib is not None and hasattr(lib, "t2r_decode_jpeg_batch")


def build_log() -> str:
  """g++'s output of each build attempt this process made ('' when the
  library was already built)."""
  return "\n".join(_build_log)


def masked_crc32c(data: bytes) -> Optional[int]:
  lib = load()
  if lib is None:
    return None
  return lib.t2r_masked_crc32c(data, len(data))


def iter_records_native(path: str, verify_crc: bool = False,
                        batch_records: int = 256) -> Iterator[bytes]:
  """Streams records via the native reader; raises IOError on corruption."""
  lib = load()
  if lib is None:
    raise RuntimeError("native library unavailable:\n" + build_log())
  handle = lib.t2r_reader_open(path.encode(), int(verify_crc))
  if not handle:
    raise IOError(f"Cannot open {path}")
  try:
    while True:
      n = lib.t2r_reader_next_batch(handle, batch_records)
      if n < 0:
        error = lib.t2r_reader_error(handle).decode()
        raise IOError(f"Corrupt TFRecord file {path}: {error}")
      if n == 0:
        return
      data = lib.t2r_reader_data(handle)
      offsets = lib.t2r_reader_offsets(handle)
      lengths = lib.t2r_reader_lengths(handle)
      for i in range(n):
        yield ctypes.string_at(
            ctypes.addressof(data.contents) + offsets[i], lengths[i])
  finally:
    lib.t2r_reader_close(handle)


def decode_jpeg_batch(datas, height: int, width: int, channels: int,
                      num_threads: int = 0,
                      out: Optional[np.ndarray] = None
                      ) -> Optional[np.ndarray]:
  """GIL-free batched JPEG decode to a uint8 [N, H, W, C] array, into
  `out` when the caller gives one (C-contiguous uint8 of that shape).

  Returns None when there is no libjpeg build, or when any image of the
  batch does not decode to exactly (height, width, channels): the caller
  then takes the PIL path for the whole batch.
  """
  lib = load()
  if lib is None or not hasattr(lib, "t2r_decode_jpeg_batch"):
    return None
  datas = list(datas)
  n = len(datas)
  shape = (n, height, width, channels)
  if out is None:
    out = np.empty(shape, np.uint8)
  elif (out.shape != shape or out.dtype != np.uint8
        or not out.flags.c_contiguous):
    raise ValueError(f"out must be C-contiguous uint8 {shape}, got "
                     f"{out.dtype} {out.shape}")
  if n == 0:
    return out
  if any(not d for d in datas):
    return None  # empty payloads take the Python zeros path
  arr = (ctypes.c_char_p * n)(*datas)
  lens = (ctypes.c_int64 * n)(*[len(d) for d in datas])
  counters.add("jpeg_images", n)
  status = lib.t2r_decode_jpeg_batch(
      arr, lens, n, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
      height, width, channels, num_threads)
  return out if status == 0 else None


class RecordStager:
  """Handle on the C++ batched record stager (one epoch).

  Staging (file interleave, reservoir shuffle, batch assembly) starts on
  C++ threads at construction; `next_batch()` blocks until a batch is
  staged and returns `(arena, offsets, lengths)` numpy arrays (the arena
  copied out of the native buffer in one memcpy and owned by Python), or
  None at end of stream. Corruption raises IOError, as both
  `iter_records` paths do. `close()` (or `with`) stops and joins the
  C++ threads.
  """

  def __init__(self, paths: List[str], batch_size: int,
               cycle_length: int = 4, shuffle_buffer: int = 0,
               seed: int = 0, drop_remainder: bool = True,
               verify_crc: bool = False, queue_depth: int = 2,
               max_chunk_bytes: int = 0):
    # max_chunk_bytes > 0 byte-bounds the C++ reader queues and flushes
    # batches early at that arena size: record-mode streaming only (an
    # early flush breaks exact batch_size semantics); 0 = off.
    self._handle = None
    lib = load()
    if lib is None:
      raise RuntimeError("native library unavailable:\n" + build_log())
    if not paths:
      raise ValueError("RecordStager needs at least one file")
    self._lib = lib
    encoded = [p.encode() for p in paths]
    path_array = (ctypes.c_char_p * len(encoded))(*encoded)
    self._handle = lib.t2r_stager_open(
        path_array, len(encoded), cycle_length, shuffle_buffer,
        ctypes.c_uint64(seed & (2**64 - 1)), batch_size,
        int(drop_remainder), int(verify_crc), queue_depth,
        max_chunk_bytes)
    if not self._handle:
      raise ValueError("invalid stager configuration")

  def next_batch(self):
    """(arena uint8[bytes], offsets int64[n], lengths int64[n]) or None."""
    lib = self._lib
    if self._handle is None:
      return None
    batch = lib.t2r_stager_next_batch(self._handle)
    if not batch:
      error = lib.t2r_stager_error(self._handle).decode()
      if error:
        raise IOError(f"Corrupt TFRecord stream: {error}")
      return None
    counters.add("stager_batches")
    try:
      n = lib.t2r_staged_count(batch)
      nbytes = lib.t2r_staged_arena_bytes(batch)
      arena = np.empty((nbytes,), np.uint8)
      if nbytes:
        ctypes.memmove(arena.ctypes.data, lib.t2r_staged_data(batch),
                       nbytes)
      offsets = np.ctypeslib.as_array(lib.t2r_staged_offsets(batch),
                                      (n,)).copy()
      lengths = np.ctypeslib.as_array(lib.t2r_staged_lengths(batch),
                                      (n,)).copy()
      return arena, offsets, lengths
    finally:
      lib.t2r_staged_free(batch)

  def queue_depth(self) -> int:
    """Staged batches waiting for the consumer."""
    if self._handle is None:
      return 0
    return int(self._lib.t2r_stager_queue_depth(self._handle))

  def close(self) -> None:
    if self._handle:
      self._lib.t2r_stager_close(self._handle)
      self._handle = None

  def __enter__(self) -> "RecordStager":
    return self

  def __exit__(self, *exc) -> None:
    self.close()

  def __del__(self):
    self.close()


KIND_FLOAT, KIND_INT64, KIND_BYTES = 0, 1, 2


class BatchExampleParser:
  """Columnar batched Example/SequenceExample parsing (native library).

  Plan: a list of (name, kind, size, missing_ok, seq_len, cap) tuples —
  `seq_len` 0 for context features or the fixed time dim for
  SequenceExample feature lists (short sequences zero-pad, long ones
  clip); `cap` is the stored value capacity for bytes features (1 for a
  single image, N for multi-image lists, == seq_len for image
  sequences). For context bytes, `size` > 0 declares a fixed-size raw
  plane: when every record carries exactly one value of that byte
  length, the batch comes back as one contiguous [batch, size] uint8
  buffer filled by a single `t2r_parser_gather_plane` call; otherwise
  the entry falls back to per-record value lists.

  `parse` returns a dict:
    float/int: {plan index: np array [batch, size] or [batch, T, size]},
    bytes:     {plan index: per-record lists of bytes values, or None
                when bytes_planes took the entry},
    bytes_planes: {plan index: contiguous uint8 [batch, size] or None},
    bytes_counts / step_counts: {plan index: np.int64 [batch]}.
  """

  def __init__(self, plan):
    self._handle = None
    lib = load()
    if lib is None:
      raise RuntimeError("native library unavailable:\n" + build_log())
    self._lib = lib
    # The C++ plan stores per-call results (bytes pointer and length
    # vectors), so concurrent parse() calls on one parser serialize.
    self._parse_lock = threading.Lock()
    self._plan = [tuple(entry) for entry in plan]
    n = len(self._plan)
    names = (ctypes.c_char_p * n)(*[e[0].encode() for e in self._plan])
    kinds = (ctypes.c_int * n)(*[e[1] for e in self._plan])
    sizes = (ctypes.c_int64 * n)(*[e[2] for e in self._plan])
    seq_lens = (ctypes.c_int64 * n)(*[e[4] for e in self._plan])
    self._caps = [max(1, e[5]) if e[1] == KIND_BYTES else 0
                  for e in self._plan]
    caps = (ctypes.c_int64 * n)(*self._caps)
    self._missing_ok = (ctypes.c_uint8 * n)(
        *[1 if e[3] else 0 for e in self._plan])
    self._caps_offset = []
    total = 0
    for cap in self._caps:
      self._caps_offset.append(total if cap else -1)
      total += cap
    self._total_caps = total
    self._num_bytes = sum(1 for cap in self._caps if cap)
    self._num_seq = sum(1 for e in self._plan if e[4] > 0)
    self._handle = lib.t2r_parser_create(names, kinds, sizes, seq_lens,
                                         caps, n)

  def __del__(self):
    if self._handle:
      self._lib.t2r_parser_destroy(self._handle)
      self._handle = None

  def parse(self, records):
    batch = len(records)
    rec_array = (ctypes.c_char_p * batch)(*records)
    len_array = (ctypes.c_int64 * batch)(*[len(r) for r in records])
    with self._parse_lock:
      return self._parse_ptrs(rec_array, len_array, batch)

  def parse_arena(self, arena, offsets, lengths):
    """Parses records living in one contiguous uint8 arena at
    `offsets`/`lengths` (the stager's batch layout), with no per-record
    bytes objects. The arena must stay alive for the call."""
    base = arena.ctypes.data
    batch = len(offsets)
    ptr_array = (ctypes.c_void_p * batch)(
        *[base + o for o in offsets.tolist()])
    rec_array = ctypes.cast(ptr_array, ctypes.POINTER(ctypes.c_char_p))
    len_array = (ctypes.c_int64 * batch)(*lengths.tolist())
    with self._parse_lock:
      return self._parse_ptrs(rec_array, len_array, batch)

  def _parse_ptrs(self, rec_array, len_array, batch):
    n = len(self._plan)
    float_outs = (ctypes.c_void_p * n)()
    int_outs = (ctypes.c_void_p * n)()
    out = {"float": {}, "int": {}, "bytes": {}, "bytes_planes": {},
           "bytes_counts": {}, "step_counts": {}}
    for i, (_, kind, size, _, seq_len, _) in enumerate(self._plan):
      shape = (batch, seq_len, size) if seq_len > 0 else (batch, size)
      if kind == KIND_FLOAT:
        buf = np.zeros(shape, np.float32)
        out["float"][i] = buf
        float_outs[i] = buf.ctypes.data_as(ctypes.c_void_p)
      elif kind == KIND_INT64:
        buf = np.zeros(shape, np.int64)
        out["int"][i] = buf
        int_outs[i] = buf.ctypes.data_as(ctypes.c_void_p)
    counters.add("parser_batches")
    status = self._lib.t2r_parser_parse_batch(
        self._handle, rec_array, len_array, batch, float_outs, int_outs,
        self._missing_ok)
    if status != 0:
      raise ValueError(
          "native example parse failed: "
          + self._lib.t2r_parser_error(self._handle).decode())
    if self._num_bytes:
      ptrs = self._lib.t2r_parser_bytes_ptrs(self._handle)
      lens = self._lib.t2r_parser_bytes_lens(self._handle)
      counts = self._lib.t2r_parser_bytes_counts(self._handle)
      slot = 0
      for i, (_, kind, size, _, seq_len, _) in enumerate(self._plan):
        if kind != KIND_BYTES:
          continue
        cap, offset = self._caps[i], self._caps_offset[i]
        if size > 0 and seq_len == 0:
          # Raw planes: when every record has exactly one value of the
          # declared byte length, one gather copies them all into one
          # buffer. A null-destination probe first, so a stream that
          # never qualifies does not allocate a buffer per batch.
          status = self._lib.t2r_parser_gather_plane(
              self._handle, i, batch, None)
          if status == 1:
            dest = np.empty((batch, size), np.uint8)
            status = self._lib.t2r_parser_gather_plane(
                self._handle, i, batch,
                dest.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
          if status == 1:
            out["bytes_planes"][i] = dest
            out["bytes"][i] = None
            out["bytes_counts"][i] = np.ones((batch,), np.int64)
            slot += 1
            continue
        per_record = []
        count_arr = np.zeros((batch,), np.int64)
        for r in range(batch):
          count = counts[r * self._num_bytes + slot]
          count_arr[r] = count
          # Sequence bytes expose all `cap` step slots (missing steps as
          # b"", zero images downstream); context bytes expose the
          # values present.
          num_values = cap if seq_len > 0 else min(count, cap)
          values = []
          for c in range(num_values):
            ptr = ptrs[r * self._total_caps + offset + c]
            length = lens[r * self._total_caps + offset + c]
            values.append(ctypes.string_at(ptr, length) if ptr else b"")
          per_record.append(values)
        out["bytes"][i] = per_record
        out["bytes_counts"][i] = count_arr
        slot += 1
    if self._num_seq:
      steps = self._lib.t2r_parser_step_counts(self._handle)
      seq_slot = 0
      for i, entry in enumerate(self._plan):
        if entry[4] <= 0:
          continue
        out["step_counts"][i] = np.asarray(
            [steps[r * self._num_seq + seq_slot] for r in range(batch)],
            np.int64)
        seq_slot += 1
    return out
