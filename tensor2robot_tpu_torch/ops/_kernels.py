"""Builds the port's CUDA kernels with nvcc and loads them with ctypes.

Each `csrc/<name>.cu` is compiled on first use into its own shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds), for `sm_90a`:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
        -Xcompiler -fPIC -o _build/<name>-<hash>.so csrc/<name>.cu

The file name carries a hash of the source and of every `csrc/*.cuh`
header, so an edited kernel or header is never served from a stale
library. `build()` starts one nvcc per missing
library, all at once. Nothing here runs at import: every module of the
port must import on a machine without nvcc, as the CPU tests do.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time
from typing import Dict, List, Optional

_PACKAGE = pathlib.Path(__file__).resolve().parent.parent
CSRC_DIR = _PACKAGE / "csrc"
BUILD_DIR = _PACKAGE / "_build"
SOURCES = ("decode_tick", "flash_fwd", "flash_bwd", "batch_norm")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I = ctypes.c_void_p, ctypes.c_int
_L, _F = ctypes.c_longlong, ctypes.c_float
# The launch functions of each library. Every pointer and the stream as
# c_void_p: ctypes would otherwise pass a Python int as a 32-bit int and
# cut the pointer. Each library also exports `t2r_<name>_error_string`.
_SIGNATURES = {
    "decode_tick": {"t2r_decode_tick": [_P] * 11 + [_I] * 5 + [_P]},
    "flash_fwd": {"t2r_flash_fwd": [_P] * 5 + [_I] * 6 + [_P]},
    "flash_bwd": {"t2r_flash_bwd_split": [_P] * 6 + [_I] * 3 + [_P],
                  "t2r_flash_bwd_dq": [_P] * 9 + [_I] * 6 + [_P],
                  "t2r_flash_bwd_dkv": [_P] * 10 + [_I] * 6 + [_P]},
    "batch_norm": {
        "t2r_batch_norm_fwd": [_P] * 12 + [_I] * 8 + [_L] * 2 + [_F] * 3
                              + [_P],
        "t2r_batch_norm_bwd": [_P] * 10 + [_I] * 8 + [_L] * 2 + [_P]},
}

_lock = threading.Lock()
_libraries: Dict[str, ctypes.CDLL] = {}
_build_log: Dict[str, str] = {}


def _nvcc() -> str:
  found = shutil.which("nvcc")
  if found:
    return found
  cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
  candidate = os.path.join(cuda_home, "bin", "nvcc")
  if os.path.isfile(candidate):
    return candidate
  raise RuntimeError("nvcc not found (PATH or $CUDA_HOME/bin); the CUDA "
                     "kernels cannot be built on this machine.")


def _library_path(name: str) -> pathlib.Path:
  """The library's path, named by a hash of its source, every header in
  `csrc/` (any of them may be included) and the nvcc flags."""
  digest = hashlib.sha256((CSRC_DIR / f"{name}.cu").read_bytes())
  for header in sorted(CSRC_DIR.glob("*.cuh")):
    digest.update(header.name.encode() + b"\0" + header.read_bytes())
  digest.update(" ".join(NVCC_FLAGS).encode())
  return BUILD_DIR / f"{name}-{digest.hexdigest()[:12]}.so"


def build(names=SOURCES) -> float:
  """Compiles every library of `names` that is not built yet, one nvcc
  process each, all started together. Returns the seconds it took;
  raises with nvcc's output if any build fails."""
  start = time.perf_counter()
  with _lock:
    todo = [(n, _library_path(n)) for n in names
            if not _library_path(n).is_file()]
    if not todo:
      return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for name, path in todo:
      tmp = path.with_suffix(f".{os.getpid()}.tmp")
      cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
      procs.append((name, path, tmp, subprocess.Popen(
          cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failures: List[str] = []
    for name, path, tmp, proc in procs:
      output, _ = proc.communicate()
      _build_log[name] = output
      if proc.returncode != 0:
        failures.append(f"{name}.cu (exit {proc.returncode}):\n{output}")
        tmp.unlink(missing_ok=True)
      else:
        os.replace(tmp, path)  # atomic: a concurrent build sees all or none
    if failures:
      raise RuntimeError("nvcc failed:\n" + "\n".join(failures))
  return time.perf_counter() - start


def build_log(name: str) -> Optional[str]:
  """nvcc's output (ptxas register and shared-memory report) of the
  build this process made, or None when the library was already built."""
  return _build_log.get(name)


def library(name: str) -> ctypes.CDLL:
  """The loaded library of `csrc/<name>.cu`, built first if needed."""
  lib = _libraries.get(name)
  if lib is not None:
    return lib
  build((name,))
  with _lock:
    lib = _libraries.get(name)
    if lib is None:
      lib = ctypes.CDLL(str(_library_path(name)))
      for symbol, argtypes in _SIGNATURES[name].items():
        fn = getattr(lib, symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
      err = getattr(lib, f"t2r_{name}_error_string")
      err.argtypes = [ctypes.c_int]
      err.restype = ctypes.c_char_p
      _libraries[name] = lib
  return lib


def check(name: str, status: int, symbol: Optional[str] = None) -> None:
  """Raises when a launch function of library `name` returned a CUDA
  error: a refused launch never runs, and a later synchronize would not
  report it."""
  if status != 0:
    symbol = symbol or f"t2r_{name}"
    text = getattr(library(name), f"t2r_{name}_error_string")(status)
    raise RuntimeError(f"{symbol} failed: CUDA error {status} "
                       f"({text.decode() if text else 'unknown'})")
