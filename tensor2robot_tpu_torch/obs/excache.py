"""graftcache: the persistent on-disk cache of compiled steps (compile
once, serve many, across processes).

The port of the JAX package's `obs.excache`. The JAX package stores
serialized XLA executables; the port's compiled unit is a
`torch.compile` graph (`obs.xray.analyze_jit`), and what survives a
process is the compiler's own artifacts for it: the Inductor graph, the
AOTAutograd entry and the Triton kernels, as
`torch.compiler.save_cache_artifacts()` returns them right after that
one compile. A warm process hands the blob to
`torch.compiler.load_cache_artifacts()` before it compiles, so Dynamo
still traces the step, but AOTAutograd and Inductor find their work done.

Layout (the JAX package's): one `<key>.json` sidecar (strict JSON: name,
key components, byte sizes, sha256 of the blob, the cold process's xray
record) and one `<key>.bin` blob (the artifacts' bytes, as torch wrote
them; empty when the compile left none, `cache/bypassed`) per entry. The
sidecar is everything the torch-free readers (`graftscope cache` list,
verify, evict; `entries`, `verify`) need; only `load` and `store` touch
torch.

`cache_key` is pure stdlib over component strings: the name; the args'
tree structure, shapes and dtypes; the model's class, public config and
parameter names, shapes and dtypes; the in-place (donation) layout; the
device (name, capability, count) and the mesh; the torch, CUDA and Triton
versions with the compile backend; and `kernel_fingerprint()`, a sha256
of the port's kernel sources (`csrc/*`) and their wrappers (`ops/*.py`),
the analogue of the JAX key's `pallas` component. A key that misses
costs one compile; an entry loaded under a key that should have missed
costs no correctness, because Inductor checks its own content hashes
before it uses an artifact (it would miss and compile).

Contracts, the JAX package's:

* caching never takes down a run: a stale, corrupt or version-skewed
  entry is quarantined (`cache/corrupt_entries`) and compiles fresh, and
  a failed `store` is counted (`cache/store_failures`), never raised;
* torch-free at import and at key computation;
* every hit, miss and load lands in the metrics registry
  (`cache/{hits,misses,load_ms,bytes,stores,bypassed,...}`) and from
  there in the run record, so `graftscope diff` gates cold-start time.

`enable_inductor_cache(dir)` is the analogue of `enable_xla_cache`: it
points Inductor's own on-disk cache at `<dir>/inductor` (unless the
process set one). `compile_isolated()` is the analogue of
`xla_cache_bypassed`: the compile of an entry about to be stored runs
alone, after the artifact record is cleared, so `save_cache_artifacts()`
returns that compile's artifacts and nothing else the process compiled.

`mesh_compile_unsafe(mesh)` is the analogue of `aot_cache_unsafe`: a step
on a mesh of more than one rank (collectives over gloo or NCCL) is not
compiled at all; the caller counts `cache/skipped_mesh` and runs it
eagerly.
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import os
import pathlib
import re
import sys
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from tensor2robot_tpu_torch.obs import metrics as metrics_lib

__all__ = ["CACHE_VERSION", "cache_key", "key_components", "args_fingerprint",
           "model_fingerprint", "device_fingerprint", "versions_fingerprint",
           "kernel_fingerprint", "mesh_fingerprint", "mesh_compile_unsafe",
           "ExecutableCache", "as_cache", "enable_inductor_cache",
           "compile_isolated", "cache_stats"]

# Bumped whenever the entry format (blob layout, sidecar schema, key
# recipe) changes: part of every key, so an old entry just misses.
CACHE_VERSION = 1

_META_SUFFIX = ".json"
_BLOB_SUFFIX = ".bin"
_KEY_RE = re.compile(r"^[A-Za-z0-9_.-]+$")
_PACKAGE = pathlib.Path(__file__).resolve().parent.parent


# ---------------------------------------------------------------------------
# Key computation (pure: no torch needed for the key itself).
# ---------------------------------------------------------------------------


def _slug(name: str) -> str:
  """Filesystem-safe readable prefix for a key (`serve/engine/bucket4`
  -> `serve-engine-bucket4`)."""
  return re.sub(r"[^A-Za-z0-9_.]+", "-", str(name)).strip("-") or "fn"


def cache_key(name: str, *, args: str, model: str, donation: str,
              device: str, mesh: str, versions: str, kernels: str) -> str:
  """THE canonical graftcache key. Every keyword is mandatory on purpose:
  a compiled step is valid only for the computation, input layout,
  device and compiler that produced it.

  * `args` — the arguments' tree structure, shapes, dtypes and devices,
    and the repr of every non-tensor leaf (`args_fingerprint`);
  * `model` — the model's class, public config and parameter names,
    shapes and dtypes (`model_fingerprint`);
  * `donation` — the in-place layout: which arguments the step updates
    in place;
  * `device` — the device's name, capability and count
    (`device_fingerprint`); `mesh` — the mesh's shape, or "none";
  * `versions` — torch, CUDA, Triton and the compile backend
    (`versions_fingerprint`);
  * `kernels` — the sha256 of the kernel sources and their wrappers
    (`kernel_fingerprint`): editing a kernel invalidates every entry.
  """
  payload = json.dumps({
      "v": CACHE_VERSION, "args": str(args), "model": str(model),
      "donation": str(donation), "device": str(device), "mesh": str(mesh),
      "versions": str(versions), "kernels": str(kernels),
  }, sort_keys=True)
  digest = hashlib.sha256(payload.encode("utf-8")).hexdigest()[:32]
  return f"{_slug(name)}-{digest}"


def _is_tensor(x) -> bool:
  return hasattr(x, "shape") and hasattr(x, "dtype") and hasattr(x, "device")


def _tree_items(tree, path: str = ""):
  """(path, leaf) over nested mappings, lists, tuples and dataclass-like
  objects with `__dict__` fields (a TrainState), in a stable order."""
  if _is_tensor(tree):
    yield path, tree
  elif hasattr(tree, "items"):
    for key in sorted(tree, key=str):
      yield from _tree_items(tree[key], f"{path}/{key}")
  elif isinstance(tree, (list, tuple)):
    for i, value in enumerate(tree):
      yield from _tree_items(value, f"{path}[{i}]")
  elif hasattr(tree, "__dataclass_fields__"):
    for field in tree.__dataclass_fields__:
      yield from _tree_items(getattr(tree, field), f"{path}.{field}")
  else:
    yield path, tree


def args_fingerprint(args) -> str:
  """Structure, shapes, dtypes and device types of every tensor leaf of
  `args`, the type of every number leaf, and the repr of every other
  leaf."""
  parts = []
  for path, leaf in _tree_items(tuple(args)):
    if _is_tensor(leaf):
      dtype = str(leaf.dtype).replace("torch.", "")
      parts.append(f"{path}:{dtype}{list(leaf.shape)}@"
                   f"{getattr(leaf.device, 'type', leaf.device)}")
    elif isinstance(leaf, (int, float)) and not isinstance(leaf, bool):
      # A number that changes each call (a state's step count) compiles
      # the same step: its type, not its value, is keyed.
      parts.append(f"{path}:{type(leaf).__name__}")
    else:
      parts.append(f"{path}={leaf!r}")
  return ";".join(parts)


def model_fingerprint(model) -> str:
  """The model's class, its scalar config (public or underscored
  attributes that are bool, int, float or str) and its module's
  parameter and buffer names, shapes and dtypes; "none" without one."""
  if model is None:
    return "none"
  cls = type(model)
  config = sorted((k, v) for k, v in vars(model).items()
                  if isinstance(v, (bool, int, float, str)))
  leaves = []
  module = getattr(model, "module", None)
  if module is not None and hasattr(module, "state_dict"):
    for name, value in module.state_dict(keep_vars=True).items():
      leaves.append(f"{name}:{str(value.dtype).replace('torch.', '')}"
                    f"{list(value.shape)}")
  return f"{cls.__module__}.{cls.__qualname__}|{config!r}|{';'.join(leaves)}"


def device_fingerprint(device) -> str:
  """`cuda:<name>:sm<major><minor>:n<count>` for a CUDA device, `cpu` for
  the CPU."""
  import torch

  device = torch.device(device)
  if device.type != "cuda":
    return device.type
  major, minor = torch.cuda.get_device_capability(device)
  return (f"cuda:{torch.cuda.get_device_name(device)}:sm{major}{minor}:"
          f"n{torch.cuda.device_count()}")


def versions_fingerprint(backend: str) -> str:
  """torch, its CUDA, Triton (where installed) and the compile backend."""
  import torch

  parts = [f"torch={torch.__version__}", f"cuda={torch.version.cuda}",
           f"backend={backend}"]
  try:
    import triton  # the card's machine; not installed on every host

    parts.append(f"triton={triton.__version__}")
  except ImportError:
    parts.append("triton=none")
  return ";".join(parts)


def kernel_fingerprint() -> str:
  """sha256 over the kernel sources (`csrc/*`) and the operators that
  wrap them (`ops/*.py`), by relative path and content."""
  digest = hashlib.sha256()
  files = sorted(list((_PACKAGE / "csrc").glob("*"))
                 + list((_PACKAGE / "ops").glob("*.py")))
  for path in files:
    if path.is_file():
      digest.update(str(path.relative_to(_PACKAGE)).encode() + b"\0")
      digest.update(path.read_bytes())
  return digest.hexdigest()[:32]


def mesh_fingerprint(mesh) -> str:
  """The mesh's axes and shape, or "none"."""
  if mesh is None:
    return "none"
  shape = getattr(mesh, "shape", None)
  return f"mesh{dict(shape) if shape is not None else mesh!r}"


def mesh_compile_unsafe(mesh) -> bool:
  """True for a mesh of more than one rank: the port compiles no step
  whose collectives cross processes (module docstring)."""
  return mesh is not None and int(getattr(mesh, "size", 1)) > 1


def key_components(args, *, model=None, donate_argnums=(), device=None,
                   mesh=None, backend: str = "eager") -> Dict[str, str]:
  """The `cache_key` components for a call of a step on `args`."""
  return {
      "args": args_fingerprint(args),
      "model": model_fingerprint(model),
      "donation": ",".join("D" if i in tuple(donate_argnums) else "-"
                           for i in range(len(args))),
      "device": device_fingerprint(device or "cpu"),
      "mesh": mesh_fingerprint(mesh),
      "versions": versions_fingerprint(backend),
      "kernels": kernel_fingerprint(),
  }


# ---------------------------------------------------------------------------
# The on-disk cache.
# ---------------------------------------------------------------------------


class ExecutableCache:
  """Content-addressed store of compile artifacts under one directory.

  `load` / `store` never raise (a failure is counted, and the caller
  compiles fresh); `entries` / `verify` / `evict` read sidecars only."""

  def __init__(self, cache_dir: str,
               registry: Optional[metrics_lib.Registry] = None):
    self._dir = str(cache_dir)
    self._registry = registry
    self._lock = threading.Lock()

  @property
  def directory(self) -> str:
    return self._dir

  @property
  def _reg(self) -> metrics_lib.Registry:
    # Late-bound: the process-wide registry is reset between runs.
    return self._registry or metrics_lib.get_registry()

  def _paths(self, key: str) -> Tuple[str, str]:
    if not _KEY_RE.match(key or ""):
      raise ValueError(f"invalid cache key {key!r}")
    return (os.path.join(self._dir, key + _META_SUFFIX),
            os.path.join(self._dir, key + _BLOB_SUFFIX))

  # -- write side -----------------------------------------------------------

  def store(self, key: str, blob: Optional[bytes],
            record: Optional[Dict[str, Any]] = None,
            name: Optional[str] = None,
            components: Optional[Dict[str, str]] = None) -> bool:
    """Persists one entry: the artifacts `blob` (None or empty when the
    compile left none: stored all the same, counted `cache/bypassed`) and
    its sidecar. The blob is written to a temporary name and renamed
    first, then the sidecar, so a reader never sees a sidecar without
    its blob. False (counted) on failure."""
    try:
      meta_path, blob_path = self._paths(key)
      blob = bytes(blob or b"")
      meta = {
          "cache_version": CACHE_VERSION,
          "key": key,
          "name": str(name or (record or {}).get("name") or key),
          "created_unix": time.time(),
          "blob_bytes": len(blob),
          "blob_sha256": hashlib.sha256(blob).hexdigest(),
      }
      if components:
        meta["components"] = {k: v for k, v in components.items()
                              if k in ("device", "mesh", "versions",
                                       "kernels", "donation")}
      if record:
        # The cold process's record; hit or miss is this process's own.
        meta["record"] = {k: v for k, v in record.items() if k != "cache"}
      with self._lock:
        os.makedirs(self._dir, exist_ok=True)
        # Per-writer temporary names: two processes storing one key at
        # once each publish a whole file; the last rename wins.
        suffix = f".tmp.{os.getpid()}.{threading.get_ident()}"
        tmp = blob_path + suffix
        with open(tmp, "wb") as f:
          f.write(blob)
        os.replace(tmp, blob_path)
        tmp = meta_path + suffix
        with open(tmp, "w") as f:
          json.dump(meta, f, sort_keys=True, allow_nan=False)
        os.replace(tmp, meta_path)
      self._reg.counter("cache/stores").inc()
      self._reg.counter("cache/bytes_stored").inc(len(blob))
      if not blob:
        self._reg.counter("cache/bypassed").inc()
      return True
    except Exception as e:  # noqa: BLE001 - caching must never break a run
      self._reg.counter("cache/store_failures").inc()
      print(f"graftcache: store of {key!r} failed ({type(e).__name__}: {e})",
            file=sys.stderr)
      return False

  # -- read side ------------------------------------------------------------

  def load(self, key: str) -> Optional[Dict[str, Any]]:
    """Loads one entry's artifacts into this process's compiler caches:
    {"record", "load_ms", "bytes"}, or None (miss, or a corrupt or
    version-skewed entry, which is quarantined; counted, never raised)."""
    try:
      meta_path, blob_path = self._paths(key)
    except ValueError:
      self._reg.counter("cache/misses").inc()
      return None
    if not os.path.isfile(meta_path) or not os.path.isfile(blob_path):
      self._reg.counter("cache/misses").inc()
      return None
    start = time.perf_counter()

    def read_verified():
      with open(meta_path) as f:
        meta = json.load(f)
      if int(meta.get("cache_version", -1)) != CACHE_VERSION:
        raise ValueError(f"cache_version {meta.get('cache_version')} != "
                         f"{CACHE_VERSION}")
      with open(blob_path, "rb") as f:
        blob = f.read()
      if len(blob) != int(meta.get("blob_bytes", -1)):
        raise ValueError(f"blob is {len(blob)} bytes, sidecar says "
                         f"{meta.get('blob_bytes')}")
      if hashlib.sha256(blob).hexdigest() != meta.get("blob_sha256"):
        raise ValueError("blob sha256 mismatch")
      return meta, blob

    try:
      try:
        meta, blob = read_verified()
      except Exception:  # noqa: BLE001 - maybe a concurrent re-store
        # A peer's store renames the blob a moment before its sidecar;
        # one short retry reads the settled pair, and only a second
        # failure is corruption worth quarantining.
        time.sleep(0.05)
        meta, blob = read_verified()
      if blob:
        import torch

        torch.compiler.load_cache_artifacts(blob)
    except Exception as e:  # noqa: BLE001 - corrupt entry -> fresh compile
      self._quarantine(key, e)
      return None
    load_ms = (time.perf_counter() - start) * 1e3
    self._reg.counter("cache/hits").inc()
    self._reg.counter("cache/bytes").inc(len(blob))
    self._reg.histogram("cache/load_ms").record(load_ms)
    return {"record": dict(meta.get("record") or {}), "load_ms": load_ms,
            "bytes": len(blob)}

  def _quarantine(self, key: str, error: Exception) -> None:
    self._reg.counter("cache/corrupt_entries").inc()
    print(f"graftcache: entry {key!r} unusable ({type(error).__name__}: "
          f"{error}); quarantined, compiling fresh", file=sys.stderr)
    try:
      for path in self._paths(key):
        try:
          os.unlink(path)
        except OSError:
          pass
    except ValueError:
      pass

  # -- torch-free maintenance (graftscope cache) ----------------------------

  def entries(self) -> List[Dict[str, Any]]:
    """Sidecar metadata of every entry (no torch, no blob read). Orphan
    blobs (a store that died between blob and sidecar) are listed with
    `"orphan": True` so `evict` collects them."""
    out: List[Dict[str, Any]] = []
    if not os.path.isdir(self._dir):
      return out
    names = sorted(os.listdir(self._dir))
    with_sidecar = set()
    for fname in names:
      if not fname.endswith(_META_SUFFIX):
        continue
      key = fname[:-len(_META_SUFFIX)]
      entry: Dict[str, Any] = {"key": key}
      try:
        with open(os.path.join(self._dir, fname)) as f:
          entry.update({k: v for k, v in json.load(f).items()
                        if k != "record"})
      except (OSError, ValueError) as e:
        entry["corrupt_sidecar"] = f"{type(e).__name__}: {e}"
      entry["blob_present"] = os.path.isfile(
          os.path.join(self._dir, key + _BLOB_SUFFIX))
      with_sidecar.add(key)
      out.append(entry)
    for fname in names:
      if fname.endswith(_BLOB_SUFFIX):
        key = fname[:-len(_BLOB_SUFFIX)]
        if key not in with_sidecar:
          out.append({"key": key, "orphan": True,
                      "blob_bytes": os.path.getsize(
                          os.path.join(self._dir, fname))})
    return out

  def verify(self) -> Tuple[List[str], List[str]]:
    """(ok keys, bad keys) by checksum; torch-free and read-only."""
    ok: List[str] = []
    bad: List[str] = []
    for entry in self.entries():
      key = entry["key"]
      if (entry.get("orphan") or entry.get("corrupt_sidecar")
          or not entry.get("blob_present")):
        bad.append(key)
        continue
      try:
        with open(os.path.join(self._dir, key + _BLOB_SUFFIX), "rb") as f:
          blob = f.read()
        if (len(blob) != int(entry.get("blob_bytes", -1))
            or hashlib.sha256(blob).hexdigest() != entry.get("blob_sha256")):
          raise ValueError("checksum mismatch")
        ok.append(key)
      except (OSError, ValueError):
        bad.append(key)
    return ok, bad

  def evict(self, key: Optional[str] = None,
            older_than_secs: Optional[float] = None,
            name_prefix: Optional[str] = None) -> int:
    """Removes entries; returns how many. No selector removes everything,
    the Inductor tier under `<dir>/inductor` included; `key` one entry;
    `older_than_secs` entries created longer ago (orphans always match);
    `name_prefix` entries whose recorded name starts with it."""
    selective = (key is not None or older_than_secs is not None
                 or name_prefix is not None)
    if not selective:
      import shutil

      shutil.rmtree(os.path.join(self._dir, "inductor"), ignore_errors=True)
    removed = 0
    now = time.time()
    for entry in self.entries():
      if key is not None and entry["key"] != key:
        continue
      if name_prefix is not None and not str(
          entry.get("name") or "").startswith(name_prefix):
        continue
      if older_than_secs is not None and not entry.get("orphan"):
        if now - float(entry.get("created_unix") or 0.0) < older_than_secs:
          continue
      for suffix in (_META_SUFFIX, _BLOB_SUFFIX):
        try:
          os.unlink(os.path.join(self._dir, entry["key"] + suffix))
        except OSError:
          continue
      removed += 1
    if removed:
      self._reg.counter("cache/evictions").inc(removed)
    return removed


def as_cache(cache) -> Optional[ExecutableCache]:
  """An ExecutableCache passes through, a directory path wraps,
  None / '' disables."""
  if cache is None or cache == "":
    return None
  if isinstance(cache, ExecutableCache):
    return cache
  return ExecutableCache(str(cache))


# ---------------------------------------------------------------------------
# The compiler's own tier.
# ---------------------------------------------------------------------------

# One compile that will be stored at a time in this process: the
# artifact record is process-wide.
_COMPILE_LOCK = threading.RLock()


@contextlib.contextmanager
def compile_isolated():
  """Runs the compile of an entry about to be stored alone, with the
  compiler's artifact record cleared first, so that
  `torch.compiler.save_cache_artifacts()` afterwards returns this
  compile's artifacts only (module docstring)."""
  with _COMPILE_LOCK:
    try:
      from torch.compiler._cache import CacheArtifactManager

      CacheArtifactManager.clear()
    except (ImportError, AttributeError):
      pass
    yield


def enable_inductor_cache(cache_dir: str) -> bool:
  """Points Inductor's on-disk cache at `<cache_dir>/inductor`, unless
  the process already chose one (`TORCHINDUCTOR_CACHE_DIR`); True when
  this call set it. The analogue of the JAX package's
  `enable_xla_cache`."""
  if os.environ.get("TORCHINDUCTOR_CACHE_DIR"):
    return False
  path = os.path.join(str(cache_dir), "inductor")
  try:
    os.makedirs(path, exist_ok=True)
  except OSError as e:
    print(f"graftcache: Inductor cache dir unavailable ({e})",
          file=sys.stderr)
    return False
  os.environ["TORCHINDUCTOR_CACHE_DIR"] = path
  return True


def cache_stats(registry: Optional[metrics_lib.Registry] = None
                ) -> Dict[str, float]:
  """The `cache/*` registry slice as a flat dict: the block run records
  embed. The counters are created first, so the schema is stable on a
  run that never touched the cache."""
  reg = registry or metrics_lib.get_registry()
  for name in ("cache/hits", "cache/misses", "cache/corrupt_entries",
               "cache/stores", "cache/store_failures", "cache/bypassed",
               "cache/skipped_mesh"):
    reg.counter(name)
  return reg.snapshot(prefix="cache/")
