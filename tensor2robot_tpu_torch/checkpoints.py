"""Checkpoints: save and restore a `TrainState`, with checksummed
manifests, verification on restore, quarantine and fallback.

Counterpart of `tensor2robot_tpu.checkpoints.CheckpointManager`. The JAX
package writes orbax step directories; the card has no orbax, so the port
writes its own format and reads only that (a JAX state comes across
through `bridge.train_state_from_jax`). Layout under `directory`
(`<model_dir>/checkpoints` for a trainer):

* `<step>/state.pt` — `torch.save` of {step, params, ema_params,
  opt_state, mutable_state}, tensors on the CPU (a step written before
  the state carried `mutable_state` restores with {}). A step is written into a temporary
  directory and renamed into place, so a digit-named directory is
  complete.
* `manifests/<step>.json` — the same sidecar schema as the JAX package
  (`graftguard-manifest-v1`: size and crc32 of every file of the step),
  written by the saver from the bytes on disk, never by a reader.
* `quarantine/<step>` — a step that failed verification, or whose load
  failed without a clean manifest, moved out of the way.

`restore(None)` walks the steps newest first and falls back past corrupt
ones to the newest verified step; an explicit corrupt step raises
`CheckpointCorruptionError`. `max_to_keep` newest steps are kept.

The `obs.faultlab` points `ckpt.torn` and `ckpt.bitflip` (one arrival
per `save` that writes) corrupt the step just written AFTER its manifest
captured the good bytes: truncated to half, or one byte flipped mid-file,
in its largest file — exactly the damage the manifest exists to catch.

Saves are asynchronous by default (`async_checkpointing=True`, as in the
JAX package): `save` copies the state to the host on the caller's thread
and returns; one worker thread writes, fsyncs, renames, writes the
manifest and prunes. A second save waits for the first. `all_steps`,
`latest_step` and `restore` of the saving manager see only finished
steps (`restore` and `close` wait for the save in flight). A failed
write is logged by the worker and raised by the next `save`,
`wait_until_finished` or `close`.

On a mesh (`CheckpointManager(..., mesh=mesh)`), a save gathers the
full state from every rank's blocks (`save(step, state, shardings)`:
every rank calls it) and rank 0 alone writes, prunes and quarantines,
so a checkpoint holds full tensors and restores onto any mesh shape;
`restore` agrees on the step rank 0's walk lands on (every rank then
loads it), and the caller cuts the full state into its blocks.

Preemption (`reached_preemption`): orbax's preemption signal has no
torch twin, so `preemption_signal()` installs a SIGTERM handler (main
thread only) that sets a flag; on a mesh the trainer agrees on it over
the ranks by one host all-reduce (max), so every rank saves at the same
step.

Beside the manager, the functions a deployment needs:

* `latest_step(directory)`, `write_manifest(directory, step)` and
  `verify_step_files(directory, step)`, without a manager;
* `checkpoints_iterator`: new steps as they land, each only once its
  manifest exists (a step is renamed into place before its manifest is
  written, so a step without one may still be in flight), polled with a
  jittered sleep;
* `backup_checkpoint`: a step (hard links where the filesystem allows)
  and its manifest copied out of the writer's pruning reach, under a
  retry policy;
* `warm_start_params`: fresh parameters overwritten by the same-named,
  same-shaped leaves of another run's checkpoint or export bundle. Names
  are the port's flat `state_dict` names (`tower.conv1.weight`), so a
  `filter_fn` sees those, not the JAX package's key paths;
* `average_checkpoints`: the uniform mean of several steps' parameters.
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import shutil
import signal
import threading
import time
import zlib
from typing import (Callable, Dict, Iterator, List, Optional, Sequence,
                    Tuple)

import torch

from tensor2robot_tpu_torch.obs import faultlab as faultlab_lib
from tensor2robot_tpu_torch.obs import metrics as metrics_lib
from tensor2robot_tpu_torch.parallel import collectives
from tensor2robot_tpu_torch.parallel import train_step as ts
from tensor2robot_tpu_torch.utils import retry as retry_lib

__all__ = ["CheckpointManager", "CheckpointCorruptionError",
           "CHECKPOINT_DIRNAME", "MANIFEST_DIRNAME", "QUARANTINE_DIRNAME",
           "MANIFEST_SCHEMA", "STATE_FILENAME", "latest_step",
           "checkpoints_iterator", "backup_checkpoint", "warm_start_params",
           "write_manifest", "verify_step_files",
           "average_checkpoints", "remove_backup", "host_copy",
           "preemption_signal"]

# A trainer's checkpoints live in <model_dir>/checkpoints.
CHECKPOINT_DIRNAME = "checkpoints"
MANIFEST_DIRNAME = "manifests"
QUARANTINE_DIRNAME = "quarantine"
MANIFEST_SCHEMA = "graftguard-manifest-v1"
STATE_FILENAME = "state.pt"

_log = logging.getLogger(__name__)


# Set by the SIGTERM handler of `preemption_signal`.
_PREEMPTED = threading.Event()


@contextlib.contextmanager
def preemption_signal():
  """Within the block, a SIGTERM sets the preemption flag that
  `CheckpointManager.reached_preemption` reads, instead of ending the
  process (main thread only; elsewhere nothing is installed). The flag is
  cleared on entry, and the previous handler is restored on exit."""
  _PREEMPTED.clear()
  try:
    previous = signal.signal(signal.SIGTERM,
                             lambda signum, frame: _PREEMPTED.set())
  except ValueError:  # not the main thread
    yield
    return
  try:
    yield
  finally:
    signal.signal(signal.SIGTERM,
                  previous if previous is not None else signal.SIG_DFL)


class CheckpointCorruptionError(RuntimeError):
  """A checkpoint failed verification (or its load) and no intact
  fallback step exists."""


def _file_crc32(path: str) -> int:
  crc = 0
  with open(path, "rb") as f:
    for chunk in iter(lambda: f.read(1 << 20), b""):
      crc = zlib.crc32(chunk, crc)
  return crc & 0xFFFFFFFF


def host_copy(tree):
  """A copy of every tensor of `tree` on the CPU, made now: the D2H copy
  of a card's tensor waits for the work that writes it."""
  return ts.map_tensors(lambda x: x.detach().to("cpu", copy=True), tree)


def _step_files(step_dir: str) -> List[str]:
  """Relative paths of every file under a step dir, sorted."""
  out: List[str] = []
  for dirpath, dirnames, filenames in os.walk(step_dir):
    dirnames.sort()
    for name in sorted(filenames):
      out.append(os.path.relpath(os.path.join(dirpath, name), step_dir))
  return out


def _corrupt_step_for_faultlab(directory: str, step: int, mode: str) -> None:
  """Enacts a ckpt.torn ("torn") / ckpt.bitflip ("bitflip") fault on the
  LARGEST file of a written step directory (a deterministic target)."""
  step_dir = os.path.join(directory, str(int(step)))
  candidates = [(os.path.getsize(os.path.join(step_dir, rel)), rel)
                for rel in _step_files(step_dir)]
  candidates = [(size, rel) for size, rel in candidates if size > 1]
  if not candidates:
    return
  _, rel = max(candidates)
  path = os.path.join(step_dir, rel)
  size = os.path.getsize(path)
  with open(path, "r+b") as f:
    if mode == "torn":
      f.truncate(size // 2)
    else:  # bitflip: one byte mid-file, the silent-corruption case
      f.seek(size // 2)
      byte = f.read(1)
      f.seek(size // 2)
      f.write(bytes([byte[0] ^ 0xFF]))
    f.flush()
    os.fsync(f.fileno())


def _manifest_path(directory: str, step: int) -> str:
  return os.path.join(directory, MANIFEST_DIRNAME, f"{int(step)}.json")


def write_manifest(directory: str, step: int) -> str:
  """Writes the manifest of step `step` under `directory` from the bytes
  on disk (size and crc32 of every file of the step); returns its path."""
  step_dir = os.path.join(directory, str(int(step)))
  files: Dict[str, Dict[str, int]] = {}
  for rel in _step_files(step_dir):
    full = os.path.join(step_dir, rel)
    files[rel] = {"size": os.path.getsize(full), "crc32": _file_crc32(full)}
  manifest = {"schema": MANIFEST_SCHEMA, "schema_version": 1,
              "step": int(step), "files": files}
  path = _manifest_path(directory, step)
  os.makedirs(os.path.dirname(path), exist_ok=True)
  tmp = path + ".tmp"
  with open(tmp, "w") as f:
    json.dump(manifest, f, sort_keys=True)
    f.flush()
    os.fsync(f.fileno())
  os.replace(tmp, path)
  return path


def verify_step_files(directory: str, step: int) -> Optional[bool]:
  """True when every file the manifest of step `step` lists is present
  with its size and crc32; False on a mismatch (counted
  `ckpt/verify_failures`); None when the step has no readable manifest."""
  try:
    with open(_manifest_path(directory, step)) as f:
      listed = json.load(f)["files"]
  except (OSError, ValueError, KeyError, TypeError):
    return None
  step_dir = os.path.join(directory, str(int(step)))
  for rel, meta in listed.items():
    full = os.path.join(step_dir, rel)
    try:
      ok = (os.path.getsize(full) == int(meta["size"])
            and _file_crc32(full) == int(meta["crc32"]))
    except OSError:
      ok = False
    if not ok:
      metrics_lib.counter("ckpt/verify_failures").inc()
      return False
  return True


class CheckpointManager:
  """Saves and restores `TrainState`s under one directory."""

  def __init__(self, directory: str, max_to_keep: int = 5,
               async_checkpointing: bool = True, mesh=None):
    self._directory = os.path.abspath(directory)
    self._mesh = mesh
    # Only rank 0 of a mesh writes, prunes and quarantines.
    self._primary = mesh is None or mesh.is_primary
    os.makedirs(self._directory, exist_ok=True)
    self._max_to_keep = max_to_keep
    self._async = async_checkpointing
    # The save in flight: its worker and step; the error of a failed one,
    # raised on the caller's thread by the next save or wait.
    self._worker: Optional[threading.Thread] = None
    self._worker_step: Optional[int] = None
    self._error: Optional[BaseException] = None
    # The step the most recent restore() returned (the fallback walk may
    # land below the newest step).
    self.last_restored_step: Optional[int] = None

  @property
  def directory(self) -> str:
    return self._directory

  def _step_dir(self, step: int) -> str:
    return os.path.join(self._directory, str(int(step)))

  def _manifest_path(self, step: int) -> str:
    return _manifest_path(self._directory, step)

  def all_steps(self) -> List[int]:
    """Finished steps on disk (digit-named directories), oldest first."""
    worker, in_flight = self._worker, self._worker_step
    busy = in_flight if worker is not None and worker.is_alive() else None
    return sorted(int(name) for name in os.listdir(self._directory)
                  if name.isdigit() and int(name) != busy
                  and os.path.isdir(os.path.join(self._directory, name)))

  def latest_step(self) -> Optional[int]:
    steps = self.all_steps()
    return steps[-1] if steps else None

  # -- save ------------------------------------------------------------------

  def save(self, step: int, state: ts.TrainState,
           shardings: Optional[ts.TrainState] = None) -> bool:
    """Writes `state` as step `step`, then its manifest, then drops the
    oldest steps past `max_to_keep`; asynchronously unless the manager
    was made with `async_checkpointing=False`. Waits for a save in
    flight first. False (nothing written) when the step is already on
    disk, and on every rank of a mesh but rank 0. With `shardings`, the
    full state is gathered from every rank's blocks first (every rank of
    the mesh calls `save`)."""
    step = int(step)
    if shardings is not None:
      state = ts.gather_state(state, shardings)
    if not self._primary:
      return False
    self.wait_until_finished()
    if os.path.isdir(self._step_dir(step)):
      return False
    payload = {"step": int(state.step),
               **host_copy({"params": state.params,
                            "ema_params": state.ema_params,
                            "opt_state": state.opt_state,
                            "mutable_state": state.mutable_state})}
    # The fault plan's arrival is counted here, on the caller's thread,
    # so a plan fires on the same save however the writes interleave.
    fault = (faultlab_lib.maybe_fire(faultlab_lib.CKPT_TORN)
             or faultlab_lib.maybe_fire(faultlab_lib.CKPT_BITFLIP))
    corrupt = (None if fault is None else
               "torn" if fault.point == faultlab_lib.CKPT_TORN else "bitflip")
    if not self._async:
      self._write(step, payload, corrupt)
      return True
    self._worker_step = step
    self._worker = threading.Thread(target=self._write_in_worker,
                                    args=(step, payload, corrupt),
                                    name=f"ckpt-save-{step}")
    self._worker.start()
    return True

  def _write_in_worker(self, step: int, payload: dict,
                       corrupt: Optional[str]) -> None:
    try:
      self._write(step, payload, corrupt)
    except BaseException as e:  # noqa: BLE001 - re-raised on the caller
      _log.exception("checkpoint step %d: async save failed", step)
      self._error = e

  def _write(self, step: int, payload: dict,
             corrupt: Optional[str] = None) -> None:
    tmp = os.path.join(self._directory, f".{step}.tmp-{os.getpid()}")
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    path = os.path.join(tmp, STATE_FILENAME)
    with open(path, "wb") as f:
      torch.save(payload, f)
      f.flush()
      os.fsync(f.fileno())
    os.replace(tmp, self._step_dir(step))
    self._write_manifest(step)
    if corrupt is not None:
      _corrupt_step_for_faultlab(self._directory, step, corrupt)
    metrics_lib.counter("ckpt/saves").inc()
    self._prune()

  def wait_until_finished(self) -> None:
    """Joins the save in flight; raises `RuntimeError` (from the
    worker's error) when an asynchronous save failed."""
    worker = self._worker
    if worker is not None:
      worker.join()
      self._worker = self._worker_step = None
    if self._error is not None:
      error, self._error = self._error, None
      raise RuntimeError(f"an asynchronous checkpoint save under "
                         f"{self._directory} failed") from error

  def close(self) -> None:
    self.wait_until_finished()

  def __enter__(self) -> "CheckpointManager":
    return self

  def __exit__(self, *exc) -> None:
    self.close()

  def _write_manifest(self, step: int) -> None:
    write_manifest(self._directory, step)

  def _prune(self) -> None:
    if not self._max_to_keep or self._max_to_keep <= 0:
      return
    for step in self.all_steps()[:-self._max_to_keep]:
      shutil.rmtree(self._step_dir(step), ignore_errors=True)
      manifest = self._manifest_path(step)
      if os.path.isfile(manifest):
        os.remove(manifest)

  # -- verify, quarantine, restore ---------------------------------------------

  def verify_step(self, step: int) -> Optional[bool]:
    """`verify_step_files` of this manager's directory."""
    return verify_step_files(self._directory, step)

  def latest_verified_step(self) -> Optional[int]:
    """Newest step that does not fail verification."""
    for step in reversed(self.all_steps()):
      if self.verify_step(step) is not False:
        return step
    return None

  def _quarantine(self, step: int, reason: str) -> None:
    if not self._primary:
      return
    qdir = os.path.join(self._directory, QUARANTINE_DIRNAME)
    dst = os.path.join(qdir, str(int(step)))
    os.makedirs(qdir, exist_ok=True)
    if os.path.isdir(dst):  # a previous quarantine of the same step
      dst = f"{dst}.{int(time.time())}"
    shutil.move(self._step_dir(step), dst)
    manifest = self._manifest_path(step)
    if os.path.isfile(manifest):
      shutil.move(manifest, os.path.join(dst, "graftguard.manifest.json"))
    metrics_lib.counter("ckpt/quarantined").inc()
    _log.warning("checkpoint step %d QUARANTINED (%s) -> %s", step, reason,
                 dst)

  def _looks_torn(self, step: int) -> bool:
    """For a step without a manifest whose load failed: missing or empty
    files mean torn bytes; an intact-looking step means a caller error."""
    path = os.path.join(self._step_dir(step), STATE_FILENAME)
    return not os.path.isfile(path) or os.path.getsize(path) == 0

  def _load(self, step: int, device) -> ts.TrainState:
    path = os.path.join(self._step_dir(step), STATE_FILENAME)
    payload = torch.load(path, map_location=device, weights_only=True)
    return ts.TrainState(step=int(payload["step"]), params=payload["params"],
                         ema_params=payload["ema_params"],
                         opt_state=payload["opt_state"],
                         mutable_state=payload.get("mutable_state", {}))

  def reached_preemption(self, step: int) -> bool:
    """True once a SIGTERM arrived inside `preemption_signal()`, on this
    rank. On a mesh the trainer agrees it over the ranks together with
    its rewind flag (`Mesh.agree`, one host all-reduce a step), so every
    rank saves at the same step."""
    del step
    return _PREEMPTED.is_set()

  def restore(self, step: Optional[int] = None,
              device=None) -> ts.TrainState:
    """`_restore_walk` on a single process. On a mesh, rank 0 walks and
    every other rank loads the step rank 0 landed on (a full state: the
    caller cuts it into its blocks)."""
    if self._mesh is None or self._mesh.size == 1:
      return self._restore_walk(step, device)
    world = self._mesh.group(self._mesh.axis_names)
    chosen = torch.tensor([-1], dtype=torch.int64, device=self._mesh.device)
    state = None
    try:
      if self._primary:
        state = self._restore_walk(step, device)
        chosen.fill_(self.last_restored_step)
    finally:
      # Rank 0 answers even when its walk raised (-1), so no rank waits.
      chosen = collectives.broadcast(chosen, world)
    chosen_step = int(chosen.item())
    if chosen_step < 0:
      raise CheckpointCorruptionError(
          f"rank 0 found no intact checkpoint in {self._directory}")
    if state is None:
      self.wait_until_finished()
      state = self._load(chosen_step, device)
      self.last_restored_step = chosen_step
    return state

  def _restore_walk(self, step: Optional[int] = None,
                    device=None) -> ts.TrainState:
    """Restores `step`, or with None the newest step that verifies and
    loads, onto `device` (the CPU by default), after the save in flight
    has finished. A step failing its
    manifest, or failing to load without a clean manifest and looking
    torn, is quarantined: then `step=None` falls back to the next newest
    and an explicit step raises `CheckpointCorruptionError`. A load
    failure of a step whose manifest verified is re-raised. An explicit
    step not on disk raises FileNotFoundError."""
    self.wait_until_finished()
    explicit = step is not None
    on_disk = self.all_steps()
    if explicit and int(step) not in on_disk:
      raise FileNotFoundError(
          f"checkpoint step {step} not found in {self._directory}")
    candidates = [int(step)] if explicit else list(reversed(on_disk))
    if not candidates:
      raise FileNotFoundError(f"No checkpoint in {self._directory}")
    last_error: Optional[BaseException] = None
    for candidate in candidates:
      verdict = self.verify_step(candidate)
      if verdict is False:
        self._quarantine(candidate, "checksum mismatch")
        if explicit:
          raise CheckpointCorruptionError(
              f"checkpoint step {candidate} in {self._directory} failed "
              "manifest verification (quarantined)")
        continue
      try:
        state = self._load(candidate, device)
      except Exception as e:  # noqa: BLE001 - classified below
        if verdict is True or not self._looks_torn(candidate):
          raise
        last_error = e
        self._quarantine(candidate, f"load failed: {type(e).__name__}: {e}")
        if explicit:
          raise CheckpointCorruptionError(
              f"checkpoint step {candidate} in {self._directory} is torn "
              "(load failed; quarantined)") from e
        metrics_lib.counter("ckpt/restore_fallbacks").inc()
        continue
      self.last_restored_step = candidate
      return state
    raise CheckpointCorruptionError(
        f"no intact checkpoint in {self._directory}: every candidate step "
        "was quarantined") from last_error


# -- deployment helpers -------------------------------------------------------

def latest_step(directory: str) -> Optional[int]:
  """The newest digit-named step under `directory`, without a manager."""
  if not os.path.isdir(directory):
    return None
  steps = [int(name) for name in os.listdir(directory)
           if name.isdigit() and os.path.isdir(os.path.join(directory, name))]
  return max(steps) if steps else None


def checkpoints_iterator(directory: str,
                         timeout_secs: float = 10.0,
                         total_timeout_secs: Optional[float] = None,
                         min_interval_secs: float = 0.0
                         ) -> Iterator[int]:
  """Yields the newest step under `directory` each time a new one has
  landed: renamed into place AND with its manifest written (a step
  without a manifest may be a save in flight). Steps that land between
  two polls are skipped for the newest, as in the JAX package. Between
  polls it sleeps about `timeout_secs` (jittered by a quarter, so many
  evaluators on one filesystem do not poll in step); it returns once
  `total_timeout_secs` pass without a new step."""
  seen = set()
  start = time.time()
  while True:
    step = latest_step(directory)
    if step is not None and step not in seen and os.path.isfile(
        os.path.join(directory, MANIFEST_DIRNAME, f"{step}.json")):
      seen.add(step)
      yield step
      start = time.time()
      if min_interval_secs:
        time.sleep(min_interval_secs)
      continue
    if (total_timeout_secs is not None
        and time.time() - start > total_timeout_secs):
      return
    time.sleep(retry_lib.jittered_s(timeout_secs, jitter=0.25))


def _link_or_copy(src: str, dst: str) -> None:
  try:
    os.link(src, dst)
  except OSError:
    shutil.copy2(src, dst)


def backup_checkpoint(directory: str, step: int,
                      backup_root: Optional[str] = None,
                      max_attempts: int = 3) -> Optional[str]:
  """Copies step `step` of `directory` to `<backup_root>/<step>` (hard
  links where the filesystem allows, so the copy costs no bytes and
  survives the writer pruning the source) and its manifest to
  `<backup_root>/manifests/`, so `CheckpointManager(backup_root)`
  verifies and restores it. Retries under a `RetryPolicy`
  (`retry/ckpt_backup/*`) when the writer races the copy; returns the
  backup's path, or None when every attempt failed. `backup_root`
  defaults to `<directory>/eval_backup`."""
  src = os.path.join(directory, str(int(step)))
  manifest = os.path.join(directory, MANIFEST_DIRNAME, f"{int(step)}.json")
  backup_root = backup_root or os.path.join(directory, "eval_backup")
  dst = os.path.join(backup_root, str(int(step)))
  dst_manifest = os.path.join(backup_root, MANIFEST_DIRNAME,
                              f"{int(step)}.json")

  def _copy() -> str:
    if os.path.isdir(dst):
      shutil.rmtree(dst)
    os.makedirs(os.path.dirname(dst_manifest), exist_ok=True)
    shutil.copytree(src, dst, copy_function=_link_or_copy)
    if os.path.isfile(manifest):
      shutil.copy2(manifest, dst_manifest)
    return dst

  policy = retry_lib.RetryPolicy(
      name="ckpt_backup", max_attempts=max_attempts, base_delay_s=0.5,
      multiplier=1.5, max_delay_s=2.0,
      retryable=lambda e: isinstance(e, (OSError, shutil.Error)))
  try:
    return policy.call(_copy)
  except retry_lib.RetryBudgetExhausted:
    _log.warning("checkpoint step %s: backup to %s failed", step, dst)
    return None


def remove_backup(backup: str) -> None:
  """Removes a `backup_checkpoint` copy, its manifest, and the backup
  root's directories once they are empty."""
  root = os.path.dirname(backup)
  shutil.rmtree(backup, ignore_errors=True)
  manifests = os.path.join(root, MANIFEST_DIRNAME)
  manifest = os.path.join(manifests, f"{os.path.basename(backup)}.json")
  if os.path.isfile(manifest):
    os.remove(manifest)
  for path in (manifests, root):
    try:
      os.rmdir(path)
    except OSError:
      pass  # not empty (another evaluator's backup) or already gone


def _load_variables(checkpoint_path: str) -> dict:
  """The parameter tree of a step directory (or its `state.pt`), or of
  an export bundle (or its `params/` directory, or the file there)."""
  from tensor2robot_tpu_torch.export import export_generator as export_lib

  path = checkpoint_path
  if os.path.isdir(path):
    for candidate in (STATE_FILENAME, export_lib.VARIABLES_FILENAME,
                      os.path.join(export_lib.PARAMS_DIRNAME,
                                   export_lib.VARIABLES_FILENAME)):
      if os.path.isfile(os.path.join(path, candidate)):
        path = os.path.join(path, candidate)
        break
    else:
      raise FileNotFoundError(f"no {STATE_FILENAME} or export variables "
                              f"under {checkpoint_path}")
  payload = torch.load(path, map_location="cpu", weights_only=True)
  return payload["params"] if "params" in payload else payload


def warm_start_params(params: Dict[str, torch.Tensor], checkpoint_path: str,
                      filter_fn: Optional[Callable[[str], bool]] = None,
                      strict: bool = False
                      ) -> Tuple[Dict[str, torch.Tensor], List[str]]:
  """Overwrites fresh `params` with the leaves of another checkpoint
  (a step directory of any run, or an export bundle) that have the same
  name and shape; every other leaf keeps its fresh value. `filter_fn`
  sees the port's flat names (`tower.conv1.weight`) and returns False to
  keep a leaf fresh; with `strict` a leaf missing from the checkpoint
  raises. Restored leaves take the fresh leaf's dtype and device.
  Returns (merged params, restored names); raises when nothing was
  restored."""
  restored = _load_variables(checkpoint_path)
  merged, names = {}, []
  for name, leaf in params.items():
    candidate = restored.get(name)
    if filter_fn is not None and not filter_fn(name):
      merged[name] = leaf
      continue
    if candidate is None or tuple(candidate.shape) != tuple(leaf.shape):
      if strict and candidate is None:
        raise ValueError(f"warm start: {name!r} missing from checkpoint")
      merged[name] = leaf
      continue
    merged[name] = candidate.to(dtype=leaf.dtype, device=leaf.device)
    names.append(name)
  if not names:
    raise ValueError(f"Warm start from {checkpoint_path} restored nothing; "
                     f"checkpoint keys: {sorted(restored)[:10]}...")
  return merged, names


def average_checkpoints(directory: str,
                        steps: Optional[Sequence[int]] = None,
                        last_n: int = 3) -> Dict[str, torch.Tensor]:
  """The uniform mean of the `params` of the steps `steps` under
  `directory` (default: the newest `last_n`), summed in float64 and
  returned in float32 on the CPU."""
  available = sorted(int(name) for name in os.listdir(directory)
                     if name.isdigit())
  if steps is None:
    steps = available[-last_n:]
  if not steps:
    raise ValueError(f"No checkpoints to average in {directory}")
  missing = [s for s in steps if s not in available]
  if missing:
    raise ValueError(f"Steps {missing} not found; available: {available}")
  total: Optional[Dict[str, torch.Tensor]] = None
  for step in steps:
    params = _load_variables(os.path.join(directory, str(step)))
    if total is None:
      total = {k: v.double() for k, v in params.items()}
    else:
      total = {k: total[k] + params[k].double() for k in total}
  return {k: (v / float(len(steps))).float() for k, v in total.items()}
