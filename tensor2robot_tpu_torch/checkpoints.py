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
Saves are synchronous.
"""

from __future__ import annotations

import json
import logging
import os
import shutil
import time
import zlib
from typing import Dict, List, Optional

import torch

from tensor2robot_tpu_torch.obs import metrics as metrics_lib
from tensor2robot_tpu_torch.parallel import train_step as ts

__all__ = ["CheckpointManager", "CheckpointCorruptionError",
           "CHECKPOINT_DIRNAME", "MANIFEST_DIRNAME", "QUARANTINE_DIRNAME",
           "MANIFEST_SCHEMA", "STATE_FILENAME"]

# A trainer's checkpoints live in <model_dir>/checkpoints.
CHECKPOINT_DIRNAME = "checkpoints"
MANIFEST_DIRNAME = "manifests"
QUARANTINE_DIRNAME = "quarantine"
MANIFEST_SCHEMA = "graftguard-manifest-v1"
STATE_FILENAME = "state.pt"

_log = logging.getLogger(__name__)


class CheckpointCorruptionError(RuntimeError):
  """A checkpoint failed verification (or its load) and no intact
  fallback step exists."""


def _file_crc32(path: str) -> int:
  crc = 0
  with open(path, "rb") as f:
    for chunk in iter(lambda: f.read(1 << 20), b""):
      crc = zlib.crc32(chunk, crc)
  return crc & 0xFFFFFFFF


def _step_files(step_dir: str) -> List[str]:
  """Relative paths of every file under a step dir, sorted."""
  out: List[str] = []
  for dirpath, dirnames, filenames in os.walk(step_dir):
    dirnames.sort()
    for name in sorted(filenames):
      out.append(os.path.relpath(os.path.join(dirpath, name), step_dir))
  return out


class CheckpointManager:
  """Saves and restores `TrainState`s under one directory."""

  def __init__(self, directory: str, max_to_keep: int = 5):
    self._directory = os.path.abspath(directory)
    os.makedirs(self._directory, exist_ok=True)
    self._max_to_keep = max_to_keep
    # The step the most recent restore() returned (the fallback walk may
    # land below the newest step).
    self.last_restored_step: Optional[int] = None

  def _step_dir(self, step: int) -> str:
    return os.path.join(self._directory, str(int(step)))

  def _manifest_path(self, step: int) -> str:
    return os.path.join(self._directory, MANIFEST_DIRNAME, f"{int(step)}.json")

  def all_steps(self) -> List[int]:
    """Steps on disk (digit-named directories), oldest first."""
    return sorted(int(name) for name in os.listdir(self._directory)
                  if name.isdigit()
                  and os.path.isdir(os.path.join(self._directory, name)))

  def latest_step(self) -> Optional[int]:
    steps = self.all_steps()
    return steps[-1] if steps else None

  # -- save ------------------------------------------------------------------

  def save(self, step: int, state: ts.TrainState) -> bool:
    """Writes `state` as step `step`, then its manifest, then drops the
    oldest steps past `max_to_keep`. False (nothing written) when the
    step is already on disk."""
    step = int(step)
    final = self._step_dir(step)
    if os.path.isdir(final):
      return False
    tmp = os.path.join(self._directory, f".{step}.tmp-{os.getpid()}")
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    cpu = state.to("cpu")
    payload = {"step": int(state.step), "params": cpu.params,
               "ema_params": cpu.ema_params, "opt_state": cpu.opt_state,
               "mutable_state": cpu.mutable_state}
    path = os.path.join(tmp, STATE_FILENAME)
    with open(path, "wb") as f:
      torch.save(payload, f)
      f.flush()
      os.fsync(f.fileno())
    os.replace(tmp, final)
    self._write_manifest(step)
    metrics_lib.counter("ckpt/saves").inc()
    self._prune()
    return True

  def _write_manifest(self, step: int) -> None:
    step_dir = self._step_dir(step)
    files: Dict[str, Dict[str, int]] = {}
    for rel in _step_files(step_dir):
      full = os.path.join(step_dir, rel)
      files[rel] = {"size": os.path.getsize(full), "crc32": _file_crc32(full)}
    manifest = {"schema": MANIFEST_SCHEMA, "schema_version": 1,
                "step": int(step), "files": files}
    path = self._manifest_path(step)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
      json.dump(manifest, f, sort_keys=True)
      f.flush()
      os.fsync(f.fileno())
    os.replace(tmp, path)

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
    """True when every file the manifest lists is present with its size
    and crc32; False on a mismatch (counted `ckpt/verify_failures`);
    None when the step has no readable manifest."""
    try:
      with open(self._manifest_path(step)) as f:
        listed = json.load(f)["files"]
    except (OSError, ValueError, KeyError, TypeError):
      return None
    step_dir = self._step_dir(step)
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

  def latest_verified_step(self) -> Optional[int]:
    """Newest step that does not fail verification."""
    for step in reversed(self.all_steps()):
      if self.verify_step(step) is not False:
        return step
    return None

  def _quarantine(self, step: int, reason: str) -> None:
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

  def restore(self, step: Optional[int] = None,
              device=None) -> ts.TrainState:
    """Restores `step`, or with None the newest step that verifies and
    loads, onto `device` (the CPU by default). A step failing its
    manifest, or failing to load without a clean manifest and looking
    torn, is quarantined: then `step=None` falls back to the next newest
    and an explicit step raises `CheckpointCorruptionError`. A load
    failure of a step whose manifest verified is re-raised. An explicit
    step not on disk raises FileNotFoundError."""
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
