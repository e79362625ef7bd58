"""graftcache, the port's `obs/excache.py`, on the CPU.

The JAX package's `tests/test_excache.py` holds its serialized-executable
tier; two of its cases fail on the JAX side in every run here, so only
the backend-free parts are compared: the sidecar and blob layout, read by
the JAX package's own `ExecutableCache.entries` / `verify` / `evict`.

* Key discipline: one key for one step in two fresh processes; a
  different key when any component changes (shape, dtype, device,
  versions, the kernel sources' hash, the model, the in-place layout,
  the mesh); a number leaf (a state's step count) keys by its type only.
* Layout: `<key>.json` (strict JSON) beside `<key>.bin`; `verify` and
  `evict` (by key, by name prefix, by age, all); an orphan blob listed
  and collected; a corrupt blob quarantined on load, counted, and
  compiled fresh and stored again.
* The round trip: with Inductor on the CPU (the one test that runs it),
  a process stores a compiled function's artifacts and a second process,
  with an empty Inductor directory of its own, hits the entry, loads a
  non-empty blob and computes the same output.
"""

import json
import os
import pathlib
import shutil
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from tensor2robot_tpu.obs import excache as jax_excache
from tensor2robot_tpu_torch.models import sequence_model
from tensor2robot_tpu_torch.obs import excache
from tensor2robot_tpu_torch.obs import metrics as metrics_lib
from tensor2robot_tpu_torch.obs import xray

torch.set_num_threads(1)
REPO_ROOT = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def _isolated_registry():
  with metrics_lib.isolated():
    xray.clear_records()
    yield
  xray.clear_records()


def _key(args, **kwargs):
  components = excache.key_components(args, backend="aot_eager", **kwargs)
  return excache.cache_key("step", **components), components


def test_each_component_changes_the_key():
  x = torch.zeros(2, 3)
  base, components = _key((x,))
  assert base.startswith("step-") and len(base) == len("step-") + 32
  assert _key((torch.zeros(2, 4),))[0] != base  # shape
  assert _key((torch.zeros(2, 3, dtype=torch.float64),))[0] != base
  assert _key((x,), donate_argnums=(0,))[0] != base  # in-place layout
  for field in ("device", "versions", "kernels", "mesh", "model"):
    changed = dict(components, **{field: components[field] + "!"})
    assert excache.cache_key("step", **changed) != base, field
  assert excache.cache_key("other", **components) != base
  small = sequence_model.SequenceRegressionModel(hidden_size=16, num_heads=2)
  wide = sequence_model.SequenceRegressionModel(hidden_size=32, num_heads=2)
  assert _key((x,), model=small)[0] != _key((x,), model=wide)[0]
  # A state's step count compiles the same step: its type is keyed.
  assert _key((x, 3))[0] == _key((x, 7))[0] != _key((x, 3.0))[0]
  assert excache.device_fingerprint("cpu") == "cpu"
  assert "backend=aot_eager" in components["versions"]


def test_the_kernel_fingerprint_follows_the_sources(tmp_path, monkeypatch):
  package = tmp_path / "pkg"
  for sub in ("csrc", "ops"):
    shutil.copytree(REPO_ROOT / "tensor2robot_tpu_torch" / sub,
                    package / sub,
                    ignore=shutil.ignore_patterns("__pycache__"))
  monkeypatch.setattr(excache, "_PACKAGE", package)
  before = excache.kernel_fingerprint()
  source = package / "csrc" / "decode_tick.cu"
  source.write_text(source.read_text() + "\n// edited\n")
  assert excache.kernel_fingerprint() != before


def test_one_key_in_two_processes():
  code = textwrap.dedent("""
      import torch
      from tensor2robot_tpu_torch.models import sequence_model
      from tensor2robot_tpu_torch.obs import excache
      from tensor2robot_tpu_torch.parallel import train_step
      model = sequence_model.SequenceRegressionModel(
          hidden_size=16, num_heads=2, sequence_length=8)
      state = train_step.create_train_state(
          model, torch.Generator().manual_seed(0), 'cpu')
      args = (state, {'observation': torch.zeros(2, 8, 8)})
      print(excache.cache_key('train_step', **excache.key_components(
          args, model=model, backend='aot_eager')))
      """)
  keys = [subprocess.run([sys.executable, "-c", code], cwd=REPO_ROOT,
                         capture_output=True, text=True, check=True,
                         timeout=120).stdout.strip() for _ in range(2)]
  assert keys[0] == keys[1] and keys[0].startswith("train_step-")


def _stored_cache(directory):
  """A cache with one compiled entry (`aot_eager`: an empty blob)."""
  torch._dynamo.reset()
  fn = xray.XrayedFunction("serve/probe", lambda t: torch.tanh(t) * 3,
                           cache=str(directory))
  out = fn(torch.arange(4.0))
  return fn, out


def test_layout_verify_and_evict_read_by_both_packages(tmp_path):
  fn, _ = _stored_cache(tmp_path)
  key = fn.record["cache"]["key"]
  assert fn.record["cache"] == {"hit": False, "key": key, "stored": True,
                                "bytes": 0}
  assert sorted(os.listdir(tmp_path)) == [key + ".bin", key + ".json"]
  with open(tmp_path / (key + ".json")) as f:
    meta = json.load(f)
  assert meta["name"] == "serve/probe" and meta["blob_bytes"] == 0
  assert meta["record"]["compile_s"] > 0 and "cache" not in meta["record"]
  snapshot = metrics_lib.snapshot(prefix="cache/")
  assert snapshot["counter/cache/stores"] == 1
  assert snapshot["counter/cache/bypassed"] == 1
  for cache in (excache.ExecutableCache(str(tmp_path)),
                jax_excache.ExecutableCache(str(tmp_path))):
    (entry,) = cache.entries()
    assert entry["key"] == key and entry["blob_present"]
    assert cache.verify() == ([key], [])
  (tmp_path / "orphan.bin").write_bytes(b"xyz")
  cache = excache.ExecutableCache(str(tmp_path))
  assert cache.verify() == ([key], ["orphan"])
  assert jax_excache.ExecutableCache(str(tmp_path)).verify() == (
      [key], ["orphan"])
  assert cache.evict(name_prefix="nothing/") == 0
  assert cache.evict(key="orphan") == 1
  assert cache.evict(older_than_secs=3600) == 0
  assert cache.evict(name_prefix="serve/") == 1
  assert cache.entries() == []
  _stored_cache(tmp_path)
  (tmp_path / "inductor").mkdir()
  assert cache.evict() == 1 and not (tmp_path / "inductor").exists()


def test_a_corrupt_blob_is_quarantined_and_compiled_fresh(tmp_path):
  fn, want = _stored_cache(tmp_path)
  key = fn.record["cache"]["key"]
  (tmp_path / (key + ".bin")).write_bytes(b"torn")
  assert excache.ExecutableCache(str(tmp_path)).verify() == ([], [key])
  torch._dynamo.reset()
  again = xray.XrayedFunction("serve/probe", lambda t: torch.tanh(t) * 3,
                              cache=str(tmp_path))
  assert torch.equal(again(torch.arange(4.0)), want)
  snapshot = metrics_lib.snapshot(prefix="cache/")
  assert snapshot["counter/cache/corrupt_entries"] == 1
  assert snapshot["counter/cache/stores"] == 2
  assert again.record["cache"]["hit"] is False
  assert excache.ExecutableCache(str(tmp_path)).verify() == ([key], [])
  # And a hit from the fresh entry after that.
  torch._dynamo.reset()
  third = xray.XrayedFunction("serve/probe", lambda t: torch.tanh(t) * 3,
                              cache=str(tmp_path))
  third(torch.arange(4.0))
  assert third.record["cache"]["hit"] is True


_ROUND_TRIP = textwrap.dedent("""
    import json, sys
    import torch
    from tensor2robot_tpu_torch.obs import metrics, xray
    torch.set_num_threads(1)
    xray.COMPILE_BACKENDS['cpu'] = 'inductor'

    def step(x, w):
      return torch.relu(x @ w).sum(dim=0) * 0.5

    fn = xray.XrayedFunction('round_trip', step, cache=sys.argv[1])
    out = fn(torch.ones(4, 8), torch.full((8, 8), 0.25))
    print(json.dumps({'out': out.tolist(), 'cache': fn.record['cache'],
                      'compiled': fn.compiled,
                      'counters': metrics.snapshot(prefix='cache/')}))
    """)


def test_an_inductor_entry_stored_in_one_process_hits_in_another(tmp_path):
  cache_dir = tmp_path / "excache"
  results = []
  for name in ("cold", "warm"):
    env = dict(os.environ, TORCHINDUCTOR_CACHE_DIR=str(tmp_path / name),
               OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", _ROUND_TRIP,
                           str(cache_dir)], cwd=REPO_ROOT, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    results.append(json.loads(proc.stdout.strip().splitlines()[-1]))
  cold, warm = results
  assert cold["compiled"] and warm["compiled"]
  assert cold["cache"]["hit"] is False and cold["cache"]["stored"]
  assert cold["cache"]["bytes"] > 0  # Inductor left artifacts
  assert warm["cache"]["hit"] is True
  assert warm["cache"]["bytes"] == cold["cache"]["bytes"]
  assert warm["counters"]["counter/cache/hits"] == 1
  assert warm["out"] == cold["out"] == [4.0] * 8
