"""Runs a function on every rank of a CPU gloo world, for the port's
mesh tests (tests/test_torch_{mesh,sequence_parallel,multihost}.py); it
holds no test itself.

`run_world(world_size, target, payload, directory)` (or `World(...)`,
then `.results()`, to overlap the ranks with other work) starts `world_size`
fresh interpreters (never a fork of a process where JAX has started),
each running this file: it brings the world up through the port's
`initialize_multihost(backend='gloo')`, calls `target(rank,
world_size, payload)` ("module:function", importable from the repo
root) and pickles what it returns to `<directory>/rank<r>.pkl`. The
parent returns the ranks' results in rank order, and raises with a
rank's output when it exits non-zero or writes no result.

Inputs and results are plain Python and numpy: weights come across from
the JAX side as numpy through `tensor2robot_tpu_torch.bridge`.
"""

import importlib
import os
import pickle
import socket
import subprocess
import sys
import time

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def free_port() -> int:
  with socket.socket() as s:
    s.bind(("127.0.0.1", 0))
    return s.getsockname()[1]


class World:
  """A started world: `results()` waits for its ranks and returns what
  each returned, in rank order."""

  def __init__(self, world_size: int, target: str, payload, directory,
               timeout: float = 240.0, env=None):
    self._directory = str(directory)
    os.makedirs(self._directory, exist_ok=True)
    with open(os.path.join(self._directory, "payload.pkl"), "wb") as f:
      pickle.dump(payload, f)
    port = free_port()
    child_env = {**os.environ, "PYTHONPATH": REPO_ROOT,
                 "OMP_NUM_THREADS": "1", **(env or {})}
    self._deadline = time.monotonic() + timeout
    # Each rank's output goes to a file: an unread pipe would block it.
    self._logs = [os.path.join(self._directory, f"rank{rank}.log")
                  for rank in range(world_size)]
    self._procs = []
    for rank, log in enumerate(self._logs):
      with open(log, "w") as out:
        self._procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), target, str(rank),
             str(world_size), str(port), self._directory],
            stdout=out, stderr=subprocess.STDOUT, env=child_env,
            cwd=REPO_ROOT))

  def _output(self, rank: int) -> str:
    with open(self._logs[rank]) as f:
      return f.read()[-6000:]

  def results(self):
    for rank, proc in enumerate(self._procs):
      try:
        proc.wait(timeout=max(1.0, self._deadline - time.monotonic()))
      except subprocess.TimeoutExpired:
        for p in self._procs:
          p.kill()
          p.wait()
        raise AssertionError(f"rank {rank} timed out:\n{self._output(rank)}")
    results = []
    for rank, proc in enumerate(self._procs):
      path = os.path.join(self._directory, f"rank{rank}.pkl")
      if proc.returncode != 0 or not os.path.exists(path):
        raise AssertionError(f"rank {rank} exited {proc.returncode}:\n"
                             f"{self._output(rank)}")
      with open(path, "rb") as f:
        results.append(pickle.load(f))
    return results


def run_world(world_size: int, target: str, payload, directory,
              timeout: float = 240.0, env=None):
  """The results of `target` on each rank of a `world_size` gloo world."""
  return World(world_size, target, payload, directory, timeout,
               env).results()


def _main(argv) -> int:
  target, rank, world_size, port, directory = argv
  rank, world_size = int(rank), int(world_size)
  import torch

  torch.set_num_threads(1)
  from tensor2robot_tpu_torch.parallel import mesh as mesh_lib

  mesh_lib.initialize_multihost(f"127.0.0.1:{port}", world_size, rank,
                                initialization_timeout_secs=120,
                                backend="gloo")
  with open(os.path.join(directory, "payload.pkl"), "rb") as f:
    payload = pickle.load(f)
  module_name, fn_name = target.split(":")
  result = getattr(importlib.import_module(module_name), fn_name)(
      rank, world_size, payload)
  with open(os.path.join(directory, f"rank{rank}.pkl.tmp"), "wb") as f:
    pickle.dump(result, f)
  os.replace(os.path.join(directory, f"rank{rank}.pkl.tmp"),
             os.path.join(directory, f"rank{rank}.pkl"))
  torch.distributed.destroy_process_group()
  return 0


if __name__ == "__main__":
  sys.path.insert(0, REPO_ROOT)
  sys.exit(_main(sys.argv[1:]))
