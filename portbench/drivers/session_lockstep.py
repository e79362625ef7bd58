"""Traffic kind `session_lockstep`: `robots` simulated robots stepped in
lockstep from one loop through the port's `SessionEngine.step_many`, as
a vectorised evaluation or rollout of a policy steps its sim robots.

Each robot runs episodes of `episode_ticks` ticks as one session; at an
episode's end its session is closed and a new one opened. Observations
come from one table drawn on the device from the seed: robot r's
episode e reads row (r + e) mod robots, tick by tick. Set-up warms the
engine and brings robot r's first session to depth `stagger_ticks` * r
through `step_many`, so the depths in every dispatch stay spread over
the horizon. The window then steps every robot once a dispatch, and
records what was served in preallocated arrays (`_Log`).
`control_p95_ms` takes each dispatch's `step_many` wall once for each
robot in it. With `trace` the device is traced over a further
`trace_seconds` of dispatches, and `gap_calls` more with the host's ops,
to name what the host did in the idle gaps.

After the window, with the engine freed, the reference computes every
table row's full-prefix forward once, and every answer served in the
window (and in the traced dispatches) is compared with the reference's
action at its row and depth.
"""

from __future__ import annotations

import time

import numpy as np
import torch
from torch.profiler import record_function

from portbench import compare, precision, profiling, weights


def _sync(device) -> None:
  if torch.device(device).type == "cuda":
    torch.cuda.synchronize(device)


class _Fleet:
  """The robots' sessions, table rows and depths."""

  def __init__(self, engine, table: np.ndarray, episode_ticks: int):
    self.engine, self.table, self.horizon = engine, table, episode_ticks
    robots = table.shape[0]
    self.sid = np.array([engine.open() for _ in range(robots)])
    self.episode = np.zeros(robots, np.int64)
    self.row = np.arange(robots)
    self.depth = np.zeros(robots, np.int64)

  def tick(self, robots) -> np.ndarray:
    """One `step_many` of `robots`, as the caller of a vectorised
    rollout makes it (the observations gathered, the items built, the
    actions read back, ended episodes re-opened); returns the actions."""
    obs = self.table[self.row[robots], self.depth[robots]]
    items = [(sid, {"observation": o})
             for sid, o in zip(self.sid[robots].tolist(), obs)]
    answers = self.engine.step_many(items)
    actions = np.stack([a["action"] for a in answers])
    self.depth[robots] += 1
    for r in np.flatnonzero(self.depth == self.horizon):
      self.engine.close_session(int(self.sid[r]))
      self.sid[r] = self.engine.open()
      self.episode[r] += 1
      self.row[r] = (r + self.episode[r]) % len(self.row)
      self.depth[r] = 0
    return actions


class _Log:
  """What the window served, for the comparison after it: rows, depths,
  actions, start and wall of each dispatch, written into preallocated
  blocks of `block` dispatches. A dispatch adds no object that outlives
  it, so the harness's record neither grows the garbage collector's work
  nor takes more time as the window goes on."""

  def __init__(self, robots: int, actions: int, block: int = 4096):
    self.robots, self.actions, self.block = robots, actions, block
    self.blocks, self.n = [], 0

  def _new_block(self):
    b, r = self.block, self.robots
    self.blocks.append({"rows": np.empty((b, r), np.int64),
                        "depths": np.empty((b, r), np.int64),
                        "actions": np.empty((b, r, self.actions),
                                            np.float32),
                        "start": np.empty(b), "wall": np.empty(b)})

  def add(self, fleet: _Fleet, robots, opened: float) -> None:
    """Ticks `robots` of `fleet` (one dispatch) and records it; only the
    tick is timed."""
    i = self.n % self.block
    if i == 0:
      self._new_block()
    b = self.blocks[-1]
    b["rows"][i] = fleet.row[robots]
    b["depths"][i] = fleet.depth[robots]
    t = time.perf_counter()
    b["actions"][i] = fleet.tick(robots)
    b["wall"][i] = time.perf_counter() - t
    b["start"][i] = t - opened
    self.n += 1

  def get(self, key: str, start: int = 0) -> np.ndarray:
    """`key` of dispatches `start` onward, in order."""
    whole = np.concatenate([b[key] for b in self.blocks])[:self.n] \
        if self.blocks else np.empty((0,))
    return whole[start:]


def inputs(run):
  """(model, weights, observation table) of the run's seed."""
  cfg, traffic, device = run.config, run.traffic, run.device
  generator = torch.Generator(device=device).manual_seed(run.seed)
  model = run.program.build_model(cfg, "serve")
  shapes = {k: tuple(v.shape) for k, v in model.module.named_parameters()}
  params = weights.draw(shapes, cfg["init"]["kernel"], generator, device)
  table = torch.randn((traffic["robots"], traffic["episode_ticks"],
                       cfg["model"]["obs_size"]), generator=generator,
                      device=device).cpu().numpy()
  return model, params, table


def reference_actions(run, params, table: np.ndarray, mode: str = "float32"
                      ) -> np.ndarray:
  """[robots, ticks, action]: the reference's action at every position of
  every table row (its full-prefix forward)."""
  with precision.exact_float32():
    return run.reference.serve_outputs(
        params, torch.from_numpy(table).to(run.device), run.config,
        mode).cpu().numpy()


def run(run) -> None:
  cfg, traffic, device, prog = run.config, run.traffic, run.device, run.program
  model, params, table = inputs(run)
  robots, horizon = traffic["robots"], traffic["episode_ticks"]
  run.mark("inputs")
  engine = prog.build_engine(cfg, traffic, model, params, device)
  engine.warmup()
  run.mark("warmup")
  fleet = _Fleet(engine, table, horizon)
  every = np.arange(robots)
  target = traffic["stagger_ticks"] * every
  for depth in range(int(target.max())):
    fleet.tick(every[target > depth])
  _sync(device)
  run.setup_s = time.perf_counter() - run.t_start

  log = _Log(robots, cfg["model"]["action_size"])
  opened = time.perf_counter()
  while time.perf_counter() - opened < run.seconds:
    log.add(fleet, every, opened)
  window_s = time.perf_counter() - opened
  dispatches = log.n
  run.stats.update(window_s=window_s, dispatches=dispatches, robots=robots,
                   latencies_s=log.get("wall").tolist(),
                   depths=list(log.get("depths")),
                   per_2s=np.bincount((log.get("start") // 2).astype(int))
                   .tolist())
  run.attempted = robots * dispatches

  if run.trace:
    def ticks(seconds=None, count=None):
      def body():
        t, first = time.perf_counter(), log.n
        while (count is None and time.perf_counter() - t < seconds) or (
            count is not None and log.n - first < count):
          with record_function("portbench/step_many"):
            log.add(fleet, every, t)
      return body

    first = log.n
    run.trace_summary = profiling.trace_window(
        ticks(seconds=traffic["trace_seconds"]))
    run.stats["traced_depths"] = list(log.get("depths", first))
    run.gap_trace = profiling.trace_window(ticks(count=traffic["gap_calls"]),
                                           host=True)

  if torch.device(device).type == "cuda":
    run.memory_peak_bytes = torch.cuda.max_memory_allocated(device)
  del fleet, engine, model
  if torch.device(device).type == "cuda":
    torch.cuda.empty_cache()
  reference = reference_actions(run, params, table)
  rows, at = log.get("rows").ravel(), log.get("depths").ravel()
  answers = log.get("actions").reshape(-1, log.actions)
  run.numbers = compare.serve_numbers(answers, reference[rows, at])
