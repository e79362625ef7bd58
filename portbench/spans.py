"""The port's own spans and counters, laid against a device trace: what
the metrics of source `program_span` and `program_counter` read.

Sources. A `program_span` metric reads spans the port records with its
tracer (`tensor2robot_tpu_torch/obs/trace.py`) while it is on: the
session engine's `serve/session/step` and its six children (admit,
stack, h2d, dispatch, fetch, book), the train step's `train/step`,
`train/gradients` and `train/update`, batch norm's `model/batch_norm`
and `model/batch_norm.backward`. A `program_counter` metric reads a
counter of the port's registry (`obs/metrics.py`) over the same window:
`serve/session/fetched_bytes`.

When. Only a `--trace 1` run reads them. The first reader of a run calls
`serving(run)` or `training(run)`, which measures once, after the cell's
own windows have ended and freed their engine or state, and keeps the
result on the run for the other readers. It measures in a fresh process
(`python3 -c ... spans._child()`, the cell, seed, configuration and
traffic on its standard input, the windows as one JSON line on its
standard output): the cell's device traces leave the profiler's launch
callbacks behind in their process, which slowed the session engine's
dispatch from about 1.1 to 1.6 ms. The child builds the same program,
weights and traffic from the run's seed, warms them and (serving) brings
the fleet to the traffic's spread of depths as the cell's set-up does,
then runs windows with the tracer on. Serving: `trace_seconds` of
lockstep dispatches, with no profiler (its metrics read host spans and a
counter). Training: `enqueue_steps` step calls, each from an idle
device, once with no profiler (the host spans) and once under
`torch.profiler` tracing the device alone (the device time and launches
inside spans; the profiler slows each launch). A port without the spans
(`obs.trace.clock_stamp`) yields None, and its metrics are left out of
the line.

The clock join. The tracer stamps spans with `time.perf_counter_ns`; the
profiler stamps its events on the epoch clock. `obs.trace.clock_stamp()`
reads the pair back to back, and `obs.trace.epoch_ns` maps a span onto
the profiler's clock as ts + (epoch_ns - perf_ns).

Attribution. A device event (kernel, copy, memset) is joined to its
launch, the CUDA runtime call with the same correlation id: the launch's
host time and thread. The launch belongs to the innermost span open on
its own thread at that time. A launch from a thread with no span open
(the autograd engine's device thread running a caller's backward), and
a span opened on such a thread, belong to the innermost span open on
another thread at that time: so the backward's kernels count inside the
caller's `train/gradients` and `train/step`, and batch norm's backward
span sits inside them too. A span's device time and launches are those
it holds and those of the spans inside it.
"""

from __future__ import annotations

import bisect
import dataclasses
import json
import statistics
import subprocess
import sys
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from portbench import harness, weights


@dataclasses.dataclass(frozen=True)
class Span:
  name: str
  start_ns: int  # on the profiler's clock
  end_ns: int
  thread: int  # OS thread id


@dataclasses.dataclass(frozen=True)
class DeviceEvent:
  name: str
  start_ns: int
  end_ns: int
  correlation: int


def _int32(value: int) -> int:
  """The low 32 bits, signed: how a CUDA-only trace stamps a launch's
  thread (its pthread id)."""
  value &= 0xFFFFFFFF
  return value - (1 << 32) if value >= 1 << 31 else value


class SpanTrace:
  """Spans, device events and their launches, and counter deltas, of one
  window."""

  def __init__(self, spans: Sequence[Span], device: Sequence[DeviceEvent],
               launches: Dict[int, Tuple[int, int]],
               counters: Optional[Dict[str, float]] = None,
               aliases: Optional[Dict[int, int]] = None):
    self.spans = sorted(spans, key=lambda s: (s.start_ns, -s.end_ns))
    self.device = list(device)
    self.launches = dict(launches)  # correlation -> (host ns, thread)
    self.counters = dict(counters or {})
    self._aliases = dict(aliases or {})  # a launch's thread -> OS tid
    self._by_thread: Dict[int, List[int]] = {}
    for i, span in enumerate(self.spans):
      self._by_thread.setdefault(span.thread, []).append(i)
    self._starts = {thread: [self.spans[i].start_ns for i in idx]
                    for thread, idx in self._by_thread.items()}
    self._parent = [self._enclosing(s.thread, s.start_ns, s.end_ns, i)
                    for i, s in enumerate(self.spans)]
    self._held = self._attribute()

  def _innermost(self, thread: int, start: int, end: int,
                 skip: int) -> Optional[int]:
    idx = self._by_thread.get(thread)
    if not idx:
      return None
    k = bisect.bisect_right(self._starts[thread], start) - 1
    while k >= 0:
      i = idx[k]
      span = self.spans[i]
      if i != skip and span.start_ns <= start and span.end_ns >= end:
        return i
      k -= 1
    return None

  def _enclosing(self, thread: int, start: int, end: int,
                 skip: int = -1) -> Optional[int]:
    """The innermost span around [start, end] on `thread`, else the
    innermost one on another thread."""
    own = self._innermost(thread, start, end, skip)
    if own is not None:
      return own
    found = [i for i in (self._innermost(t, start, end, skip)
                         for t in self._by_thread if t != thread)
             if i is not None]
    return max(found, key=lambda i: (self.spans[i].start_ns,
                                     -self.spans[i].end_ns), default=None)

  def _attribute(self) -> List[Optional[int]]:
    """The span each device event's launch belongs to (None: outside
    every span, or no launch in the trace)."""
    held = []
    for event in self.device:
      launch = self.launches.get(event.correlation)
      if launch is None:
        held.append(None)
        continue
      at, thread = launch
      held.append(self._enclosing(self._aliases.get(thread, thread), at, at))
    return held

  def _inside(self, i: Optional[int], names: Sequence[str]) -> bool:
    while i is not None:
      if self.spans[i].name in names:
        return True
      i = self._parent[i]
    return False

  def durations_ms(self, name: str) -> List[float]:
    """The durations of the spans named `name`, in order."""
    return [(s.end_ns - s.start_ns) / 1e6 for s in self.spans
            if s.name == name]

  def count(self, name: str) -> int:
    return sum(1 for s in self.spans if s.name == name)

  def launched(self, names: Sequence[str]) -> List[DeviceEvent]:
    """The device events launched inside a span named in `names`."""
    return [event for event, i in zip(self.device, self._held)
            if self._inside(i, names)]

  def device_ms(self, names: Sequence[str]) -> float:
    return sum(e.end_ns - e.start_ns for e in self.launched(names)) / 1e6

  def to_json(self) -> Dict:
    return {"spans": [dataclasses.astuple(s) for s in self.spans],
            "device": [dataclasses.astuple(e) for e in self.device],
            "launches": [[c, at, thread]
                         for c, (at, thread) in self.launches.items()],
            "counters": self.counters,
            "aliases": list(self._aliases.items())}

  @classmethod
  def from_json(cls, data: Dict) -> "SpanTrace":
    return cls([Span(*s) for s in data["spans"]],
               [DeviceEvent(*e) for e in data["device"]],
               {c: (at, thread) for c, at, thread in data["launches"]},
               data["counters"], dict(data["aliases"]))


def median_ms(trace: Optional[SpanTrace], *names: str) -> Optional[float]:
  """The median over occurrences of the summed durations of `names` (one
  of each an occurrence), or None."""
  if trace is None:
    return None
  per_name = [trace.durations_ms(name) for name in names]
  if not per_name[0] or any(len(d) != len(per_name[0]) for d in per_name):
    return None
  return statistics.median(sum(d) for d in zip(*per_name))


def per_step(trace: Optional[SpanTrace], value: Callable[[SpanTrace], float],
             step: str) -> Optional[float]:
  """`value(trace)` per span named `step`, or None where no device event
  of the window was joined to its launch."""
  if trace is None or not trace.count(step) or not any(
      i is not None for i in trace._held):
    return None
  return value(trace) / trace.count(step)


def supported() -> bool:
  """Whether the port records its spans on a clock the profiler can
  join."""
  from tensor2robot_tpu_torch.obs import trace as obs_trace

  return hasattr(obs_trace, "clock_stamp") and hasattr(obs_trace, "phases")


def capture(fn: Callable[[], None], device, counters: Sequence[str] = (),
            device_trace: bool = True) -> SpanTrace:
  """Runs `fn` with the port's tracer on and, with `device_trace` on a
  CUDA device, under `torch.profiler` tracing the device alone; returns
  the window's spans on the profiler's clock, its device events with
  their launches, and the deltas of `counters`."""
  import torch

  from tensor2robot_tpu_torch.obs import metrics as obs_metrics
  from tensor2robot_tpu_torch.obs import trace as obs_trace

  cuda = torch.device(device).type == "cuda"
  profiled = cuda and device_trace
  tracer = obs_trace.get_tracer()
  tracer.clear()
  before = {name: obs_metrics.counter(name).value for name in counters}
  if profiled:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
      tracer.enable()
      try:
        fn()
        torch.cuda.synchronize(device)
      finally:
        tracer.disable()
    kineto = prof.profiler.kineto_results.events()
  else:
    tracer.enable()
    try:
      fn()
      _sync(device)
    finally:
      tracer.disable()
    kineto = []
  stamp = obs_trace.clock_stamp()
  deltas = {name: obs_metrics.counter(name).value - before[name]
            for name in counters}
  spans, aliases = [], {}
  for event in tracer.events():
    if event.get("ph") != "X" or "os_tid" not in event:
      continue
    start = obs_trace.epoch_ns(event["ts"], stamp)
    spans.append(Span(event["name"], start,
                      start + round(event["dur"] * 1000), event["os_tid"]))
    aliases[_int32(event["tid"])] = event["os_tid"]
  tracer.clear()
  device_events, launches = [], {}
  for ev in kineto:
    if ev.device_type() == DeviceType.CUDA:
      if not ev.is_user_annotation():
        device_events.append(DeviceEvent(ev.name(), ev.start_ns(),
                                         ev.start_ns() + ev.duration_ns(),
                                         ev.correlation_id()))
    elif ev.name().startswith("cu") and ev.correlation_id():
      launches[ev.correlation_id()] = (ev.start_ns(),
                                       ev.device_resource_id())
  return SpanTrace(spans, device_events, launches, deltas, aliases)


def _sync(device) -> None:
  import torch

  if torch.device(device).type == "cuda":
    torch.cuda.synchronize(device)


_CHILD = ("import sys; sys.path.insert(0, {root!r}); "
          "from portbench import spans; spans._child()")


def _once(run, kind: str) -> Optional[List[SpanTrace]]:
  """The windows of `kind` ("serving" or "training"), measured once a
  run in a fresh process; None for a port without the spans."""
  if "program_spans" not in run.stats:
    found = None
    if supported():
      request = {"kind": kind, "cell": run.cell, "seed": run.seed,
                 "device": str(run.device), "config": run.config,
                 "traffic": run.traffic}
      child = subprocess.run(
          [sys.executable, "-c", _CHILD.format(root=str(harness.ROOT))],
          input=json.dumps(request), stdout=subprocess.PIPE, text=True,
          cwd=harness.ROOT, check=False)
      if child.returncode != 0:
        raise RuntimeError(f"the {kind} span window exited "
                           f"{child.returncode}")
      found = [SpanTrace.from_json(window) for window in
               json.loads(child.stdout.strip().splitlines()[-1])]
    run.stats["program_spans"] = found
  return run.stats["program_spans"]


def serving(run) -> Optional[SpanTrace]:
  """The session engine's spans over `trace_seconds` of lockstep
  dispatches, and `serve/session/fetched_bytes` over them."""
  found = _once(run, "serving")
  return None if found is None else found[0]


def training(run, device_trace: bool = False) -> Optional[SpanTrace]:
  """The train step's spans over `enqueue_steps` step calls, each from
  an idle device: with `device_trace`, from a second such loop under the
  profiler, with the device events and their launches."""
  found = _once(run, "training")
  return None if found is None else found[int(device_trace)]


def _child() -> None:
  """A span window's process: the request on standard input, the
  windows as one JSON line on standard output."""
  import torch

  request = json.loads(sys.stdin.read())
  device = torch.device(request["device"])
  if device.type == "cuda":
    torch.cuda.set_device(device)
  run = harness.prepare(request["cell"], request["seed"], 0.0, True, device,
                        time.perf_counter())
  run.config, run.traffic = request["config"], request["traffic"]
  measure = {"serving": _measure_serving, "training": _measure_training}
  windows = measure[request["kind"]](run)
  print(json.dumps([window.to_json() for window in windows]), flush=True)


def _measure_serving(run) -> List[SpanTrace]:
  cfg, traffic, device = run.config, run.traffic, run.device
  lockstep = harness.load_module("drivers", traffic["driver"])
  model, params, table = lockstep.inputs(run)
  engine = run.program.build_engine(cfg, traffic, model, params, device)
  engine.warmup()
  fleet = lockstep._Fleet(engine, table, traffic["episode_ticks"])
  every = np.arange(traffic["robots"])
  target = traffic["stagger_ticks"] * every
  for depth in range(int(target.max())):
    fleet.tick(every[target > depth])
  _sync(device)

  def window():
    opened = time.perf_counter()
    while time.perf_counter() - opened < traffic["trace_seconds"]:
      fleet.tick(every)

  return [capture(window, device, counters=["serve/session/fetched_bytes"],
                  device_trace=False)]


def _measure_training(run) -> List[SpanTrace]:
  import torch

  from tensor2robot_tpu_torch.parallel import train_step as ts

  cfg, traffic, device, prog = run.config, run.traffic, run.device, run.program
  generator = torch.Generator(device=device).manual_seed(run.seed)
  model = prog.build_model(cfg, "train")
  shapes = {k: tuple(v.shape) for k, v in model.module.named_parameters()}
  params = weights.draw(shapes, cfg["init"]["kernel"], generator, device)
  rotation = traffic["rotation"]
  batches = [prog.make_batch(cfg, model, traffic["batch_size"], generator,
                             device) for _ in range(rotation)]
  state = ts.init_train_state(model, params)
  step = ts.make_train_step(model)
  for i in range(traffic["warmup_steps"] + 1):
    state, _ = step(state, *batches[i % rotation])

  def window():
    nonlocal state
    for i in range(traffic["enqueue_steps"]):
      _sync(device)
      state, _ = step(state, *batches[i % rotation])

  return [capture(window, device, device_trace=False),
          capture(window, device)]
