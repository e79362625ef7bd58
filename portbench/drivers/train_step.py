"""Traffic kind `train_step`: the port's train step, driven back to back
on a rotation of batches made on the device.

Set-up builds one train state (the benchmark's weights from the seed,
`init_train_state`'s optimizer state and EMA shadow) and one
`make_train_step` step, the step `train_eval_model` calls, eager. It
drives that step through its first three steps on three distinct
batches, keeping what the comparison reads (the losses, the first
gradient from the optimizer's state, the state after step 3), and
`warmup_steps` more. The window then calls the same step on the same
state, one batch after the other, with no sync until it closes: losses
stay on the device. With `trace` it also times `enqueue_steps` single
step calls from an idle device (the host's enqueue), traces the device
over `trace_seconds` of steps, and traces `gap_calls` more steps with
the host's ops, to name what the host did in the idle gaps.

After the window, with the program's state freed, the reference runs
the same three steps from the same weights on the same batches, and
`compare.train_numbers` holds the program's readings against it.
"""

from __future__ import annotations

import time
from typing import Any, Dict

import torch
from torch.profiler import record_function

from portbench import compare, precision, profiling, weights
from tensor2robot_tpu_torch.parallel import train_step as ts


def _clone(tree):
  return None if tree is None else {k: v.detach().clone()
                                    for k, v in tree.items()}


def _sync(device) -> None:
  if torch.device(device).type == "cuda":
    torch.cuda.synchronize(device)


def start(run) -> Dict[str, Any]:
  """Set-up up to the comparison's readings: the model, the weights, the
  batches, the state, the step, and the program's readings of its first
  three steps; `calls` steps have run."""
  cfg, traffic, device, prog = run.config, run.traffic, run.device, run.program
  generator = torch.Generator(device=device).manual_seed(run.seed)
  model = prog.build_model(cfg, "train")
  shapes = {k: tuple(v.shape) for k, v in model.module.named_parameters()}
  params = weights.draw(shapes, cfg["init"]["kernel"], generator, device)
  batches = [prog.make_batch(cfg, model, traffic["batch_size"], generator,
                             device) for _ in range(traffic["rotation"])]
  run.mark("inputs")
  state = ts.init_train_state(model, params)
  params0, mutable0 = _clone(state.params), _clone(state.mutable_state)
  step = ts.make_train_step(model)

  state, metrics = step(state, *batches[0])
  first = _clone(prog.first_gradient(cfg, state.opt_state, params0))
  losses = [metrics["loss"]]
  for i in (1, 2):
    state, metrics = step(state, *batches[i])
    losses.append(metrics["loss"])
  after = {"params": _clone(state.params), "ema": _clone(state.ema_params),
           "mutable": _clone(state.mutable_state)}
  run.mark("first_steps")
  return {"state": state, "step": step, "batches": batches, "calls": 3,
          "params0": params0, "mutable0": mutable0,
          "program": {"losses": [float(x) for x in losses],
                      "first_gradient": first, "after": after}}


def reference_numbers(run, readings: Dict[str, Any], params0, mutable0,
                      batches) -> Dict[str, float]:
  """`readings` held against the float32 reference's three steps."""
  with precision.exact_float32():
    reference = run.reference.train_readings(params0, mutable0, batches,
                                              run.config)
  return compare.train_numbers(readings, reference, params0, mutable0)


def run(run) -> None:
  traffic, device = run.traffic, run.device
  begun = start(run)
  state, step, batches = begun["state"], begun["step"], begun["batches"]
  rotation, batch = traffic["rotation"], traffic["batch_size"]
  calls = begun["calls"]
  for _ in range(traffic["warmup_steps"]):
    state, _ = step(state, *batches[calls % rotation])
    calls += 1
  _sync(device)
  run.setup_s = time.perf_counter() - run.t_start

  window_losses, starts = [], []
  opened = time.perf_counter()
  while time.perf_counter() - opened < run.seconds:
    starts.append(time.perf_counter() - opened)
    state, metrics = step(state, *batches[calls % rotation])
    window_losses.append(metrics["loss"])
    calls += 1
  _sync(device)
  run.stats.update(steps=len(window_losses), batch=batch,
                   window_s=time.perf_counter() - opened,
                   per_2s=[int(n) for n in torch.bincount(torch.tensor(
                       starts).div(2).long()).tolist()])
  run.attempted = len(window_losses)

  if run.trace:
    enqueue = []
    for _ in range(traffic["enqueue_steps"]):
      _sync(device)
      t = time.perf_counter()
      state, _ = step(state, *batches[calls % rotation])
      enqueue.append(time.perf_counter() - t)
      calls += 1
    _sync(device)
    run.stats["enqueue_s"] = enqueue
    traced = []

    def steps(seconds=None, count=None):
      def body():
        nonlocal state, calls
        t = time.perf_counter()
        while (count is None and time.perf_counter() - t < seconds) or (
            count is not None and len(traced) < count):
          with record_function("portbench/train_step"):
            state, _ = step(state, *batches[calls % rotation])
          calls += 1
          traced.append(1)
      return body

    run.trace_summary = profiling.trace_window(
        steps(seconds=traffic["trace_seconds"]))
    run.stats["traced_steps"] = len(traced)
    traced.clear()
    run.gap_trace = profiling.trace_window(steps(count=traffic["gap_calls"]),
                                           host=True)

  if torch.device(device).type == "cuda":
    run.memory_peak_bytes = torch.cuda.max_memory_allocated(device)
  finite = torch.isfinite(torch.stack(window_losses)) if window_losses \
      else torch.ones(0, dtype=torch.bool)
  nonfinite = int((~finite).sum())
  del state, window_losses, step, begun["state"], begun["step"]
  if torch.device(device).type == "cuda":
    torch.cuda.empty_cache()
  run.numbers = reference_numbers(run, begun["program"], begun["params0"],
                                  begun["mutable0"], batches[:3])
  run.numbers["nonfinite_losses"] = nonfinite
