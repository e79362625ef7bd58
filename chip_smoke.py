#!/usr/bin/env python3
"""Drives the PyTorch port (`tensor2robot_tpu_torch`) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero
and prints no result):

1. Device: the card's name and power limit (nvidia-smi); the CUDA kernels
   built from `tensor2robot_tpu_torch/csrc/` with nvcc.
2. Kernels against their plain PyTorch versions at the served shapes:
   the decode tick on an f32 [65, 4096, 8, 64] arena (B = 1 and 8, indices
   0, tile edges, mixed progress and 4095, pad lanes on the null slot; the
   update must be in place and every untouched row bit-identical), and the
   flash forward (B = 2, H = 8, D = 64, T = 4096 and a non-tiling 1000,
   causal and not, f32 and bf16; O and lse).
3. The slice: the causal sequence policy at the long-context widths of
   `tensor2robot_tpu_torch/configs/serve_session.gin`, random weights
   from seed 0, served CheckpointPredictor -> SessionEngine ->
   SessionBatcher -> SessionRegressionPolicy: 16 concurrent episodes of 48
   ticks, and one session run to the 4096-tick horizon whose every tick
   must match the stateless flash predict of the same sequence; its
   4097th tick must raise SessionHorizonError. One bf16 predict must be
   finite. Both kernels' launch counts must grow during this phase.
4. Timings with CUDA events (L2 flushed before every timed call) of each
   kernel, its plain version and, for the flash forward,
   `scaled_dot_product_attention` as a yardstick the port never calls;
   each kernel's bound: max(bytes / 3.35 TB/s, flops / peak rate of the
   dtype) with the H100 SXM data-sheet peaks.

Output: a `kernels` JSON line, a `slice` JSON line, the card line, and as
the last line `{"ok": true, "device": {...}}`. The same numbers go to
`chiprun_out/chip_smoke_report.json`.
"""

import json
import os
import subprocess
import sys
import threading
import time

# H100 SXM data-sheet peaks (dense).
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
# Tolerances against the plain versions on the same inputs:
# f32: both sides accumulate in f32 and differ only in summation order
#   and exp rounding, ~1e-6 relative on values of order 1-10.
F32_TOL = 1e-4
# bf16: inputs and outputs carry 8 mantissa bits (relative step 2^-8 =
#   3.9e-3), and the kernel rounds P to bf16 before the PV product as the
#   TPU kernel does; outputs of order 1 then differ by a few 1e-3.
BF16_TOL = 3e-2

SESSION_CONFIG = "tensor2robot_tpu_torch/configs/serve_session.gin"
REPORT = "chiprun_out/chip_smoke_report.json"


def log(msg: str) -> None:
  print(f"[chip_smoke] {msg}", flush=True)


def card_line() -> str:
  return subprocess.run(
      ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
      check=True, capture_output=True, text=True, timeout=60).stdout.strip()


class Timer:
  """Per-call CUDA-event timing with the L2 cache flushed before each
  call (the served path finds the arena cold: the other block's leaves
  and the other lanes pass through L2 between two ticks)."""

  def __init__(self, torch, device):
    self._torch = torch
    self._flush = torch.empty(128 * 2**20, dtype=torch.uint8, device=device)

  def ms(self, fn, iters: int = 20, warmup: int = 3) -> float:
    torch = self._torch
    for _ in range(warmup):
      fn()
    total = 0.0
    for _ in range(iters):
      self._flush.zero_()
      start = torch.cuda.Event(enable_timing=True)
      end = torch.cuda.Event(enable_timing=True)
      start.record()
      fn()
      end.record()
      end.synchronize()
      total += start.elapsed_time(end)
    return total / iters


def max_abs(a, b) -> float:
  return float((a.float() - b.float()).abs().max())


# -- phase 2: kernels against their plain versions ---------------------------

DECODE_CASES = (
    # (slots, index, mask): lanes on distinct slots; pad lanes on slot 0.
    ([7], [4095], [True]),
    ([2], [0], [True]),
    ([3, 17, 64, 5, 9, 40, 0, 0], [0, 63, 64, 2048, 4095, 1000, 0, 0],
     [True, True, True, True, True, True, False, False]),
)


def check_decode(torch, decode_kernels, device, gen) -> float:
  s, t, h, d = 65, 4096, 8, 64
  k_arena = torch.randn((s, t, h, d), generator=gen, device=device)
  v_arena = torch.randn((s, t, h, d), generator=gen, device=device)
  worst = 0.0
  for slots_l, index_l, mask_l in DECODE_CASES:
    b = len(slots_l)
    q, k_new, v_new = (torch.randn((b, h, d), generator=gen, device=device)
                       for _ in range(3))
    slots = torch.tensor(slots_l, dtype=torch.int32, device=device)
    index = torch.tensor(index_l, dtype=torch.int32, device=device)
    mask = torch.tensor(mask_l, dtype=torch.bool, device=device)
    k_plain, v_plain = k_arena.clone(), v_arena.clone()
    k_ptr, v_ptr = k_arena.data_ptr(), v_arena.data_ptr()
    before = decode_kernels.fused_decode_attention.launches
    out, k_ret, v_ret = decode_kernels.fused_decode_attention(
        q, k_new, v_new, k_arena, v_arena, slots, index, mask)
    torch.cuda.synchronize()
    if decode_kernels.fused_decode_attention.launches != before + 1:
      raise RuntimeError("decode tick did not launch its kernel")
    if (k_ret is not k_arena or k_arena.data_ptr() != k_ptr
        or v_arena.data_ptr() != v_ptr):
      raise RuntimeError("decode tick did not update the arena in place")
    want = decode_kernels._decode_tick_plain(
        q, k_new, v_new, k_plain, v_plain, slots, index, mask)
    err = max_abs(out, want)
    # The plain version wrote the same rows: the whole arena, null slot
    # and untouched rows included, must match bit for bit.
    if not (torch.equal(k_arena, k_plain) and torch.equal(v_arena, v_plain)):
      raise RuntimeError(f"decode tick arena differs from the plain version "
                         f"(slots {slots_l}, index {index_l})")
    for lane, (slot, idx, live) in enumerate(zip(slots_l, index_l, mask_l)):
      if live and not (torch.equal(k_arena[slot, idx], k_new[lane])
                       and torch.equal(v_arena[slot, idx], v_new[lane])):
        raise RuntimeError(f"row ({slot}, {idx}) was not appended")
    log(f"decode tick B={b} index={index_l}: max |err| {err:.3e}")
    if not err <= F32_TOL:
      raise RuntimeError(f"decode tick disagrees with its plain version: "
                         f"{err} > {F32_TOL}")
    worst = max(worst, err)
  return worst


def check_flash(torch, attention_ops, device, gen):
  worst = {"float32": 0.0, "bfloat16": 0.0}
  b, h, d = 2, 8, 64
  for t in (4096, 1000):
    for causal in (True, False):
      for dtype in (torch.float32, torch.bfloat16):
        q, k, v = (torch.randn((b, h, t, d), generator=gen, device=device)
                   .to(dtype) for _ in range(3))
        t_pad = -(-t // 64) * 64  # flash_attention's padding at its tile
        pad = (0, 0, 0, t_pad - t)
        q3, k3, v3 = (torch.nn.functional.pad(x.reshape(b * h, t, d), pad)
                      for x in (q, k, v))
        before = attention_ops.flash_forward.launches
        out, lse = attention_ops.flash_forward(q3, k3, v3, causal, t)
        torch.cuda.synchronize()
        if attention_ops.flash_forward.launches != before + 1:
          raise RuntimeError("flash forward did not launch its kernel")
        want_out, want_lse = attention_ops._flash_forward_plain(
            q3, k3, v3, causal, t)
        err = max(max_abs(out[:, :t], want_out[:, :t]), max_abs(lse, want_lse))
        name = str(dtype).replace("torch.", "")
        tol = F32_TOL if dtype == torch.float32 else BF16_TOL
        log(f"flash fwd T={t} causal={causal} {name}: max |err| {err:.3e}")
        if not err <= tol:
          raise RuntimeError(f"flash forward disagrees with its plain "
                             f"version: {err} > {tol}")
        if t_pad != t and bool(lse[:, t:].ne(0).any()):
          raise RuntimeError("padded rows must carry lse = 0")
        worst[name] = max(worst[name], err)
  return worst


# -- phase 3: the slice --------------------------------------------------------

def run_slice(torch, np, port):
  config, sequence_model, predictors, session, policies, attention_ops, \
      decode_kernels = port
  config.parse_config_file(os.path.join(
      os.path.dirname(os.path.abspath(__file__)), SESSION_CONFIG))
  model = sequence_model.SequenceRegressionModel()
  predictor = predictors.CheckpointPredictor(model=model)
  predictor.init_randomly(seed=0)
  engine = session.SessionEngine(predictor=predictor)
  t_max, obs_size = model.decode_max_ticks, model.decode_observation_spec[
      "observation"].shape[0]
  log(f"slice: T={t_max}, obs={obs_size}, sessions={engine.max_sessions}, "
      f"buckets={engine.buckets}, arena {engine.cache_bytes} B before warmup")

  decode_kernels.fused_decode_attention.launches = 0
  attention_ops.flash_forward.launches = 0
  engine.warmup()
  log(f"arena {engine.cache_bytes / 1e9:.3f} GB on {engine.device}")
  rng = np.random.RandomState(0)

  # 16 concurrent episodes of 48 ticks through batcher + policy.
  episodes, ticks = 16, 48
  obs = rng.randn(episodes, ticks, obs_size).astype(np.float32)
  actions = np.zeros((episodes, ticks, 7), np.float32)
  errors = []
  batcher = session.SessionBatcher(engine=engine, max_delay_ms=2.0)
  try:
    def robot(i):
      try:
        policy = policies.SessionRegressionPolicy(predictor=batcher)
        policy.reset()
        for t in range(ticks):
          actions[i, t] = policy.select_action({"observation": obs[i, t]})
        policy.abort_episode()
      except Exception as e:  # noqa: BLE001 - re-raised below
        errors.append(e)

    threads = [threading.Thread(target=robot, args=(i,))
               for i in range(episodes)]
    start = time.perf_counter()
    for thread in threads:
      thread.start()
    for thread in threads:
      thread.join(timeout=600)
    batch_wall = time.perf_counter() - start
  finally:
    batcher.close()
  if errors:
    raise errors[0]
  if any(thread.is_alive() for thread in threads):
    raise RuntimeError("an episode thread did not finish")
  padded = np.zeros((episodes, t_max, obs_size), np.float32)
  padded[:, :ticks] = obs
  full = predictor.predict({"observation": padded})["action"][:, :ticks]
  episode_err = float(np.abs(actions - full).max())
  log(f"16 x 48 batched episodes in {batch_wall:.2f} s; max |tick - "
      f"predict| {episode_err:.3e}")
  if not episode_err <= F32_TOL:
    raise RuntimeError(f"batched episodes disagree with predict: "
                       f"{episode_err}")

  # One session to the horizon, every tick against the stateless predict.
  seq = rng.randn(1, t_max, obs_size).astype(np.float32)
  predict_fn = lambda: predictor.predict({"observation": seq})["action"]
  full = predict_fn()
  sid = engine.open()
  outs = np.zeros((t_max, 7), np.float32)
  tick_s = []
  for t in range(t_max):
    start = time.perf_counter()
    outs[t] = engine.step(sid, {"observation": seq[0, t]})["action"]
    tick_s.append(time.perf_counter() - start)
  horizon_err = float(np.abs(outs - full[0]).max())
  worst_tick = int(np.abs(outs - full[0]).max(axis=1).argmax())
  log(f"{t_max}-tick session: max |tick - predict| {horizon_err:.3e} "
      f"(worst at tick {worst_tick})")
  if not (np.isfinite(outs).all() and horizon_err <= F32_TOL):
    raise RuntimeError(f"session ticks disagree with predict: {horizon_err}")
  try:
    engine.step(sid, {"observation": seq[0, 0]})
  except session.SessionHorizonError:
    pass
  else:
    raise RuntimeError(f"tick {t_max + 1} did not raise SessionHorizonError")
  engine.close_session(sid)

  predict_s = []
  for _ in range(5):
    start = time.perf_counter()
    predict_fn()
    predict_s.append(time.perf_counter() - start)

  bf16_model = sequence_model.SequenceRegressionModel(use_bfloat16=True)
  bf16_predictor = predictors.CheckpointPredictor(model=bf16_model)
  bf16_predictor.init_randomly(seed=0)
  bf16_out = bf16_predictor.predict({"observation": seq})["action"]
  if bf16_out.shape != (1, t_max, 7) or not np.isfinite(bf16_out).all():
    raise RuntimeError("bf16 predict is not finite")
  log(f"bf16 predict finite; max |bf16 - f32| {np.abs(bf16_out - full).max():.3e}")

  launches = {"decode_tick": decode_kernels.fused_decode_attention.launches,
              "flash_fwd": attention_ops.flash_forward.launches}
  log(f"launches during the slice: {launches}")
  if min(launches.values()) <= 0:
    raise RuntimeError(f"a kernel of the path never launched: {launches}")
  return {
      "launches": launches,
      "episodes_max_abs_err": episode_err,
      "horizon_max_abs_err": horizon_err,
      "episodes_wall_s": batch_wall,
      "tick_ms_median": 1e3 * float(np.median(tick_s)),
      "tick_ms_p99": 1e3 * float(np.percentile(tick_s, 99)),
      "predict_ms_median": 1e3 * float(np.median(predict_s)),
      "bf16_vs_f32_max_abs_diff": float(np.abs(bf16_out - full).max()),
  }


# -- phase 4: timings ----------------------------------------------------------

def time_decode(torch, decode_kernels, device, gen, timer):
  """The served bucket of 8 lanes with mixed progress on the full arena."""
  s, t, h, d = 65, 4096, 8, 64
  index_l = [4095, 3072, 2048, 1024, 512, 256, 48, 1]
  b = len(index_l)
  k_arena = torch.randn((s, t, h, d), generator=gen, device=device)
  v_arena = torch.randn((s, t, h, d), generator=gen, device=device)
  q, k_new, v_new = (torch.randn((b, h, d), generator=gen, device=device)
                     for _ in range(3))
  slots = torch.arange(1, b + 1, dtype=torch.int32, device=device)
  index = torch.tensor(index_l, dtype=torch.int32, device=device)
  mask = torch.ones((b,), dtype=torch.bool, device=device)
  args = (q, k_new, v_new, k_arena, v_arena, slots, index, mask)
  kernel_ms = timer.ms(lambda: decode_kernels.fused_decode_attention(*args))
  plain_ms = timer.ms(lambda: decode_kernels._decode_tick_plain(*args))
  # Bytes the function must move: each lane's K and V rows below its
  # index, read once; q, k_new, v_new read; out and the appended rows
  # written.
  row = h * d * 4
  moved = 2 * sum(index_l) * row + 3 * b * row + b * row + 2 * b * row
  flops = 4 * sum(i + 1 for i in index_l) * h * d
  bound_ms = 1e3 * max(moved / HBM_BYTES_PER_S, flops / PEAK_FLOPS["float32"])
  return {"ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
          "bound_by": "bytes" if moved / HBM_BYTES_PER_S
          >= flops / PEAK_FLOPS["float32"] else "operations",
          "library_ms": None, "shape": f"B={b} index={index_l} arena "
          f"[{s},{t},{h},{d}] f32"}


def time_flash(torch, attention_ops, device, gen, timer, b, dtype):
  """Causal flash forward at the stateless predict's shape."""
  h, t, d = 8, 4096, 64
  q, k, v = (torch.randn((b, h, t, d), generator=gen, device=device).to(dtype)
             for _ in range(3))
  q3, k3, v3 = (x.reshape(b * h, t, d) for x in (q, k, v))
  kernel_ms = timer.ms(lambda: attention_ops.flash_forward(q3, k3, v3, True, t))
  plain_ms = timer.ms(
      lambda: attention_ops._flash_forward_plain(q3, k3, v3, True, t), iters=5)
  library_ms = timer.ms(lambda: torch.nn.functional.scaled_dot_product_attention(
      q, k, v, is_causal=True))
  name = str(dtype).replace("torch.", "")
  elem = 4 if dtype == torch.float32 else 2
  moved = 4 * b * h * t * d * elem + b * h * t * 4  # q, k, v read; o, lse written
  flops = 4 * b * h * t * t * d // 2  # causal: half the score matrix
  t_bytes, t_ops = moved / HBM_BYTES_PER_S, flops / PEAK_FLOPS[name]
  return {"ms": kernel_ms, "plain_ms": plain_ms,
          "bound_ms": 1e3 * max(t_bytes, t_ops),
          "bound_by": "bytes" if t_bytes >= t_ops else "operations",
          "library_ms": library_ms,
          "shape": f"B={b} H={h} T={t} D={d} causal {name}"}


def main() -> int:
  import torch

  if not torch.cuda.is_available():
    print("chip_smoke: torch.cuda.is_available() is false; this script runs "
          "only on a CUDA card.", file=sys.stderr)
    return 1
  import numpy as np

  from tensor2robot_tpu_torch.models import sequence_model
  from tensor2robot_tpu_torch.ops import _kernels
  from tensor2robot_tpu_torch.ops import attention as attention_ops
  from tensor2robot_tpu_torch.ops import decode_kernels
  from tensor2robot_tpu_torch.policies import policies
  from tensor2robot_tpu_torch.predictors import predictors
  from tensor2robot_tpu_torch.serving import session
  from tensor2robot_tpu_torch.utils import config

  # f32 parity is checked below: no TF32 anywhere.
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  device = torch.device("cuda", 0)
  card = card_line()
  print(card, flush=True)
  log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
      f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")

  # Phase 1: build.
  build_s = _kernels.build()
  log(f"built {list(_kernels.SOURCES)} in {build_s:.1f} s")
  for name in _kernels.SOURCES:
    for line in (_kernels.build_log(name) or "").splitlines():
      if "registers" in line or "spill" in line or "smem" in line:
        log(f"  {name}: {line.strip()}")

  # Phase 2: kernels against their plain versions.
  gen = torch.Generator(device=device).manual_seed(0)
  decode_err = check_decode(torch, decode_kernels, device, gen)
  flash_err = check_flash(torch, attention_ops, device, gen)
  torch.cuda.empty_cache()

  # Phase 3: the slice.
  slice_report = run_slice(torch, np, (config, sequence_model, predictors,
                                       session, policies, attention_ops,
                                       decode_kernels))
  torch.cuda.empty_cache()

  # Phase 4: timings.
  timer = Timer(torch, device)
  decode_t = time_decode(torch, decode_kernels, device, gen, timer)
  flash_t = time_flash(torch, attention_ops, device, gen, timer, 1,
                       torch.float32)
  extra = {"flash_fwd bf16 B=1": time_flash(torch, attention_ops, device, gen,
                                            timer, 1, torch.bfloat16),
           "flash_fwd f32 B=2": time_flash(torch, attention_ops, device, gen,
                                           timer, 2, torch.float32)}
  kernels = [
      {"name": "decode_tick", "route": "cuda",
       "source": "tensor2robot_tpu_torch/csrc/decode_tick.cu",
       "replaces": "tensor2robot_tpu/ops/decode_kernels.py:111",
       "launches": slice_report["launches"]["decode_tick"],
       "max_abs_err": decode_err, "max_err": decode_err, **decode_t},
      {"name": "flash_fwd", "route": "cuda",
       "source": "tensor2robot_tpu_torch/csrc/flash_fwd.cu",
       "replaces": "tensor2robot_tpu/ops/attention.py:139",
       "launches": slice_report["launches"]["flash_fwd"],
       "max_abs_err": flash_err["float32"], "max_err": flash_err["float32"],
       "max_abs_err_bf16": flash_err["bfloat16"], **flash_t},
  ]
  report = {"card": card, "build_s": build_s, "kernels": kernels,
            "extra_timings": extra, "slice": slice_report}
  os.makedirs(os.path.dirname(REPORT), exist_ok=True)
  with open(REPORT, "w") as f:
    json.dump(report, f, indent=1)
  print(json.dumps({"slice": slice_report, "extra_timings": extra}))
  print(json.dumps({"kernels": kernels}))
  print(card_line(), flush=True)
  print(json.dumps({"ok": True, "device": {
      "platform": "gpu", "kind": torch.cuda.get_device_name(0),
      "count": torch.cuda.device_count()}}), flush=True)
  return 0


if __name__ == "__main__":
  sys.exit(main())
