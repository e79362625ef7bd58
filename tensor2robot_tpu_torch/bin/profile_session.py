"""Where a session tick's time goes, on one CUDA card.

    python3 -m tensor2robot_tpu_torch.bin.profile_session [--ticks 200]

Serves the causal sequence policy of `configs/serve_session.gin` (random
weights, seed 0), brings 8 sessions to mixed progress, then profiles
`--ticks` full-bucket ticks and one stateless predict with
`torch.profiler` (CPU + CUDA activity). Prints one JSON object: wall ms
per call (timed without the profiler), device-busy ms per call (the sum
of the device-side kernel and copy events; one stream, so they do not
overlap), the device's idle share, and the device-time ranking of
kernels. Also written to `chiprun_out/profile_session.json`.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from tensor2robot_tpu_torch.models import sequence_model
from tensor2robot_tpu_torch.obs import device_profile
from tensor2robot_tpu_torch.predictors import predictors
from tensor2robot_tpu_torch.serving import session
from tensor2robot_tpu_torch.utils import config

_CONFIG = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "configs", "serve_session.gin")


def _window(fn, count):
  report = device_profile.profile_window(fn, count)
  del report["events"]
  return report


def main() -> None:
  parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
  parser.add_argument("--ticks", type=int, default=200)
  args = parser.parse_args()
  torch.backends.cuda.matmul.allow_tf32 = False
  config.parse_config_file(_CONFIG)
  model = sequence_model.SequenceRegressionModel()
  predictor = predictors.CheckpointPredictor(model=model)
  predictor.init_randomly(seed=0)
  engine = session.SessionEngine(predictor=predictor).warmup()
  rng = np.random.RandomState(0)
  obs_size = model.decode_observation_spec["observation"].shape[0]
  sids = [engine.open() for _ in range(8)]
  # Mixed progress: session i starts the window at tick 256 * i.
  for i, sid in enumerate(sids):
    for _ in range(256 * i):
      engine.step(sid, {"observation": rng.randn(obs_size)})
  obs = {"observation": rng.randn(obs_size).astype(np.float32)}
  items = [(sid, obs) for sid in sids]
  engine.step_many(items)  # warm
  tick = _window(lambda: engine.step_many(items), args.ticks)
  seq = {"observation": rng.randn(1, model.decode_max_ticks,
                                  obs_size).astype(np.float32)}
  predictor.predict(seq)  # warm
  predict = _window(lambda: predictor.predict(seq), 5)
  report = {"card": torch.cuda.get_device_name(0),
            "bucket8_tick": tick, "predict_T4096": predict}
  os.makedirs("chiprun_out", exist_ok=True)
  with open("chiprun_out/profile_session.json", "w") as f:
    json.dump(report, f, indent=1)
  print(json.dumps(report))


if __name__ == "__main__":
  main()
