"""`control_p95_ms` (ms): the 95th percentile of a request's latency
over every request of the untraced window. In lockstep a request's
latency is the `step_many` wall of its dispatch, counted once for each
robot in it. The loop is closed and runs at the engine's capacity, so
the tail is a per-layer reading beside `control_per_s`: it swings with
the host's pace from run to run."""

import numpy as np


def read(run):
  stats = run.stats
  if not stats.get("latencies_s"):
    return None
  latencies = np.repeat(np.asarray(stats["latencies_s"]), stats["robots"])
  return 1e3 * float(np.percentile(latencies, 95))
