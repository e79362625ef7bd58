"""`control_per_s`: robot control requests served over the whole
window, over its wall time (in lockstep every robot's tick is one
request)."""


def read(run):
  stats = run.stats
  if "dispatches" not in stats:
    return None
  return stats["dispatches"] * stats["robots"] / stats["window_s"]
