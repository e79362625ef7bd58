"""`examples_per_s`: the examples the train steps completed over the
whole window (steps x batch), over the window's wall time, which ends
when the device has finished the last step."""


def read(run):
  stats = run.stats
  if "steps" not in stats:
    return None
  return stats["steps"] * stats["batch"] / stats["window_s"]
