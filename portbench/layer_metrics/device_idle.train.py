"""`device_idle.train` (%): the share of the traced window of train steps
in which no kernel, copy or memset ran on the device."""


def read(run):
  t = run.trace_summary
  if t is None or "steps" not in run.stats:
    return None
  return 100.0 * (1.0 - t.busy_s / t.window_s)
