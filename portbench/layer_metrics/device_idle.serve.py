"""`device_idle.serve` (%): the share of the traced window of dispatches
in which no kernel, copy or memset ran on the device."""


def read(run):
  t = run.trace_summary
  if t is None or "dispatches" not in run.stats:
    return None
  return 100.0 * (1.0 - t.busy_s / t.window_s)
