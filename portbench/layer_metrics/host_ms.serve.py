"""`host_ms.serve` (ms): a dispatch's `step_many` wall in the untraced
window less its device busy time in the traced one: the host's share of
a control request."""

import statistics


def read(run):
  t = run.trace_summary
  traced = run.stats.get("traced_depths")
  if t is None or not traced or not run.stats.get("latencies_s"):
    return None
  busy = t.busy_s / len(traced)
  return 1e3 * (statistics.mean(run.stats["latencies_s"]) - busy)
