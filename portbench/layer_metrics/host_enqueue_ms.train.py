"""`host_enqueue_ms.train` (ms): the median host time of one train step
call, from an idle device and with no sync inside the call: what the
host spends enqueueing a step."""

import statistics


def read(run):
  enqueue = run.stats.get("enqueue_s")
  return 1e3 * statistics.median(enqueue) if enqueue else None
