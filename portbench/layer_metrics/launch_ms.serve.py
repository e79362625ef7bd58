"""`launch_ms.serve` (ms): the median `serve/session/dispatch` span of
the traced dispatches: the host's time enqueueing one decode tick
(`spans.serving`)."""

from portbench import spans


def read(run):
  return spans.median_ms(spans.serving(run), "serve/session/dispatch")
