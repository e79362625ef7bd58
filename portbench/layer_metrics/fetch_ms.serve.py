"""`fetch_ms.serve` (ms): the median `serve/session/fetch` span of the
traced dispatches: the wait for the device and each output's copy back
(`spans.serving`)."""

from portbench import spans


def read(run):
  return spans.median_ms(spans.serving(run), "serve/session/fetch")
