"""`h2d_ms.serve` (ms): the median `serve/session/h2d` span of the
traced dispatches: the three host-to-device copies of slots, features
and mask (`spans.serving`)."""

from portbench import spans


def read(run):
  return spans.median_ms(spans.serving(run), "serve/session/h2d")
