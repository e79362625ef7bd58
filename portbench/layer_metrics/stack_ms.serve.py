"""`stack_ms.serve` (ms): the median `serve/session/stack` span of the
traced dispatches: the bucket, the slot and mask arrays, the feature
stack and the parameters' getter (`spans.serving`)."""

from portbench import spans


def read(run):
  return spans.median_ms(spans.serving(run), "serve/session/stack")
