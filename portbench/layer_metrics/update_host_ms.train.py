"""`update_host_ms.train` (ms): the median `train/update` span of step
calls from an idle device: the host's time in the optimizer, the EMA and
the metrics (`spans.training`)."""

from portbench import spans


def read(run):
  return spans.median_ms(spans.training(run), "train/update")
