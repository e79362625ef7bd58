"""`batchnorm_device_ms.train` (ms): the device time of what a step
launches inside its `model/batch_norm` and `model/batch_norm.backward`
spans, the batch norms' forward and backward, per step
(`spans.training`)."""

from portbench import spans

NAMES = ["model/batch_norm", "model/batch_norm.backward"]


def read(run):
  trace = spans.training(run, device_trace=True)
  if trace is None or not trace.count("model/batch_norm"):
    return None
  return spans.per_step(trace, lambda t: t.device_ms(NAMES), "train/step")
