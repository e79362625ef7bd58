"""`update_device_ms.train` (ms): the device time of the kernels, copies
and memsets a step launches inside its `train/update` span (the
optimizer, the EMA, the metrics), per step (`spans.training`)."""

from portbench import spans


def read(run):
  return spans.per_step(spans.training(run, device_trace=True),
                        lambda t: t.device_ms(["train/update"]),
                        "train/step")
