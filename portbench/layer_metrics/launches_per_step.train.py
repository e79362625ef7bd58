"""`launches_per_step.train` (launches): the device events (kernels,
copies, memsets) a step launches inside its `train/step` span, its
backward's included, per step (`spans.training`)."""

from portbench import spans


def read(run):
  return spans.per_step(spans.training(run, device_trace=True),
                        lambda t: len(t.launched(["train/step"])),
                        "train/step")
