"""`gradients_host_ms.train` (ms): the median `train/gradients` span of
step calls from an idle device: the host's time in the forward, the loss
and `autograd.grad` (`spans.training`)."""

from portbench import spans


def read(run):
  return spans.median_ms(spans.training(run), "train/gradients")
