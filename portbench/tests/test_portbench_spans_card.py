"""On the card: a kernel launched inside a program span is attributed to
that span, and a backward run by the autograd engine's own thread is
attributed to the span its caller waits in. Run on the chip with
`python3 -m pytest portbench/tests -m card -q`."""

from __future__ import annotations

import pytest

from portbench import spans


@pytest.mark.card
def test_a_kernel_launched_inside_a_span_is_attributed_to_it(card):
  import torch

  from tensor2robot_tpu_torch.layers import flax_layers
  from tensor2robot_tpu_torch.obs import trace as obs_trace

  x = torch.randn(512, 512, device=card)
  conv = torch.nn.Conv2d(3, 8, 3, padding=1).to(card)
  norm = flax_layers.BatchNorm(8).to(card)
  image = torch.randn(4, 3, 16, 16, device=card)

  def body():
    torch.mm(x, x)
    with obs_trace.span("probe/matmul"):
      torch.mm(x, x)
    with obs_trace.span("probe/step"):
      y, _ = norm(conv(image), True)
      torch.autograd.grad(y.square().sum(), list(conv.parameters()))

  t = spans.capture(body, card)
  matmul = t.launched(["probe/matmul"])
  # The same product outside the span launches the same kernels.
  assert matmul and {e.name for e in matmul} == {
      e.name for e in t.device[:len(matmul)]}, [e.name for e in t.device]
  assert len(t.device) > len(t.launched(["probe/step"])) + 1
  backward = t.launched(["model/batch_norm.backward"])
  assert backward, "no launch attributed to batch norm's backward"
  (grad_span,) = [s for s in t.spans
                  if s.name == "model/batch_norm.backward"]
  (step_span,) = [s for s in t.spans if s.name == "probe/step"]
  # On CUDA the backward runs on the autograd engine's thread.
  assert grad_span.thread != step_span.thread
  inside = {id(e) for e in t.launched(["probe/step"])}
  assert all(id(e) in inside for e in backward)
  assert len(inside) > len(backward) + len(t.launched(["model/batch_norm"]))
