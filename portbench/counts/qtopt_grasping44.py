"""The work of `qtopt_grasping44`, counted from its shapes.

A convolution of an [N, Cin, H, W] input by a [Cout, Cin, k, k] kernel
into [N, Cout, Ho, Wo] is 2 N Ho Wo Cout Cin k^2 flops forward, and the
same again for the input's gradient and for the kernel's; a dense
product of [N, in] by [in, out] is 2 N in out each way. The image and
the grasp parameters take no gradient, so the stem conv and the grasp
blocks have no input gradient. Batch norm, pooling and the elementwise
work are not counted. Bytes (for the convolutions' bound): each input
read once and each output written once, in bfloat16.
"""

from __future__ import annotations

from typing import List, Mapping, Tuple

from portbench import peaks

BF16 = 2


def _out(size: int, kernel: int, stride: int, same: bool) -> int:
  return -(-size // stride) if same else (size - kernel) // stride + 1


def convs(cfg: Mapping) -> List[Tuple[str, int, int, int, int, int]]:
  """(name, Cin, Cout, kernel, H in, H out) of every conv of the tower."""
  m = cfg["model"]
  f, size = m["filters"], m["image_size"]
  out = [("conv1_1", m["image_channels"], f, 6, size, _out(size, 6, 2, True))]
  size = _out(out[0][-1], 3, 3, True)
  conv_id = 2
  for stage, kernel in enumerate((5, 3, 3)):
    for _ in range(m["num_convs"][stage]):
      after = _out(size, kernel, 1, stage < 2)
      out.append((f"conv{conv_id}", f, f, kernel, size, after))
      size, conv_id = after, conv_id + 1
    if stage < 2:
      size = _out(size, (3, 2)[stage], (3, 2)[stage], True)
  return out


def denses(cfg: Mapping) -> List[Tuple[str, int, int, bool]]:
  """(name, in, out, has an input gradient) of every dense product."""
  m = cfg["model"]
  out = [(name, width, 256, False)
         for name, (_, width) in sorted(m["grasp_param_names"].items())]
  out.append(("fcgrasp2", 256, m["grasp_context_size"], True))
  last = convs(cfg)[-1]
  width = last[-1] ** 2 * m["filters"]
  for i in range(m["hid_layers"]):
    out.append((f"fc{i}", width, m["fc_hidden_size"], True))
    width = m["fc_hidden_size"]
  out.append(("logit", width, 1, True))
  return out


def _conv_flops(n, cin, cout, k, hout) -> int:
  return 2 * n * hout * hout * cout * cin * k * k


def train_step_flops(cfg: Mapping, batch: int) -> int:
  """Model flops of one train step: every conv and dense product
  forward, and its kernel's and (but for the first layers) its input's
  gradient."""
  total = 0
  for name, cin, cout, k, _, hout in convs(cfg):
    total += _conv_flops(batch, cin, cout, k, hout) * (
        2 if name == "conv1_1" else 3)
  for _, n_in, n_out, input_grad in denses(cfg):
    total += 2 * batch * n_in * n_out * (3 if input_grad else 2)
  return total


def conv_step_seconds(cfg: Mapping, batch: int) -> float:
  """Least time of the step's convolutions at the bf16 peak and the HBM
  rate: forward, input gradient and kernel gradient of each conv, each
  bounded on its own."""
  total = 0.0
  for name, cin, cout, k, hin, hout in convs(cfg):
    flops = _conv_flops(batch, cin, cout, k, hout)
    x = batch * cin * hin * hin * BF16
    y = batch * cout * hout * hout * BF16
    w = cout * cin * k * k * BF16
    passes = [x + w + y, x + y + w]  # forward; kernel gradient
    if name != "conv1_1":
      passes.append(y + w + x)  # input gradient
    total += sum(peaks.least_seconds(b, flops, "bfloat16") for b in passes)
  return total
