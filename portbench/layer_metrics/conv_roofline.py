"""`conv_roofline` (%): the least time of the traced steps'
convolutions (`counts.conv_step_seconds`: forward, input and kernel
gradients, each at the bf16 peak or the HBM rate) over the summed device
time of the convolution kernels, matched by name."""

CONV = r"(?i)conv|fprop|dgrad|wgrad"


def read(run):
  if run.trace_summary is None or not run.stats.get("traced_steps"):
    return None
  events = run.trace_summary.kernels(CONV)
  if not events:
    return None
  least = run.counts.conv_step_seconds(run.config, run.stats["batch"])
  spent = sum(e - s for _, s, e in events) / 1e9
  return 100.0 * run.stats["traced_steps"] * least / spent
