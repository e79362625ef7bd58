"""`flash_fwd_roofline` (%): the least time of the traced flash forward
launches (`counts.flash_fwd_seconds` at the step's batch and compute
dtype) over their summed device time."""

FORWARD = r"flash_fwd"


def read(run):
  if run.trace_summary is None:
    return None
  events = run.trace_summary.kernels(FORWARD)
  if not events:
    return None
  least = run.counts.flash_fwd_seconds(
      run.config, run.stats["batch"], run.config["train"]["compute_dtype"])
  spent = sum(e - s for _, s, e in events) / 1e9
  return 100.0 * len(events) * least / spent
