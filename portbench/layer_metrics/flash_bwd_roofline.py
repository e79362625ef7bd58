"""`flash_bwd_roofline` (%): the least time of the traced flash
backwards (`counts.flash_bwd_seconds`: 4 products, recomputation not
counted) over the summed device time of the dQ, dK/dV and split-pass
kernels. One backward launches one dQ kernel."""

BACKWARD = r"flash_bwd"
DQ = r"flash_bwd_dq"


def read(run):
  if run.trace_summary is None:
    return None
  backwards = len(run.trace_summary.kernels(DQ))
  if not backwards:
    return None
  least = run.counts.flash_bwd_seconds(
      run.config, run.stats["batch"], run.config["train"]["compute_dtype"])
  spent = sum(e - s for _, s, e in run.trace_summary.kernels(BACKWARD)) / 1e9
  return 100.0 * backwards * least / spent
