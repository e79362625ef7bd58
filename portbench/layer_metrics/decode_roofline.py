"""`decode_roofline` (%): the least time of the traced decode-tick
launches (`counts.decode_launch_seconds` of the lanes' indices, one
launch per attention block a dispatch) over their summed device time."""

DECODE = r"decode_tick"


def read(run):
  t = run.trace_summary
  traced = run.stats.get("traced_depths")
  if t is None or not traced:
    return None
  events = t.kernels(DECODE)
  blocks = run.config["model"]["num_blocks"]
  if len(events) != blocks * len(traced):
    raise RuntimeError(f"{len(events)} decode launches traced for "
                       f"{len(traced)} dispatches of {blocks} blocks")
  least = blocks * sum(run.counts.decode_launch_seconds(run.config,
                                                        d.tolist())
                       for d in traced)
  return 100.0 * least / (sum(e - s for _, s, e in events) / 1e9)
