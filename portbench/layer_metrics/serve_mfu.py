"""`serve_mfu` (%): the summed least time of the window's dispatches
(`counts.dispatch_seconds` of each dispatch's lane depths: the larger of
its flops at the float32 peak and its bytes at the HBM rate) over the
window's wall time."""


def read(run):
  depths = run.stats.get("depths")
  if not depths:
    return None
  least = sum(run.counts.dispatch_seconds(run.config, d.tolist())
              for d in depths)
  return 100.0 * least / run.stats["window_s"]
