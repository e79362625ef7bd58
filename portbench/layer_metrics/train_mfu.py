"""`train_mfu` (%): the benchmark's count of the step's model flops
(`counts/<config>.py`), over the window's wall time per step, as a share
of the card's peak for the configuration's compute dtype."""

from portbench import peaks


def read(run):
  stats = run.stats
  if not stats.get("steps"):
    return None
  flops = run.counts.train_step_flops(run.config, stats["batch"])
  peak = peaks.PEAK_FLOPS[run.config["train"]["compute_dtype"]]
  return 100.0 * flops * stats["steps"] / stats["window_s"] / peak
