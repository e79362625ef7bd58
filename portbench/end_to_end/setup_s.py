"""`setup_s`: seconds from the process's start to the end of warm-up
(imports, weights and inputs from the seed, kernel loads, the cell's
warm-up and, for serving, the context fill), on the host's clock."""


def read(run):
  return run.setup_s
