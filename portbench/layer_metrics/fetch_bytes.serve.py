"""`fetch_bytes.serve` (B): the session engine's
`serve/session/fetched_bytes` counter over the traced dispatches, per
dispatch: the bytes copied back to the host (`spans.serving`)."""

from portbench import spans


def read(run):
  trace = spans.serving(run)
  if trace is None or not trace.count("serve/session/step"):
    return None
  return (trace.counters["serve/session/fetched_bytes"]
          / trace.count("serve/session/step"))
