"""`admit_book_ms.serve` (ms): the median over the traced dispatches of
the session engine's `serve/session/admit` plus `serve/session/book`
spans: the lock, the lifecycle and horizon guards and the slots before
a dispatch, the bookkeeping and the per-session results after it
(`spans.serving`)."""

from portbench import spans


def read(run):
  return spans.median_ms(spans.serving(run), "serve/session/admit",
                         "serve/session/book")
