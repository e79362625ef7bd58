"""Mode keys (replacement for tf.estimator.ModeKeys)."""

TRAIN = "train"
EVAL = "eval"
PREDICT = "predict"

ALL_MODES = (TRAIN, EVAL, PREDICT)


def validate(mode: str) -> str:
  if mode not in ALL_MODES:
    raise ValueError(f"Unknown mode {mode!r}; expected one of {ALL_MODES}.")
  return mode
