"""Port of the tensor2robot_tpu.serving package (subset).

Layer order, robot to device — stateless requests:

  clients -> MicroBatcher (coalesce + admission control, batcher.py)
          -> BucketedEngine (pad to a warm rung, engine.py)
          -> predictor serving_bundle (predict function + state)

and stateful autoregressive episodes:

  episodes -> SessionBatcher (continuous batching w/ session affinity)
           -> SessionEngine (device-resident state arena, session.py)
           -> predictor decode_bundle (decode step + state)

plus `loadgen` (closed-loop concurrency sweeps, arrival processes).
"""

from tensor2robot_tpu_torch.serving.batcher import (DeadlineError,
                                                    MicroBatcher, ShedError,
                                                    ShutdownError)
from tensor2robot_tpu_torch.serving.engine import (BucketedEngine,
                                                   bucket_ladder,
                                                   ladder_padding_stats,
                                                   traffic_bucket_ladder)
from tensor2robot_tpu_torch.serving.session import (SessionBatcher,
                                                    SessionClosedError,
                                                    SessionEngine,
                                                    SessionError,
                                                    SessionEvictedError,
                                                    SessionHorizonError,
                                                    SessionShedError,
                                                    UnknownSessionError)

__all__ = ["MicroBatcher", "BucketedEngine", "bucket_ladder", "ShedError",
           "DeadlineError", "ShutdownError", "SessionEngine",
           "SessionBatcher", "SessionError", "SessionShedError",
           "SessionEvictedError", "UnknownSessionError",
           "SessionClosedError", "SessionHorizonError",
           "traffic_bucket_ladder", "ladder_padding_stats"]
