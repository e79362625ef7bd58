"""Port of the tensor2robot_tpu.serving package.

Layer order, robot to device — stateless requests:

  clients -> MicroBatcher (coalesce + admission control, batcher.py)
          -> BucketedEngine (pad to a warm rung, engine.py)
          -> predictor serving_bundle (predict function + state)

and stateful autoregressive episodes:

  episodes -> SessionBatcher (continuous batching w/ session affinity)
           -> SessionEngine (device-resident state arena, session.py)
           -> predictor decode_bundle (decode step + state)

and, above both, the replica pool:

  traffic  -> ServingFleet (least-outstanding router, session affinity,
              health eviction, zero-downtime rollout, fleet.py)
           -> per-replica MicroBatcher / SessionBatcher fronts
           -> per-replica engines on their device groups

plus `loadgen` (closed-loop concurrency sweeps, open-loop session and
trace-driven loads over the arrival processes).
"""

from tensor2robot_tpu_torch.serving.batcher import (DeadlineError,
                                                    MicroBatcher, ShedError,
                                                    ShutdownError)
from tensor2robot_tpu_torch.serving.engine import (BucketedEngine,
                                                   bucket_ladder,
                                                   ladder_padding_stats,
                                                   traffic_bucket_ladder)
from tensor2robot_tpu_torch.serving.fleet import (FleetShedError,
                                                  NoHealthyReplicaError,
                                                  ServingFleet)
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
           "SessionClosedError", "SessionHorizonError", "ServingFleet",
           "FleetShedError", "NoHealthyReplicaError",
           "traffic_bucket_ladder", "ladder_padding_stats"]
