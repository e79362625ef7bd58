"""graftloop: the always-on actor/learner loop, in one supervised process.

Counterpart of `tensor2robot_tpu.loop`. An actor pool runs env episodes
through policies served by `serving.ServingFleet` and streams them into
a bounded replay sink that the learner's record pipeline reads; the
learner trains in rounds and publishes verified checkpoints that roll
into the fleet while it serves.

Modules:
  supervisor  worker registration, heartbeats and restarts under
              `utils.retry.RetryPolicy`, with escalation budgets
  replay      the bounded, byte-capped TFRecord episode sink
  publish     checkpoint verification -> fleet rollout, fenced
  actor       the per-actor episode loop with its staleness bound
  loop        `GraftLoop` and the configurable entry `run_graftloop`

No module of the package imports torch when it is imported: torch comes
in only inside the factories and workers that run the model.
"""

from tensor2robot_tpu_torch.loop.actor import EpisodeActor
from tensor2robot_tpu_torch.loop.publish import CheckpointPublisher
from tensor2robot_tpu_torch.loop.replay import ReplayRecordSink
from tensor2robot_tpu_torch.loop.supervisor import Supervisor, WorkerHandle

__all__ = ["Supervisor", "WorkerHandle", "ReplayRecordSink",
           "CheckpointPublisher", "EpisodeActor"]
