"""Port of tensor2robot_tpu.research.pose_env: the pose toy task's models."""
