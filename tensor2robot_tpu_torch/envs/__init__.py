"""Port of tensor2robot_tpu.envs: the pose toy environment and the actor loops."""
