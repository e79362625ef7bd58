"""Port of the tensor2robot_tpu.research.vrgripper package."""
