"""Port of the tensor2robot_tpu.policies package (subset)."""
