"""Port of the tensor2robot_tpu.ops package (subset)."""
