"""Port of the tensor2robot_tpu.utils package (subset)."""
