"""Port of the tensor2robot_tpu.serving package (subset)."""
