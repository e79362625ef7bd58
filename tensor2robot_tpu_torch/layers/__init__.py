"""Port of the tensor2robot_tpu.layers package (subset)."""
