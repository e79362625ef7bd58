"""Port of the tensor2robot_tpu.parallel package (subset)."""
