"""Port of the tensor2robot_tpu.data package (subset)."""
