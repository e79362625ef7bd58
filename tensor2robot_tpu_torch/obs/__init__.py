"""Port of the tensor2robot_tpu.obs package (subset)."""
