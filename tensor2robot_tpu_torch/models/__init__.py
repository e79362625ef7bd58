"""Port of the tensor2robot_tpu.models package (subset)."""
