"""Port of the tensor2robot_tpu.preprocessors package (subset)."""
