"""Port of the tensor2robot_tpu.predictors package (subset)."""
