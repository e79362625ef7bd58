"""Port of the tensor2robot_tpu.export package: serving bundles."""
