"""Port of the tensor2robot_tpu.hooks package: train-loop callbacks."""
