"""Port of the tensor2robot_tpu.research.bcz package."""
