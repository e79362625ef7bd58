"""Port of the tensor2robot_tpu.research.grasp2vec package."""
