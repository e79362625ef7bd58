"""Port of tensor2robot_tpu.meta_learning: MAML, meta data and meta policies."""
