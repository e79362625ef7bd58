"""Port of tensor2robot_tpu.research.qtopt: the QT-Opt grasping critic."""
