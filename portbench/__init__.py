"""portbench: the benchmark of the PyTorch and CUDA port.

It measures `tensor2robot_tpu_torch` only, and loads no module of the
JAX package. Run one cell once from the repository root:

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

`README.md` says how cells, configurations, traffic mixes and metrics are
found by name, and how a later change adds them as new files.
"""
