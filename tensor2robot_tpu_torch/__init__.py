"""tensor2robot_tpu_torch: the PyTorch/CUDA port of tensor2robot_tpu.

The JAX package stays the reference. This package mirrors its module
paths and class names, runs on one CUDA device (an H100) unless told
`device='cpu'`, and replaces each Pallas TPU kernel on its paths with a
hand-written CUDA kernel (`csrc/`) beside a plain PyTorch version of the
same function. It imports neither jax nor tensor2robot_tpu.
"""
