"""Hand-written CUDA kernels for Hopper, one directory each:

  kernel.py — launcher of the CUDA source in repro_torch/csrc/
  ops.py    — the kernel for CUDA tensors, the plain version for CPU tensors
  ref.py    — the plain PyTorch version
"""
