"""Hand-written CUDA kernels for Hopper, one directory each:

  flash_attention — causal/windowed/soft-capped attention (prefill)
  rwkv6_scan      — chunked RWKV6 WKV recurrence (rwkv6 time-mix)

and in each:

  kernel.py — launcher of the CUDA source in repro_torch/csrc/
  ops.py    — the kernel for CUDA tensors, the plain version for CPU tensors
  ref.py    — the plain PyTorch version
"""
