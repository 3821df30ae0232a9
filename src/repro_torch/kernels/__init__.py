"""Hand-written CUDA kernels for Hopper, one directory each:

  flash_attention — causal/windowed/soft-capped attention (prefill)
  rwkv6_scan      — chunked RWKV6 WKV recurrence (rwkv6 time-mix)
  mamba2_ssd      — chunked Mamba2 SSD scan (zamba2's Mamba2 layers)

and in each:

  kernel.py — launcher of the CUDA source in repro_torch/csrc/
  ops.py    — the kernel for CUDA tensors, the plain version for CPU tensors;
              where training runs it, an autograd.Function whose backward
              differentiates the plain version recomputed from the inputs
  ref.py    — the plain PyTorch version
"""
