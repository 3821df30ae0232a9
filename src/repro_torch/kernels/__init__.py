"""Hand-written CUDA kernels for Hopper, one directory each:

  flash_attention — causal/windowed/soft-capped attention (prefill)
  rwkv6_scan      — chunked RWKV6 WKV recurrence (rwkv6 time-mix)
  mamba2_ssd      — chunked Mamba2 SSD scan (zamba2's Mamba2 layers)
  tiled_matmul    — C = A^T B, the paper's METG task (launch/metg.py)

and in each:

  kernel.py — launcher of the CUDA source in repro_torch/csrc/
  ops.py    — the kernel for CUDA tensors, the plain version for CPU tensors;
              where training runs it, an autograd.Function: mamba2_ssd's
              backward is a kernel of its own (its plain version on the CPU),
              flash_attention's differentiates the plain version recomputed
              from the inputs
  ref.py    — the plain PyTorch version
"""
import threading

_launch_lock = threading.Lock()


def count_launch(fn, attr: str = "launches"):
    """Add one to the wrapper's launch count `fn.<attr>` under a lock: tasks
    on the engine's thread pool launch from several threads at once, and a
    bare `+= 1` there can lose counts."""
    with _launch_lock:
        setattr(fn, attr, getattr(fn, attr) + 1)
