"""C = A^T B: the CUDA kernel for tensors on the card, the plain version for
tensors on the CPU.  Nothing falls back: a CUDA tensor launches the kernel
or raises.  There is no gradient, as the JAX op has none."""
from __future__ import annotations

import torch

from repro_torch.kernels.tiled_matmul.kernel import tiled_matmul_cuda
from repro_torch.kernels.tiled_matmul.ref import tiled_matmul_ref


def tiled_matmul(a, b, *, out=None):
    """a (K, M), b (K, N) -> C (M, N) in a's dtype, fp32 accumulation;
    written into `out` if given.  `tiled_matmul.launches` counts kernel
    launches.  On the card it raises while autograd records a graph through
    an input: the kernel has no backward."""
    if a.device.type == "cpu":
        c = tiled_matmul_ref(a, b)
        return c if out is None else out.copy_(c)
    if a.device.type != "cuda":
        raise ValueError(f"tiled_matmul: no kernel for device {a.device}")
    if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad):
        raise RuntimeError("tiled_matmul: the CUDA kernel has no backward, "
                           "and its output would carry no gradient")
    c = tiled_matmul_cuda(a, b, out=out)
    tiled_matmul.launches += 1
    return c


tiled_matmul.launches = 0

__all__ = ["tiled_matmul", "tiled_matmul_ref"]
