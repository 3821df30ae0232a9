"""Plain PyTorch version of C = A^T B (the oracle `tiled_matmul_ref`,
src/repro/kernels/tiled_matmul/ref.py).  It is the path tensors on the CPU
take and what the CUDA kernel is held against on the card; there its fp32
product needs `torch.backends.cuda.matmul.allow_tf32` False (the default)."""
from __future__ import annotations

import torch


def tiled_matmul_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (K, M), b (K, N) -> (M, N): products summed in fp32 (fp64 for fp64
    inputs), the result cast to a's dtype."""
    ct = torch.promote_types(a.dtype, torch.float32)
    return torch.einsum("km,kn->mn", a.to(ct), b.to(ct)).to(a.dtype)
