"""Launcher for the CUDA A^T B kernel (csrc/tiled_matmul.cu).

Checks what the kernel takes, allocates C (or checks the caller's) and
launches on PyTorch's current stream.  The library is built at the first
launch."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_ROW_TILES = 65535     # the grid's y extent: ceil(M / 64)

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P, _P, _P, _I, _I, _I, _I, _P]


def _fn():
    lib = _build.library("tiled_matmul")
    fn = lib.tiled_matmul_tn
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return lib, fn


def tiled_matmul_cuda(a, b, *, out=None):
    """a (K, M), b (K, N), both float32 or both bfloat16, on one CUDA
    device -> C = a^T b (M, N) in a's dtype, written into `out` if given
    (contiguous, (M, N), a's dtype and device)."""
    if a.dim() != 2 or b.dim() != 2 or a.shape[0] != b.shape[0]:
        raise ValueError(f"tiled_matmul: bad shapes a{tuple(a.shape)} "
                         f"b{tuple(b.shape)}; want (K, M) and (K, N)")
    K, M = a.shape
    N = b.shape[1]
    if M == 0 or N == 0 or -(-M // 64) > MAX_ROW_TILES:
        raise ValueError(f"tiled_matmul: M={M}, N={N}; the kernel takes "
                         f"0 < M <= {64 * MAX_ROW_TILES} and N > 0")
    if a.dtype not in _DTYPES or b.dtype != a.dtype:
        raise TypeError(f"tiled_matmul: dtypes {a.dtype}/{b.dtype}; the "
                        f"kernel takes both float32 or both bfloat16")
    if not (a.is_cuda and b.device == a.device):
        raise ValueError("tiled_matmul: a and b must lie on one CUDA device")
    a, b = a.contiguous(), b.contiguous()
    if out is None:
        out = torch.empty((M, N), dtype=a.dtype, device=a.device)
    elif (out.shape != (M, N) or out.dtype != a.dtype
          or out.device != a.device or not out.is_contiguous()):
        raise ValueError(f"tiled_matmul: out {tuple(out.shape)} {out.dtype} "
                         f"on {out.device}; want contiguous ({M}, {N}) "
                         f"{a.dtype} on {a.device}")
    lib, fn = _fn()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), _DTYPES[a.dtype],
                 K, M, N, stream)
    _build.check(lib, err, "tiled_matmul_tn launch")
    return out
