"""Launcher for the CUDA A^T B kernels (csrc/tiled_matmul.cu).

Checks what the kernels take, allocates C (or checks the caller's) and
launches on PyTorch's current stream.  The library is built at the first
launch.  `plan` is the pure-Python statement of the kernel and tiling the
C entry point picks for a launch (`make_plan` in the source); `c_plan`
asks the built library, and the card run holds the two equal."""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_ROW_TILES = 65535     # the grid's y extent: ceil(M / 32) at most
MIN_BLOCKS = 132          # SMs of an H100 SXM
# fp32 block tiles, largest first: (BM, BN, per-thread TM, TN, k split)
F32_CONFIGS = ((128, 128, 8, 8, 1), (64, 64, 8, 8, 4), (32, 32, 4, 4, 4))
TC_TILE = (128, 128)      # bf16: two warpgroups of 64 rows x 128
ROUTES = ("fp32 CUDA cores", "bf16 tensor cores (wgmma)")
STAGINGS = ("cp.async 16 B", "cp.async 4 B", "element loads")


class Plan(NamedTuple):
    route: int      # index into ROUTES
    bm: int
    bn: int
    ksplit: int     # groups of threads splitting each k-stage in a block
    staging: int    # index into STAGINGS
    blocks: int     # the grid's blocks

    def describe(self) -> str:
        return (f"{ROUTES[self.route]}, tile {self.bm}x{self.bn}, k split "
                f"{self.ksplit}, {STAGINGS[self.staging]}, "
                f"{self.blocks} blocks")


def plan(dtype, K: int, M: int, N: int, a_ptr: int = 0,
         b_ptr: int = 0) -> Plan:
    """The kernel and tiling for C = a^T b with a (K, M), b (K, N) at
    addresses a_ptr, b_ptr.  bf16: tensor cores, 16-byte async copies where
    every row start is 16-byte aligned (M, N multiples of 8), else 4-byte
    ones of element pairs where every row start is 4-byte aligned (M, N
    even), else element loads.  fp32: the largest tile whose grid has
    MIN_BLOCKS blocks (else the smallest, which splits k over 4 groups of
    threads), 16-byte copies where M, N are multiples of 4 and the bases
    aligned, else 4-byte ones."""
    def blocks(bm, bn):
        return -(-M // bm) * -(-N // bn)

    def aligned(n):
        return a_ptr % n == 0 and b_ptr % n == 0
    if dtype == torch.bfloat16:
        staging = (0 if M % 8 == 0 and N % 8 == 0 and aligned(16) else
                   1 if M % 2 == 0 and N % 2 == 0 and aligned(4) else 2)
        return Plan(1, *TC_TILE, 1, staging, blocks(*TC_TILE))
    vec = M % 4 == 0 and N % 4 == 0 and aligned(16)
    cfg = next((c for c in F32_CONFIGS if blocks(c[0], c[1]) >= MIN_BLOCKS),
               F32_CONFIGS[-1])
    return Plan(0, cfg[0], cfg[1], cfg[4], 0 if vec else 1,
                blocks(cfg[0], cfg[1]))


_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P, _P, _P, _I, _I, _I, _I, _P]


def _fn():
    lib = _build.library("tiled_matmul")
    fn = lib.tiled_matmul_tn
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return lib, fn


def c_plan(a, b) -> Plan:
    """The plan the built library picks for a launch on a (K, M), b (K, N)."""
    lib = _build.library("tiled_matmul")
    fn = lib.tiled_matmul_plan
    fn.argtypes = [_I, _I, _I, _I, _P, _P, ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 6)()
    _build.check(lib, fn(_DTYPES[a.dtype], a.shape[0], a.shape[1],
                         b.shape[1], a.data_ptr(), b.data_ptr(), out),
                 "tiled_matmul_plan")
    return Plan(*out)


def tiled_matmul_cuda(a, b, *, out=None):
    """a (K, M), b (K, N), both float32 or both bfloat16, on one CUDA
    device -> C = a^T b (M, N) in a's dtype, written into `out` if given
    (contiguous, (M, N), a's dtype and device)."""
    if a.dim() != 2 or b.dim() != 2 or a.shape[0] != b.shape[0]:
        raise ValueError(f"tiled_matmul: bad shapes a{tuple(a.shape)} "
                         f"b{tuple(b.shape)}; want (K, M) and (K, N)")
    K, M = a.shape
    N = b.shape[1]
    if M == 0 or N == 0 or -(-M // 32) > MAX_ROW_TILES:
        raise ValueError(f"tiled_matmul: M={M}, N={N}; the kernel takes "
                         f"0 < M <= {32 * MAX_ROW_TILES} and N > 0")
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
