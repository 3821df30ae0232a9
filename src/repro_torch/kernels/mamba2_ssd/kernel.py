"""Launcher for the CUDA chunked Mamba2 SSD kernel (csrc/mamba2_ssd.cu).

Checks what the kernel takes, allocates Y and launches on PyTorch's current
stream.  The library is built at the first launch."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
CHUNKS = (16, 32, 64)
# (head_dim, state_dim): zamba2-2.7b's, and the JAX kernel sweep's
# (tests/test_kernels.py)
SHAPES = ((64, 64), (16, 16), (32, 8))

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P] * 5 + [_I] * 7 + [_P]


def _fn():
    lib = _build.library("mamba2_ssd")
    fn = lib.mamba2_ssd_fwd
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return lib, fn


def ssd_cuda(xdt, dA, B_, C_, *, chunk: int):
    """xdt (B,S,H,hd), dA (B,S,H), B_/C_ (B,S,1,N), all float32 or all
    bfloat16, on one CUDA device.  Chunks of min(chunk, S) steps, which must
    divide S.  Returns Y (B,S,H,hd) in xdt's dtype (zero initial state)."""
    if xdt.dim() != 4 or dA.dim() != 3 or B_.dim() != 4 \
            or C_.shape != B_.shape:
        raise ValueError(f"ssd: bad shapes xdt{tuple(xdt.shape)} "
                         f"dA{tuple(dA.shape)} B{tuple(B_.shape)} "
                         f"C{tuple(C_.shape)}")
    Bb, S, H, hd = xdt.shape
    G, N = B_.shape[2], B_.shape[3]
    if dA.shape != (Bb, S, H) or B_.shape[:2] != (Bb, S):
        raise ValueError(f"ssd: dA{tuple(dA.shape)} / B{tuple(B_.shape)} do "
                         f"not match xdt{tuple(xdt.shape)}")
    if G != 1:
        raise ValueError(f"ssd: the kernel takes n_groups == 1, got {G}")
    if (hd, N) not in SHAPES:
        raise ValueError(f"ssd: (head_dim, state_dim) {(hd, N)} not in "
                         f"{SHAPES}")
    Q = min(chunk, S)
    if Q not in CHUNKS:
        raise ValueError(f"ssd: chunk {Q} not in {CHUNKS}")
    if S % Q:
        raise ValueError(f"ssd: S={S} is not a multiple of the chunk {Q}; "
                         f"the caller pads")
    ins = (xdt, dA, B_, C_)
    if xdt.dtype not in _DTYPES or any(t.dtype != xdt.dtype for t in ins):
        raise TypeError(f"ssd: dtypes {[t.dtype for t in ins]}; the kernel "
                        f"takes all float32 or all bfloat16")
    if not (xdt.is_cuda and all(t.device == xdt.device for t in ins)):
        raise ValueError("ssd: every input must lie on one CUDA device")
    xdt, dA = xdt.contiguous(), dA.contiguous()
    Bm, Cm = B_[:, :, 0].contiguous(), C_[:, :, 0].contiguous()
    y = torch.empty_like(xdt)
    lib, fn = _fn()
    with torch.cuda.device(xdt.device):
        stream = torch.cuda.current_stream(xdt.device).cuda_stream
        err = fn(xdt.data_ptr(), dA.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
                 y.data_ptr(), _DTYPES[xdt.dtype], Bb, S, H, hd, N, Q, stream)
    _build.check(lib, err, "mamba2_ssd_fwd launch")
    return y
