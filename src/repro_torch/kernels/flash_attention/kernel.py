"""Launcher for the CUDA flash-attention kernel (csrc/flash_attention.cu).

Checks what the kernel takes, allocates the output and launches on PyTorch's
current stream.  The library is built at the first launch."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (32, 64, 80, 128, 256)

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_ARGTYPES = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I] + [_L] * 12 \
    + [_F, _F, _I, _P]


def _fn():
    lib = _build.library("flash_attention")
    fn = lib.flash_attention_fwd
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return lib, fn


def flash_attention_cuda(q, k, v, *, window=None, logit_softcap: float = 0.0,
                         scale: float):
    """q (B,S,Hq,hd), k/v (B,T,G,hd) on one CUDA device -> (B,S,Hq,hd)."""
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"flash_attention: bad shapes q{tuple(q.shape)} "
                         f"k{tuple(k.shape)} v{tuple(v.shape)}")
    B, S, Hq, hd = q.shape
    Bk, T, G, hdk = k.shape
    if Bk != B or hdk != hd or Hq % G:
        raise ValueError(f"flash_attention: q{tuple(q.shape)} does not match "
                         f"k/v{tuple(k.shape)}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {hd} not in {HEAD_DIMS}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: dtypes {q.dtype}/{k.dtype}/"
                        f"{v.dtype}; the kernel takes float32 or bfloat16")
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError("flash_attention: q, k, v must lie on one CUDA device")
    if q.stride(-1) != 1 or k.stride(-1) != 1 or v.stride(-1) != 1:
        raise ValueError("flash_attention: the last dim must be contiguous")
    for t in (q, k, v):
        if t.data_ptr() % 16 or any(st * t.element_size() % 16
                                    for st in t.stride()[:3]):
            raise ValueError("flash_attention: base and strides must be "
                             "multiples of 16 bytes (the kernel loads "
                             "16-byte pieces)")
    if window is not None and window <= 0:
        raise ValueError(f"flash_attention: window {window} must be > 0")
    if logit_softcap < 0:
        raise ValueError("flash_attention: logit_softcap must be >= 0")
    out = torch.empty((B, S, Hq, hd), dtype=q.dtype, device=q.device)
    lib, fn = _fn()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 _DTYPES[q.dtype], hd, B, S, T, Hq, G,
                 *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                 *out.stride()[:3],
                 float(scale), float(logit_softcap), int(window or 0), stream)
    _build.check(lib, err, "flash_attention_fwd launch")
    return out
