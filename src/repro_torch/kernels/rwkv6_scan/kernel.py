"""Launcher for the CUDA chunked-WKV kernel (csrc/wkv6.cu).

Checks what the kernel takes, allocates y and the final state and launches
on PyTorch's current stream.  The library is built at the first launch."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

CHUNKS = (16, 32, 64)
HEAD_DIMS = (32, 64)

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P] * 8 + [_I] * 5 + [_P]


def _fn():
    lib = _build.library("wkv6")
    fn = lib.wkv6_fwd_f32
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return lib, fn


def wkv6_cuda(r, k, v, logw, u, *, chunk: int, initial_state=None):
    """r/k/v/logw (B,S,H,hd) and u (H,hd), fp32 and contiguous on one CUDA
    device; initial_state (B,H,hd,hd) or None (zeros).  Chunks of
    min(chunk, S) steps, which must divide S.
    Returns (y (B,S,H,hd), final_state (B,H,hd,hd))."""
    if r.dim() != 4 or any(t.shape != r.shape for t in (k, v, logw)):
        raise ValueError(f"wkv6: r/k/v/logw must share one (B,S,H,hd) shape, "
                         f"got {[tuple(t.shape) for t in (r, k, v, logw)]}")
    B, S, H, hd = r.shape
    if u.shape != (H, hd):
        raise ValueError(f"wkv6: u{tuple(u.shape)} is not (H, hd) = {(H, hd)}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"wkv6: head_dim {hd} not in {HEAD_DIMS}")
    Q = min(chunk, S)
    if Q not in CHUNKS:
        raise ValueError(f"wkv6: chunk {Q} not in {CHUNKS}")
    if S % Q:
        raise ValueError(f"wkv6: S={S} is not a multiple of the chunk {Q}; "
                         f"the caller pads")
    ins = [r, k, v, logw, u]
    if initial_state is not None:
        if initial_state.shape != (B, H, hd, hd):
            raise ValueError(f"wkv6: initial_state{tuple(initial_state.shape)}"
                             f" is not (B, H, hd, hd) = {(B, H, hd, hd)}")
        ins.append(initial_state)
    if any(t.dtype != torch.float32 for t in ins):
        raise TypeError(f"wkv6: dtypes {[t.dtype for t in ins]}; the kernel "
                        f"takes float32")
    if not (r.is_cuda and all(t.device == r.device for t in ins)):
        raise ValueError("wkv6: every input must lie on one CUDA device")
    if not all(t.is_contiguous() for t in ins):
        raise ValueError("wkv6: inputs must be contiguous")
    if any(t.data_ptr() % 16 for t in ins):
        raise ValueError("wkv6: inputs must start on 16-byte boundaries "
                         "(the kernel loads 16-byte pieces)")
    y = torch.empty_like(r)
    s_out = torch.empty((B, H, hd, hd), dtype=torch.float32, device=r.device)
    lib, fn = _fn()
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream(r.device).cuda_stream
        err = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), logw.data_ptr(),
                 u.data_ptr(),
                 None if initial_state is None else initial_state.data_ptr(),
                 y.data_ptr(), s_out.data_ptr(), B, S, H, hd, Q, stream)
    _build.check(lib, err, "wkv6_fwd_f32 launch")
    return y, s_out
