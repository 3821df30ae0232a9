"""Launcher for the CUDA flash-attention kernels (csrc/flash_attention.cu).

Checks what the kernels take, allocates the output and launches on
PyTorch's current stream.  The library is built at the first launch.
`route` is the pure-Python statement of the kernel and tiling the C entry
point takes for a type and head-dim pair; `c_route` asks the built library,
and the card run holds the two equal."""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (32, 64, 80, 128, 256)       # one head dim for q, k and v
MIXED_HEAD_DIMS = ((192, 128),)          # (q/k, v): DeepSeek-V2's MLA

ROUTES = ("fp32 CUDA cores", "bf16 tensor cores (wgmma)")


class Route(NamedTuple):
    route: int          # index into ROUTES
    q_rows: int         # query rows a block
    k_rows: int         # keys a tile
    kv_stages: int      # K/V tiles held in shared memory at once
    threads: int
    smem_bytes: int

    def describe(self) -> str:
        return (f"{ROUTES[self.route]}, {self.q_rows} queries x "
                f"{self.k_rows} keys a tile, {self.kv_stages} K/V stage(s), "
                f"{self.threads} threads, {self.smem_bytes} B shared")


def check_head_dims(hd: int, hd_v: int) -> None:
    """Raise unless the kernels take q/k head dim `hd` with v head dim
    `hd_v`: one of HEAD_DIMS for all three, or a pair of
    MIXED_HEAD_DIMS."""
    if hd == hd_v and hd in HEAD_DIMS or (hd, hd_v) in MIXED_HEAD_DIMS:
        return
    raise ValueError(f"flash_attention: head dims q/k {hd}, v {hd_v} not "
                     f"taken: one of {HEAD_DIMS} for all, or (q/k, v) in "
                     f"{MIXED_HEAD_DIMS}")


def route(dtype, hd: int, hd_v: int = None) -> Route:
    """bf16 takes the tensor-core kernel: 128 query rows (two warpgroups),
    64-key tiles in a ring of 2 stages, bf16 in shared memory in 64-wide
    panels (Q and K at hd, V at hd_v, each rounded up to a multiple of 64)
    plus 1 KB of alignment slack.  fp32 takes the CUDA-core kernel: 64 query
    rows, 32-key tiles, fp32 Q, K (rows padded by 4) and V in shared memory.
    hd_v defaults to hd."""
    hd_v = hd if hd_v is None else hd_v
    check_head_dims(hd, hd_v)
    if dtype == torch.bfloat16:
        panels, v_panels = -(-hd // 64), -(-hd_v // 64)
        return Route(1, 128, 64, 2, 256,
                     panels * 128 * 128
                     + 2 * (panels + v_panels) * 64 * 128 + 1024)
    if dtype == torch.float32:
        return Route(0, 64, 32, 1, 256, 4 * (64 * (hd + 4) + 32 * (hd + 4)
                                             + 32 * hd_v))
    raise TypeError(f"flash_attention: no kernel for {dtype}")


_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_ARGTYPES = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I] + [_L] * 12 \
    + [_F, _F, _I, _I, _I, _P]


def _fn():
    lib = _build.library("flash_attention")
    fn = lib.flash_attention_fwd
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return lib, fn


def c_route(dtype, hd: int, hd_v: int = None) -> Route:
    """The route the built library takes for this type and head-dim pair."""
    lib = _build.library("flash_attention")
    fn = lib.flash_attention_route
    fn.argtypes = [_I, _I, _I, ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 6)()
    _build.check(lib, fn(_DTYPES[dtype], hd, hd if hd_v is None else hd_v,
                         out), "flash_attention_route")
    return Route(*out)


def flash_attention_cuda(q, k, v, *, causal: bool = True, window=None,
                         logit_softcap: float = 0.0, scale: float,
                         probs_bf16: bool = False):
    """q (B,S,Hq,hd), k (B,T,G,hd), v (B,T,G,hd_v) on one CUDA device ->
    (B,S,Hq,hd_v).  causal, window and probs_bf16 are runtime values of
    one compiled kernel (probs_bf16 changes only the bf16 route)."""
    if q.dim() != 4 or k.dim() != 4 or v.shape[:3] != k.shape[:3]:
        raise ValueError(f"flash_attention: bad shapes q{tuple(q.shape)} "
                         f"k{tuple(k.shape)} v{tuple(v.shape)}")
    B, S, Hq, hd = q.shape
    Bk, T, G, hdk = k.shape
    hd_v = v.shape[3]
    if Bk != B or hdk != hd or Hq % G:
        raise ValueError(f"flash_attention: q{tuple(q.shape)} does not match "
                         f"k/v{tuple(k.shape)}")
    check_head_dims(hd, hd_v)
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
    out = torch.empty((B, S, Hq, hd_v), dtype=q.dtype, device=q.device)
    lib, fn = _fn()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 _DTYPES[q.dtype], hd, hd_v, B, S, T, Hq, G,
                 *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                 *out.stride()[:3],
                 float(scale), float(logit_softcap), int(window or 0),
                 int(bool(causal)), int(bool(probs_bf16)), stream)
    _build.check(lib, err, "flash_attention_fwd launch")
    return out
