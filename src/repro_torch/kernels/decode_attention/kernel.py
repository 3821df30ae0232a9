"""Launcher for the CUDA decode-attention kernels
(csrc/decode_attention.cu).

Checks what the kernels take, allocates the output and the fp32 scratch
(scores, each chunk's max and sum, the partial contexts) and launches the
three kernels on PyTorch's current stream.  The library is built at the
first launch.  `plan` is the grid the launch takes, from the shapes
alone."""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (32, 64, 80, 128, 256)
ROWS = (1, 2, 4, 8)        # query rows a block: the kernels' MB
MAX_CHUNK, MIN_CHUNK = 512, 32
TARGET_BLOCKS = 2048       # ~4 waves of 4 blocks of 256 threads on 132 SMs


class Plan(NamedTuple):
    rows: int       # query rows of a group a block holds
    slices: int     # blocks over a group's rows
    chunk: int      # keys a block
    chunks: int     # blocks over the keys

    def blocks(self, b: int, g: int) -> int:
        return b * g * self.slices * self.chunks


@functools.lru_cache(maxsize=256)
def plan(b: int, g: int, m: int, t: int) -> Plan:
    """The grid for b rows of g groups of m query heads against t keys:
    the fewest rows a block that hold m (at most 8, more in slices), and
    chunks of keys halved from 512 until the grid holds TARGET_BLOCKS or
    the chunk is 32 keys."""
    rows = next(r for r in ROWS if r >= min(m, ROWS[-1]))
    slices = -(-m // rows)
    chunk = MAX_CHUNK
    while (chunk > MIN_CHUNK
           and b * g * slices * -(-t // chunk) < TARGET_BLOCKS):
        chunk //= 2
    return Plan(rows, slices, chunk, -(-t // chunk))


def scratch_floats(b: int, hq: int, t: int, hd: int, p: Plan) -> int:
    """fp32 scratch of a launch: scores (b, hq, t), each chunk's max and
    sum (b, hq, chunks, 2), the partial contexts (b, hq, chunks, hd)."""
    return b * hq * (t + p.chunks * (2 + hd))


_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_ARGTYPES = [_P] * 6 + [_I] * 11 + [_L] * 10 + [_F, _F, _I, _I, _P]


@functools.cache
def _fn():
    lib = _build.library("decode_attention")
    fn = lib.decode_attention_fwd
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return lib, fn


def _aligned(t, dims) -> bool:
    """Last dim contiguous, the base and the strides of `dims` multiples of
    16 bytes: the kernels load 16-byte pieces."""
    vec = 16 // t.element_size()
    st = t.stride()
    return (st[-1] == 1 and t.data_ptr() % 16 == 0
            and all(st[d] % vec == 0 for d in dims))


def decode_attention_cuda(q, k_cache, v_cache, positions, *, window=None,
                          logit_softcap: float = 0.0, scale: float):
    """q (B,1,Hq,hd), k_cache and v_cache (B,T,G,hd) on one CUDA device,
    positions (B,) int64 there, each in [0, T) -> (B,1,Hq,hd) in q's type.
    q is rounded to the cache's type (bf16 or fp32).  Launches on the
    device's current stream; the host's work is kept small, since a decode
    step calls this once a layer."""
    B, T, G, hd = k_cache.shape
    Hq = q.shape[2]
    if (q.dim() != 4 or q.shape[0] != B or q.shape[1] != 1
            or q.shape[3] != hd or Hq % G
            or v_cache.shape != k_cache.shape or positions.shape != (B,)):
        raise ValueError(f"decode_attention: bad shapes q{tuple(q.shape)} "
                         f"k{tuple(k_cache.shape)} v{tuple(v_cache.shape)} "
                         f"positions{tuple(positions.shape)}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"decode_attention: head dim {hd} not taken: one "
                         f"of {HEAD_DIMS}")
    dt = k_cache.dtype
    if (dt not in _DTYPES or v_cache.dtype != dt or q.dtype not in _DTYPES
            or positions.dtype != torch.int64):
        raise TypeError(f"decode_attention: dtypes q {q.dtype}, cache "
                        f"{dt}/{v_cache.dtype}, positions {positions.dtype};"
                        f" the kernels take float32 or bfloat16 and int64 "
                        f"positions")
    dev = q.device
    if not (dev.type == "cuda" and k_cache.device == dev
            and v_cache.device == dev and positions.device == dev):
        raise ValueError("decode_attention: q, the cache and positions must "
                         "lie on one CUDA device")
    qk = q.to(dt)
    if not (_aligned(qk, (0, 2)) and _aligned(k_cache, (0, 1, 2))
            and _aligned(v_cache, (0, 1, 2))):
        raise ValueError("decode_attention: the last dim must be "
                         "contiguous, the base and strides multiples of "
                         "16 bytes (the kernels load 16-byte pieces)")
    if window is not None and window <= 0:
        raise ValueError(f"decode_attention: window {window} must be > 0")
    if logit_softcap < 0:
        raise ValueError("decode_attention: logit_softcap must be >= 0")
    p = plan(B, G, Hq // G, T)
    work = torch.empty(scratch_floats(B, Hq, T, hd, p), dtype=torch.float32,
                       device=dev)
    out = torch.empty((B, 1, Hq, hd), dtype=q.dtype, device=dev)
    pos = positions.contiguous()
    ks, vs = k_cache.stride(), v_cache.stride()
    lib, fn = _fn()
    err = fn(qk.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
             pos.data_ptr(), out.data_ptr(), work.data_ptr(),
             _DTYPES[dt], _DTYPES[q.dtype], hd, B, T, Hq, G, p.rows,
             p.slices, p.chunk, p.chunks,
             qk.stride(0), qk.stride(2), ks[0], ks[1], ks[2], vs[0], vs[1],
             vs[2], out.stride(0), out.stride(2),
             float(scale), float(logit_softcap), int(window or 0), dev.index,
             torch._C._cuda_getCurrentRawStream(dev.index))
    _build.check(lib, err, "decode_attention_fwd launch")
    return out
