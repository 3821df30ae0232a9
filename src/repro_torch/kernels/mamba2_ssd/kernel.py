"""Launchers for the CUDA chunked Mamba2 SSD kernels (csrc/mamba2_ssd.cu):
the forward and its backward.

Each checks what the kernels take, allocates the outputs and the fp32
scratch and launches on PyTorch's current stream.  The library is built at
the first launch."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
CHUNKS = (16, 32, 64)
# (head_dim, state_dim): zamba2-2.7b's, and the JAX kernel sweep's
# (tests/test_kernels.py)
SHAPES = ((64, 64), (16, 16), (32, 8))

# The products of each direction and the route each takes in
# csrc/mamba2_ssd.cu: all through its warp-level mma.sync helper in 3xTF32
# (names as the staged plain versions `ref.ssd_chunked_staged` and
# `ref.ssd_chunked_bwd_staged` give them)
FWD_ROUTES = {name: "3xTF32" for name in (
    "x^T.(D o B)",                                          # stage 1
    "C.B^T", "M.x", "C.S_in^T")}                            # stage 3
BWD_ROUTES = {name: "3xTF32" for name in (
    "x^T.(D o B)", "dY^T.(E o C)",                          # stage 1
    "C.B^T", "dY.x^T", "M^T.dY", "B.dS^T", "dG.B", "dY.S_in", "dG^T.C",
    "x.dS")}                                                # stage 3
# Each direction's kernels, in launch order
FWD_KERNELS = ("ssd_fwd_chunk_state", "ssd_fwd_state_pass",
               "ssd_fwd_chunk_out")
BWD_KERNELS = ("ssd_bwd_chunk_state", "ssd_bwd_state_pass",
               "ssd_bwd_chunk_grads", "ssd_head_sum")

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P] * 9 + [_I] * 8 + [_P]
_BWD_ARGTYPES = [_P] * 14 + [_I] * 8 + [_P]


def _fn(name, argtypes):
    lib = _build.library("mamba2_ssd")
    fn = getattr(lib, name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return lib, fn


def _check(xdt, dA, B_, C_, chunk, *more):
    """Raise on what the kernels do not take; `more` are further tensors of
    xdt's type and device.  Returns (B, S, H, hd, N, Q)."""
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
    ins = (xdt, dA, B_, C_, *more)
    if xdt.dtype not in _DTYPES or any(t.dtype != xdt.dtype for t in ins):
        raise TypeError(f"ssd: dtypes {[t.dtype for t in ins]}; the kernel "
                        f"takes all float32 or all bfloat16")
    if not (xdt.is_cuda and all(t.device == xdt.device for t in ins)):
        raise ValueError("ssd: every input must lie on one CUDA device")
    return Bb, S, H, hd, N, Q


def ssd_cuda(xdt, dA, B_, C_, *, chunk: int, initial_state=None,
             return_states=False):
    """xdt (B,S,H,hd), dA (B,S,H), B_/C_ (B,S,1,N), all float32 or all
    bfloat16, on one CUDA device; initial_state (B,H,hd,N) float32 on that
    device, or None (zeros).  Chunks of min(chunk, S) steps, which must
    divide S.  Returns (Y (B,S,H,hd) in xdt's dtype, final_state (B,H,hd,N)
    float32); with `return_states`, also (S_in, decay), the fp32 scratch
    (B,H,S/Q,hd,N) that holds, after the scan over the chunks, the state
    entering each chunk, and the chunks' decays (B,H,S/Q).  That scratch is
    freed on return otherwise."""
    Bb, S, H, hd, N, Q = _check(xdt, dA, B_, C_, chunk)
    f32 = dict(dtype=torch.float32, device=xdt.device)
    if initial_state is not None:
        if initial_state.shape != (Bb, H, hd, N) \
                or initial_state.dtype != torch.float32 \
                or initial_state.device != xdt.device:
            raise ValueError(
                f"ssd: initial_state {tuple(initial_state.shape)} "
                f"{initial_state.dtype} on {initial_state.device}; the kernel "
                f"takes float32 {(Bb, H, hd, N)} on {xdt.device}")
        initial_state = _aligned(initial_state.contiguous())
    xdt, dA = (_aligned(t.contiguous()) for t in (xdt, dA))
    Bm, Cm = (_aligned(t[:, :, 0].contiguous()) for t in (B_, C_))
    states = torch.empty((Bb, H, S // Q, hd, N), **f32)
    decay = torch.empty((Bb, H, S // Q), **f32)
    final = torch.empty((Bb, H, hd, N), **f32)
    y = torch.empty_like(xdt)
    lib, fn = _fn("mamba2_ssd_fwd", _ARGTYPES)
    with torch.cuda.device(xdt.device):
        stream = torch.cuda.current_stream(xdt.device).cuda_stream
        err = fn(xdt.data_ptr(), dA.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
                 y.data_ptr(),
                 None if initial_state is None else initial_state.data_ptr(),
                 final.data_ptr(), states.data_ptr(), decay.data_ptr(),
                 _DTYPES[xdt.dtype], Bb, S, H, hd, N, Q, head_group(H),
                 stream)
    _build.check(lib, err, "mamba2_ssd_fwd launch")
    return ((y, final), (states, decay)) if return_states else (y, final)


def head_group(H: int) -> int:
    """Heads one block of stages 1 and 3 takes: the largest of 4, 2 and 1
    that divides H."""
    return next(g for g in (4, 2, 1) if H % g == 0)


def _aligned(t):
    """t, or a copy of it if its data does not start on 16 bytes (the
    kernels stage rows and states with 16-byte loads)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def ssd_bwd_cuda(xdt, dA, B_, C_, dY, *, chunk: int, return_states=False):
    """The gradient of `ssd_cuda`'s Y (zero initial state) with cotangent
    dY (B,S,H,hd), which has xdt's type and device; the inputs as
    `ssd_cuda` takes them.  Returns (dxdt, ddA, dB, dC) in the inputs'
    shapes and type; with `return_states`, also (S_in, dS), the fp32
    scratch (B,H,S/Q,hd,N) that holds, after the scan over the chunks, the
    state entering each chunk and the cotangent of the state leaving it.
    Allocates that scratch, the
    chunks' decays (B,H,S/Q) and the head groups' partials of dB and dC
    (B,S,H/group,N), freed on return."""
    Bb, S, H, hd, N, Q = _check(xdt, dA, B_, C_, chunk, dY)
    if dY.shape != xdt.shape:
        raise ValueError(f"ssd: dY{tuple(dY.shape)} does not match "
                         f"xdt{tuple(xdt.shape)}")
    xdt, dA, dY = (_aligned(t.contiguous()) for t in (xdt, dA, dY))
    Bm, Cm = (_aligned(t[:, :, 0].contiguous()) for t in (B_, C_))
    hg = head_group(H)
    f32 = dict(dtype=torch.float32, device=xdt.device)
    states, dstates = (torch.empty((Bb, H, S // Q, hd, N), **f32)
                       for _ in range(2))
    decay = torch.empty((Bb, H, S // Q), **f32)
    dBp, dCp = (torch.empty((Bb, S, H // hg, N), **f32) for _ in range(2))
    dx, ddA = torch.empty_like(xdt), torch.empty_like(dA)
    dB, dC = (torch.empty((Bb, S, 1, N), dtype=xdt.dtype, device=xdt.device)
              for _ in range(2))
    lib, fn = _fn("mamba2_ssd_bwd", _BWD_ARGTYPES)
    with torch.cuda.device(xdt.device):
        stream = torch.cuda.current_stream(xdt.device).cuda_stream
        err = fn(xdt.data_ptr(), dA.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
                 dY.data_ptr(), dx.data_ptr(), ddA.data_ptr(), dB.data_ptr(),
                 dC.data_ptr(), states.data_ptr(), dstates.data_ptr(),
                 decay.data_ptr(), dBp.data_ptr(), dCp.data_ptr(),
                 _DTYPES[xdt.dtype], Bb, S, H, hd, N, Q, hg, stream)
    _build.check(lib, err, "mamba2_ssd_bwd launch")
    grads = (dx, ddA, dB, dC)
    return (grads, (states, dstates)) if return_states else grads
