"""Chunked Mamba2 SSD: the CUDA kernels for tensors on the card, the plain
chunked version for tensors on the CPU.  Nothing falls back: a CUDA tensor
launches the kernels or raises (n_groups > 1 included, where the JAX wrapper
quietly takes its oracle; no config of the repo has it).

Y carries a gradient through an autograd.Function that saves xdt, dA, B
and C: on the card its backward is the CUDA backward kernel, on the CPU the
plain chunked backward `ref.ssd_chunked_bwd`.  The JAX package has no SSD
backward kernel; its training differentiates the chunked scan by autodiff,
whose gradient both compute.  That gradient is Y's from a zero initial
state: with an initial state or the final state asked for, the op carries
no gradient and raises while autograd records (serving runs under
`torch.no_grad()`)."""
from __future__ import annotations

import torch

from repro_torch.kernels import count_launch
from repro_torch.kernels.mamba2_ssd import ref
from repro_torch.kernels.mamba2_ssd.kernel import ssd_bwd_cuda, ssd_cuda


def ssd_plain(xdt, dA, B_, C_, *, chunk: int = 64, initial_state=None,
              return_state=False):
    """`ssd`'s function through the plain chunked version: Y in xdt's
    dtype, or (Y, final_state) with `return_state`."""
    y, state = ref.ssd_chunked(xdt, dA, B_, C_, chunk=chunk,
                               initial_state=initial_state)
    y = y.to(xdt.dtype)
    return (y, state) if return_state else y


class _SSD(torch.autograd.Function):

    @staticmethod
    def forward(ctx, xdt, dA, B_, C_, chunk):
        ctx.save_for_backward(xdt, dA, B_, C_)
        ctx.chunk = chunk
        if xdt.device.type == "cpu":
            return ssd_plain(xdt, dA, B_, C_, chunk=chunk)
        y, _ = ssd_cuda(xdt, dA, B_, C_, chunk=chunk)
        count_launch(ssd)
        return y

    @staticmethod
    def backward(ctx, dY):
        ins = ctx.saved_tensors
        if dY.device.type == "cpu":
            grads = ref.ssd_chunked_bwd(*ins, dY, chunk=ctx.chunk)
        else:
            grads = ssd_bwd_cuda(*ins, dY, chunk=ctx.chunk)
            count_launch(ssd, "bwd_launches")
        return (*(g if need else None
                  for g, need in zip(grads, ctx.needs_input_grad)), None)


def ssd(xdt, dA, B_, C_, *, chunk: int = 64, initial_state=None,
        return_state=False):
    """xdt (B,S,H,hd) [= dt*x]; dA (B,S,H); B_/C_ (B,S,G,N); initial_state
    (B,H,hd,N) fp32 or None (zeros) -> Y (B,S,H,hd) in xdt's dtype, or
    (Y, final_state (B,H,hd,N) fp32) with `return_state`.  Chunks of
    min(chunk, S) steps must divide S.  `ssd.launches` counts the forward
    calls that launched the kernels (three kernels each, csrc/mamba2_ssd.cu's
    stages), `ssd.bwd_launches` the backward ones (four each).  With
    `initial_state` or `return_state` it raises while autograd records a
    graph through an input: the backward kernel takes a zero initial state
    and no cotangent of the final state."""
    if xdt.device.type not in ("cpu", "cuda"):
        raise ValueError(f"ssd: no kernel for device {xdt.device}")
    if initial_state is None and not return_state:
        return _SSD.apply(xdt, dA, B_, C_, chunk)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (xdt, dA, B_, C_, initial_state)):
        raise RuntimeError("ssd: no gradient through an initial state or the "
                           "final state; call it under torch.no_grad(), or "
                           "without them for training")
    if xdt.device.type == "cpu":
        return ssd_plain(xdt, dA, B_, C_, chunk=chunk,
                         initial_state=initial_state,
                         return_state=return_state)
    y, state = ssd_cuda(xdt, dA, B_, C_, chunk=chunk,
                        initial_state=initial_state)
    count_launch(ssd)
    return (y, state) if return_state else y


ssd.launches = 0
ssd.bwd_launches = 0

__all__ = ["ssd", "ssd_plain"]
