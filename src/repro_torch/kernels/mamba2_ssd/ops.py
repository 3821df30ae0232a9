"""Chunked Mamba2 SSD: the CUDA kernels for tensors on the card, the plain
chunked version for tensors on the CPU.  Nothing falls back: a CUDA tensor
launches the kernel or raises (n_groups > 1 included, where the JAX wrapper
quietly takes its oracle; no config of the repo has it).

Y carries a gradient through an autograd.Function that saves xdt, dA, B
and C: on the card its backward is the CUDA backward kernel, on the CPU the
plain chunked backward `ref.ssd_chunked_bwd`.  The JAX package has no SSD
backward kernel; its training differentiates the chunked scan by autodiff,
whose gradient both compute."""
from __future__ import annotations

import torch

from repro_torch.kernels.mamba2_ssd import ref
from repro_torch.kernels.mamba2_ssd.kernel import ssd_bwd_cuda, ssd_cuda


def ssd_plain(xdt, dA, B_, C_, *, chunk: int = 64):
    """Y of the plain chunked version, in xdt's dtype."""
    return ref.ssd_chunked(xdt, dA, B_, C_, chunk=chunk)[0].to(xdt.dtype)


class _SSD(torch.autograd.Function):

    @staticmethod
    def forward(ctx, xdt, dA, B_, C_, chunk):
        ctx.save_for_backward(xdt, dA, B_, C_)
        ctx.chunk = chunk
        if xdt.device.type == "cpu":
            return ssd_plain(xdt, dA, B_, C_, chunk=chunk)
        y = ssd_cuda(xdt, dA, B_, C_, chunk=chunk)
        ssd.launches += 1
        return y

    @staticmethod
    def backward(ctx, dY):
        ins = ctx.saved_tensors
        if dY.device.type == "cpu":
            grads = ref.ssd_chunked_bwd(*ins, dY, chunk=ctx.chunk)
        else:
            grads = ssd_bwd_cuda(*ins, dY, chunk=ctx.chunk)
            ssd.bwd_launches += 1
        return (*(g if need else None
                  for g, need in zip(grads, ctx.needs_input_grad)), None)


def ssd(xdt, dA, B_, C_, *, chunk: int = 64):
    """xdt (B,S,H,hd) [= dt*x]; dA (B,S,H); B_/C_ (B,S,G,N) -> Y (B,S,H,hd)
    in xdt's dtype, from a zero state.  Chunks of min(chunk, S) steps must
    divide S.  `ssd.launches` counts forward kernel launches,
    `ssd.bwd_launches` backward ones."""
    if xdt.device.type not in ("cpu", "cuda"):
        raise ValueError(f"ssd: no kernel for device {xdt.device}")
    return _SSD.apply(xdt, dA, B_, C_, chunk)


ssd.launches = 0
ssd.bwd_launches = 0

__all__ = ["ssd", "ssd_plain"]
