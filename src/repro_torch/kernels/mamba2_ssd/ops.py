"""Chunked Mamba2 SSD: the CUDA kernel for tensors on the card, the plain
chunked version for tensors on the CPU.  Nothing falls back: a CUDA tensor
launches the kernel or raises (n_groups > 1 included, where the JAX wrapper
quietly takes its oracle; no config of the repo has it).

On the card Y carries a gradient: the backward recomputes the plain chunked
version from the saved xdt, dA, B, C and differentiates it.  The JAX
package has no SSD backward kernel either; its training differentiates the
chunked scan by autodiff."""
from __future__ import annotations

import functools

from repro_torch.kernels._recompute import recompute
from repro_torch.kernels.mamba2_ssd import ref
from repro_torch.kernels.mamba2_ssd.kernel import ssd_cuda


def ssd_plain(xdt, dA, B_, C_, *, chunk: int = 64):
    """Y of the plain chunked version, in xdt's dtype."""
    return ref.ssd_chunked(xdt, dA, B_, C_, chunk=chunk)[0].to(xdt.dtype)


def ssd(xdt, dA, B_, C_, *, chunk: int = 64):
    """xdt (B,S,H,hd) [= dt*x]; dA (B,S,H); B_/C_ (B,S,G,N) -> Y (B,S,H,hd)
    in xdt's dtype, from a zero state.  Chunks of min(chunk, S) steps must
    divide S.  `ssd.launches` counts kernel launches."""
    if xdt.device.type == "cpu":
        return ssd_plain(xdt, dA, B_, C_, chunk=chunk)
    if xdt.device.type != "cuda":
        raise ValueError(f"ssd: no kernel for device {xdt.device}")
    y = recompute(functools.partial(ssd_cuda, chunk=chunk),
                  functools.partial(ssd_plain, chunk=chunk), xdt, dA, B_, C_)
    ssd.launches += 1
    return y


ssd.launches = 0

__all__ = ["ssd", "ssd_plain"]
