"""Chunked RWKV6 WKV: the CUDA kernel for tensors on the card, the plain
chunked version for tensors on the CPU.  Nothing falls back: a CUDA tensor
launches the kernel or raises.

On the card the kernel's outputs carry a gradient: while autograd records
through an input, the op runs through `recompute`, whose backward
differentiates the plain chunked version `wkv6_chunked` from the saved
inputs, as the flash op does.  There is no WKV backward kernel yet; the
JAX package has none either and differentiates its chunked function."""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import count_launch
from repro_torch.kernels._recompute import recompute
from repro_torch.kernels.rwkv6_scan.kernel import wkv6_cuda
from repro_torch.kernels.rwkv6_scan.ref import wkv6_chunked, wkv6_sequential


def wkv6(r, k, v, logw, u, *, chunk: int, initial_state=None):
    """r/k/v/logw (B,S,H,hd) fp32; u (H,hd); initial_state (B,H,hd,hd) or
    None.  Returns (y (B,S,H,hd), final_state (B,H,hd,hd)); chunks of
    min(chunk, S) steps must divide S.  `wkv6.launches` counts the calls
    that launched the kernels (three launches each, csrc/wkv6.cu's
    stages)."""
    if r.device.type == "cpu":
        return wkv6_chunked(r, k, v, logw, u, chunk=chunk,
                            initial_state=initial_state)
    if r.device.type != "cuda":
        raise ValueError(f"wkv6: no kernel for device {r.device}")
    ins = (r, k, v, logw, u) + (() if initial_state is None
                                else (initial_state,))
    if torch.is_grad_enabled() and any(t.requires_grad for t in ins):
        out = recompute(functools.partial(_cuda, chunk=chunk),
                        functools.partial(_plain, chunk=chunk), *ins)
    else:
        out = wkv6_cuda(r, k, v, logw, u, chunk=chunk,
                        initial_state=initial_state)
    count_launch(wkv6)
    return out


def _cuda(r, k, v, logw, u, initial_state=None, *, chunk):
    return wkv6_cuda(r, k, v, logw, u, chunk=chunk,
                     initial_state=initial_state)


def _plain(r, k, v, logw, u, initial_state=None, *, chunk):
    return wkv6_chunked(r, k, v, logw, u, chunk=chunk,
                        initial_state=initial_state)


wkv6.launches = 0

__all__ = ["wkv6", "wkv6_chunked", "wkv6_sequential"]
