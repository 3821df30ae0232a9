"""Chunked RWKV6 WKV: the CUDA kernel for tensors on the card, the plain
chunked version for tensors on the CPU.  Nothing falls back: a CUDA tensor
launches the kernel or raises."""
from __future__ import annotations

import torch

from repro_torch.kernels.rwkv6_scan.kernel import wkv6_cuda
from repro_torch.kernels.rwkv6_scan.ref import wkv6_chunked, wkv6_sequential


def wkv6(r, k, v, logw, u, *, chunk: int, initial_state=None):
    """r/k/v/logw (B,S,H,hd) fp32; u (H,hd); initial_state (B,H,hd,hd) or
    None.  Returns (y (B,S,H,hd), final_state (B,H,hd,hd)); chunks of
    min(chunk, S) steps must divide S.  `wkv6.launches` counts the calls
    that launched the kernels (three launches each, csrc/wkv6.cu's
    stages).  On the card it raises while autograd records a graph through
    an input: the kernel has no backward yet."""
    if r.device.type == "cpu":
        return wkv6_chunked(r, k, v, logw, u, chunk=chunk,
                            initial_state=initial_state)
    if r.device.type != "cuda":
        raise ValueError(f"wkv6: no kernel for device {r.device}")
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (r, k, v, logw, u, initial_state)):
        raise RuntimeError("wkv6: the CUDA kernel has no backward yet, and "
                           "its output would carry no gradient; rwkv6 "
                           "training on the card is ROADMAP Queue 1")
    out = wkv6_cuda(r, k, v, logw, u, chunk=chunk, initial_state=initial_state)
    wkv6.launches += 1
    return out


wkv6.launches = 0

__all__ = ["wkv6", "wkv6_chunked", "wkv6_sequential"]
