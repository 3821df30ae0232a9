"""Chunked RWKV6 WKV: the CUDA kernel for tensors on the card, the plain
chunked version for tensors on the CPU.  Nothing falls back: a CUDA tensor
launches the kernel or raises.

On the card the kernel's outputs carry a gradient: while autograd records
through an input, the op runs through `recompute`, whose backward
differentiates the plain chunked version `wkv6_chunked` from the saved
inputs, as the flash op does.  There is no WKV backward kernel yet; the
JAX package has none either and differentiates its chunked function.  A
meta tensor takes the card's structure, the plain version at one chunk
standing in for the kernel; on CPU and meta the outputs are laid out as
the kernel's.  On DTensors the op runs shard by shard over the batch and the
heads (`kernels/_dist.py`)."""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import _dist, cost, count_launch
from repro_torch.kernels._recompute import recompute
from repro_torch.kernels.rwkv6_scan.kernel import wkv6_cuda
from repro_torch.kernels.rwkv6_scan.ref import wkv6_chunked, wkv6_sequential


def wkv6(r, k, v, logw, u, *, chunk: int, initial_state=None):
    """r/k/v/logw (B,S,H,hd) fp32; u (H,hd); initial_state (B,H,hd,hd) or
    None.  Returns (y (B,S,H,hd), final_state (B,H,hd,hd)); chunks of
    min(chunk, S) steps must divide S.  `wkv6.launches` counts the calls
    that launched the kernels (three launches each, csrc/wkv6.cu's
    stages)."""
    if _dist.is_dtensor(r):
        return _sharded(r, k, v, logw, u, chunk, initial_state)
    b, s, h, hd = r.shape
    call = cost.kernel_call("wkv6", lambda: cost.wkv6(
        b, s, h, hd, min(chunk, s), initial_state is not None))
    if r.device.type == "cpu":
        with call:
            return _plain(r, k, v, logw, u, initial_state, chunk=chunk)
    if r.device.type not in ("cuda", "meta"):
        raise ValueError(f"wkv6: no kernel for device {r.device}")
    # on meta the plain version at one chunk stands in for the kernel
    kernel = (functools.partial(_cuda, chunk=chunk) if r.device.type == "cuda"
              else functools.partial(_plain, chunk=s))
    ins = (r, k, v, logw, u) + (() if initial_state is None
                                else (initial_state,))
    with call:
        if torch.is_grad_enabled() and any(t.requires_grad for t in ins):
            out = recompute(kernel, functools.partial(_plain, chunk=chunk),
                            *ins)
        else:
            out = kernel(*ins)
    if r.device.type == "cuda":
        count_launch(wkv6)
    return out


def _sharded(r, k, v, logw, u, chunk, initial_state):
    """wkv6 on DTensors, shard by shard over batch and heads."""
    op = "wkv6"
    mesh = r.device_mesh
    rs = _dist.roles(r, {0: "batch", 2: "heads"}, op)
    x_want = _dist.want(rs, {0: "batch", 2: "heads"})
    u_want = _dist.want(rs, {0: "heads"})
    s_want = _dist.want(rs, {0: "batch", 1: "heads"})
    ins = [_dist.place(t, x_want, op, mesh) for t in (r, k, v, logw)]
    ins.append(_dist.place(u, u_want, op, mesh))
    places = [x_want] * 4 + [u_want]
    if initial_state is not None:
        ins.append(_dist.place(initial_state, s_want, op, mesh))
        places.append(s_want)

    def local(*ts):
        return wkv6(*ts[:5], chunk=chunk,
                    initial_state=ts[5] if len(ts) > 5 else None)

    return _dist.run(local, mesh, ins, tuple(places), (x_want, s_want))


def _cuda(r, k, v, logw, u, initial_state=None, *, chunk):
    return wkv6_cuda(r, k, v, logw, u, chunk=chunk,
                     initial_state=initial_state)


def _plain(r, k, v, logw, u, initial_state=None, *, chunk):
    y, state = wkv6_chunked(r, k, v, logw, u, chunk=chunk,
                            initial_state=initial_state)
    return y.contiguous(), state.contiguous()     # the kernel's layout


wkv6.launches = 0

__all__ = ["wkv6", "wkv6_chunked", "wkv6_sequential"]
