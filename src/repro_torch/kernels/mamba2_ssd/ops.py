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
`torch.no_grad()`).  A meta tensor takes the plain versions, forward and
backward; on DTensors the op runs shard by shard over the batch and the
heads (`kernels/_dist.py`), B and C (one group) replicated over the
heads."""
from __future__ import annotations

import torch

from repro_torch.kernels import _dist, cost, count_launch
from repro_torch.kernels.mamba2_ssd import ref
from repro_torch.kernels.mamba2_ssd.kernel import ssd_bwd_cuda, ssd_cuda


def ssd_plain(xdt, dA, B_, C_, *, chunk: int = 64, initial_state=None,
              return_state=False):
    """`ssd`'s function through the plain chunked version: Y in xdt's
    dtype, or (Y, final_state) with `return_state`."""
    y, state = ref.ssd_chunked(xdt, dA, B_, C_, chunk=chunk,
                               initial_state=initial_state)
    y, state = y.to(xdt.dtype).contiguous(), state.contiguous()
    return (y, state) if return_state else y


class _SSD(torch.autograd.Function):

    @staticmethod
    def forward(ctx, xdt, dA, B_, C_, chunk):
        ctx.save_for_backward(xdt, dA, B_, C_)
        ctx.chunk = chunk
        with _call(xdt, B_, chunk):
            if xdt.device.type != "cuda":
                return ssd_plain(xdt, dA, B_, C_, chunk=_plain_chunk(
                    xdt, chunk))
            y, _ = ssd_cuda(xdt, dA, B_, C_, chunk=chunk)
        count_launch(ssd)
        return y

    @staticmethod
    def backward(ctx, dY):
        ins = ctx.saved_tensors
        b, s, h, hd = ins[0].shape
        call = cost.kernel_call("mamba2_ssd_bwd", lambda: cost.ssd_bwd(
            b, s, h, hd, ins[2].shape[-1], min(ctx.chunk, s),
            ins[0].element_size()))
        with call:
            if dY.device.type != "cuda":
                grads = ref.ssd_chunked_bwd(*ins, dY, chunk=_plain_chunk(
                    dY, ctx.chunk))
            else:
                grads = ssd_bwd_cuda(*ins, dY, chunk=ctx.chunk)
        if dY.device.type == "cuda":
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
    if _dist.is_dtensor(xdt):
        return _sharded(xdt, dA, B_, C_, chunk, initial_state, return_state)
    if xdt.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"ssd: no kernel for device {xdt.device}")
    if initial_state is None and not return_state:
        return _SSD.apply(xdt, dA, B_, C_, chunk)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (xdt, dA, B_, C_, initial_state)):
        raise RuntimeError("ssd: no gradient through an initial state or the "
                           "final state; call it under torch.no_grad(), or "
                           "without them for training")
    with _call(xdt, B_, chunk, initial_state is not None, return_state):
        if xdt.device.type != "cuda":
            return ssd_plain(xdt, dA, B_, C_, chunk=_plain_chunk(xdt, chunk),
                             initial_state=initial_state,
                             return_state=return_state)
        y, state = ssd_cuda(xdt, dA, B_, C_, chunk=chunk,
                            initial_state=initial_state)
    count_launch(ssd)
    return (y, state) if return_state else y


def _plain_chunk(x, chunk: int) -> int:
    """The plain version's chunk: the op's on the CPU; on meta one chunk
    of the whole sequence, which gives the shapes in a few ops."""
    return x.shape[1] if x.device.type == "meta" else chunk


def _call(xdt, B_, chunk, with_state=False, final_state=False):
    """The forward's `cost.kernel_call`."""
    b, s, h, hd = xdt.shape
    return cost.kernel_call("mamba2_ssd", lambda: cost.ssd(
        b, s, h, hd, B_.shape[-1], min(chunk, s), xdt.element_size(),
        with_state, final_state))


def _sharded(xdt, dA, B_, C_, chunk, initial_state, return_state):
    """ssd on DTensors, shard by shard over batch and heads."""
    op = "ssd"
    mesh = xdt.device_mesh
    rs = _dist.roles(xdt, {0: "batch", 2: "heads"}, op)
    if B_.shape[2] > 1 and "heads" in rs:
        raise ValueError(f"{op}: heads split over {B_.shape[2]} groups")
    x_want = _dist.want(rs, {0: "batch", 2: "heads"})
    bc_want = _dist.want(rs, {0: "batch"})
    s_want = _dist.want(rs, {0: "batch", 1: "heads"})
    ins = [_dist.place(xdt, x_want, op, mesh),
           _dist.place(dA, x_want, op, mesh),
           _dist.place(B_, bc_want, op, mesh),
           _dist.place(C_, bc_want, op, mesh)]
    places = [x_want, x_want, bc_want, bc_want]
    if initial_state is not None:
        ins.append(_dist.place(initial_state, s_want, op, mesh))
        places.append(s_want)

    def local(*ts):
        return ssd(*ts[:4], chunk=chunk,
                   initial_state=ts[4] if len(ts) > 4 else None,
                   return_state=return_state)

    outs = (x_want, s_want) if return_state else x_want
    return _dist.run(local, mesh, ins, tuple(places), outs)


ssd.launches = 0
ssd.bwd_launches = 0

__all__ = ["ssd", "ssd_plain"]
