"""Decode attention: the CUDA kernel for tensors on the card, the plain
version for tensors on the CPU or on meta.  Nothing falls back: a CUDA
tensor launches the kernel or raises.

DTensors on the CPU or on meta keep the plain version, grouped and split
over the cache's sequence (`shard_hint` over `kv_seq`, the softmax's max
and sum reduced across the shards): the sharded dry run counts that path.
DTensors on the card run the kernel shard by shard (`kernels/_dist.py`)
over the batch and the heads; a cache split over its sequence raises
there, since the kernel reduces over it.  The kernel has no backward:
decode runs under inference, and the op raises if autograd records
through an input on the card."""
from __future__ import annotations

import torch

from repro_torch.kernels import _dist, cost, count_launch
from repro_torch.kernels.decode_attention.kernel import decode_attention_cuda
from repro_torch.kernels.decode_attention.ref import decode_attention_ref


def decode_attention(q, k_cache, v_cache, positions, *, window=None,
                     logit_softcap: float = 0.0, scale: float):
    """Single-token decode: q (B,1,Hq_pad,hd) against a cache (B,T,G,hd),
    positions (B,) the new token's index (its K/V already written).  Head
    h reads group h // (Hq_pad/G).  Operands in the cache's dtype, sums in
    fp32, the probabilities rounded to the cache's dtype before P.V; the
    output in q's dtype.  `decode_attention.launches` counts the calls that
    launched the kernels (three launches each, csrc/decode_attention.cu)."""
    kw = dict(window=window, logit_softcap=logit_softcap, scale=scale)
    if q.device.type in ("cpu", "meta"):
        return decode_attention_ref(q, k_cache, v_cache, positions, **kw)
    if _dist.is_dtensor(q) or _dist.is_dtensor(k_cache):
        return _sharded(q, k_cache, v_cache, positions, kw)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: no kernel for device {q.device}")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (q, k_cache, v_cache)):
        raise RuntimeError("decode_attention: the kernel has no backward")
    b, t, g, hd = k_cache.shape
    with cost.kernel_call("decode_attention", lambda: cost.decode_attention(
            b, t, q.shape[2], g, hd, itemsize=k_cache.element_size(),
            window=window)):
        out = decode_attention_cuda(q, k_cache, v_cache, positions, **kw)
    count_launch(decode_attention)
    return out


def _sharded(q, k, v, positions, kw):
    """decode_attention on DTensors on the card, shard by shard over the
    batch and the heads.  A mesh dim splits what the cache's placement
    splits there, else what q's does; K/V whole over a mesh dim that splits
    fewer groups than heads give each shard the group its heads read."""
    op = "decode_attention"
    dims = {0: "batch", 2: "heads"}
    lead = k if _dist.is_dtensor(k) else q
    mesh = lead.device_mesh
    none = [None] * mesh.ndim
    k_rs = _dist.roles(k, dims, op) if _dist.is_dtensor(k) else none
    q_rs = _dist.roles(q, dims, op) if _dist.is_dtensor(q) else none
    G = k.shape[2]
    rs, kv_rs, pick = [], [], None
    for i, (kr, qr) in enumerate(zip(k_rs, q_rs)):
        if kr and qr and kr != qr:
            raise ValueError(f"{op}: mesh dim {i} splits the cache's {kr} "
                             f"and the query's {qr}")
        r, m = kr or qr, mesh.size(i)
        rs.append(r)
        kv_rs.append(r)
        if r == "heads" and G % m:
            if kr or m % G or pick is not None:
                raise ValueError(f"{op}: {G} K/V groups on a mesh dim of "
                                 f"{m} shards of the heads")
            kv_rs[-1], pick = None, (i, m // G)     # each shard one group
    q_want, kv_want = _dist.want(rs, dims), _dist.want(kv_rs, dims)
    pos_want = _dist.want(rs, {0: "batch"})
    q = _dist.place(q, q_want, op, mesh)
    k, v = (_dist.place(t, kv_want, op, mesh) for t in (k, v))
    positions = _dist.place(positions, pos_want, op, mesh)

    def local(ql, kl, vl, pl):
        if pick is not None:
            g = mesh.get_local_rank(pick[0]) // pick[1]
            kl, vl = kl[:, :, g:g + 1], vl[:, :, g:g + 1]
        return decode_attention(ql, kl, vl, pl, **kw)

    return _dist.run(local, mesh, (q, k, v, positions),
                     (q_want, kv_want, kv_want, pos_want), q_want)


decode_attention.launches = 0

__all__ = ["decode_attention", "decode_attention_ref"]
