"""Flash attention: the CUDA kernel for tensors on the card, the plain
blockwise version for tensors on the CPU or on the meta device (which gives
the shapes).  Nothing falls back: a CUDA tensor launches the kernel or
raises.

On the card the kernel's output carries a gradient: the backward recomputes
the plain blockwise version from the saved q, k, v and differentiates it.
The JAX package has no attention backward kernel either; its training
differentiates the same blockwise function by autodiff.  A meta tensor
takes the card's structure, the plain version at one block standing in
for the kernel, so that an analysis counts the same forward and backward
on both; on the CPU and on meta the output is laid out as the kernel's.

On DTensors the op runs shard by shard (`kernels/_dist.py`) over the batch
and the heads; K/V replicated over a mesh dim that splits fewer groups
than heads give each shard the group its heads read."""
from __future__ import annotations

import functools

from repro_torch.kernels import _dist, cost, count_launch
from repro_torch.kernels._recompute import recompute
from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
from repro_torch.kernels.flash_attention.ref import (flash_attention_blockwise,
                                                     flash_attention_ref)


def flash_attention(q, k, v, *, causal: bool = True, window=None,
                    logit_softcap: float = 0.0, scale: float,
                    q_block: int = 1024, kv_block: int = 1024,
                    probs_bf16: bool = False):
    """Attention. q (B,S,Hq,hd), k (B,T,G,hd), v (B,T,G,hd_v) ->
    (B,S,Hq,hd_v); T may differ from S (cross-attention).

    causal: the mask t <= s (False: every key, as whisper's encoder and
    cross-attention).  window: None or an int > 0 (s - t < window).  Both
    are runtime values, so every layer shares one compiled kernel.
    probs_bf16: P rounded to V's type before P.V, the JAX model's knob.
    q_block / kv_block size the plain version's blocks, on the CPU and in
    the card's backward.  `flash_attention.launches` counts kernel
    launches."""
    kw = dict(causal=causal, window=window, logit_softcap=logit_softcap,
              scale=scale, q_block=q_block, kv_block=kv_block,
              probs_bf16=probs_bf16)
    if _dist.is_dtensor(q):
        return _sharded(q, k, v, kw)
    b, s, hq, hd = q.shape
    call = cost.kernel_call("flash_attention", lambda: cost.flash_attention(
        b, s, hq, k.shape[2], hd, window=window, itemsize=q.element_size(),
        hd_v=v.shape[-1], t=k.shape[1], causal=causal))
    plain = functools.partial(flash_attention_blockwise, **kw)
    if q.device.type == "cpu":
        with call:
            return plain(q, k, v).contiguous()      # the kernel's layout
    if q.device.type == "meta":
        # the plain version at one block stands in for the kernel: its
        # shapes and layout in a few ops (the backward's keeps the blocks)
        whole = functools.partial(flash_attention_blockwise,
                                  **{**kw, "q_block": s,
                                     "kv_block": k.shape[1]})
        with call:
            return recompute(lambda *ts: whole(*ts).contiguous(), plain,
                             q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    with call:
        out = recompute(
            functools.partial(flash_attention_cuda, causal=causal,
                              window=window, logit_softcap=logit_softcap,
                              scale=scale, probs_bf16=probs_bf16),
            plain, q, k, v)
    count_launch(flash_attention)
    return out


def _sharded(q, k, v, kw):
    """flash_attention on DTensors, shard by shard over batch and heads."""
    op = "flash_attention"
    mesh = q.device_mesh
    dims = {0: "batch", 2: "heads"}
    rs = _dist.roles(q, dims, op)
    G = k.shape[2]
    kv_rs, pick = list(rs), None
    for i, r in enumerate(rs):
        m = mesh.size(i)
        if r == "heads" and G % m:
            if m % G or pick is not None:
                raise ValueError(f"{op}: {G} K/V groups on a mesh dim of "
                                 f"{m} shards of the heads")
            kv_rs[i], pick = None, (i, m // G)     # each shard one group
    kv_want = _dist.want(kv_rs, {0: "batch", 2: "heads"})
    q_want = _dist.want(rs, dims)
    k, v = (_dist.place(t, kv_want, op, mesh) for t in (k, v))

    def local(ql, kl, vl):
        if pick is not None:
            g = mesh.get_local_rank(pick[0]) // pick[1]
            kl, vl = kl[:, :, g:g + 1], vl[:, :, g:g + 1]
        return flash_attention(ql, kl, vl, **kw)

    return _dist.run(local, mesh, (q, k, v), (q_want, kv_want, kv_want),
                     q_want)


flash_attention.launches = 0

__all__ = ["flash_attention", "flash_attention_blockwise",
           "flash_attention_ref"]
