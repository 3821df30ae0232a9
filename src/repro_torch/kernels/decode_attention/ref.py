"""The plain PyTorch version of decode attention: one new token a batch row
against the layer's cache, as the JAX model computes it
(src/repro/models/attention.py `decode_attention`).  The path tensors on the
CPU, on meta and DTensors take, and what the CUDA kernel is held against on
the card.

It casts the cache to fp32 to multiply the cache's-dtype operands with fp32
sums; the kernel reads the cache in place instead.  On a DTensor split over
the cache's sequence (`kv_seq`), the softmax reduces its max and sum across
the shards (`models.common.softmax_keys`)."""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.ref import NEG_INF
from repro_torch.models.common import shard_hint, softcap, softmax_keys


def decode_attention_ref(q, k_cache, v_cache, positions, *, window=None,
                         logit_softcap: float = 0.0, scale: float):
    """Single-token decode: q (B,1,Hq_pad,hd) against a cache (B,T,G,hd).
    positions: (B,) absolute index of the new token (its KV already written).

    GQA by a grouped product: only q is reshaped, the cache is never
    expanded.  Operands take the cache's dtype and the products accumulate
    in fp32, with the probabilities rounded to the cache's dtype before P.V,
    as the JAX version does."""
    B, T, G, hd = k_cache.shape
    hq_pad = q.shape[2]
    # q whole over the heads (one token's: tiny); the cache is split over
    # its sequence instead
    q = shard_hint(q, "batch", None, None, None)
    qg = q.reshape(B, G, hq_pad // G, hd).to(k_cache.dtype).float()
    kpos = torch.arange(T, device=q.device)
    allow = kpos[None, :] <= positions[:, None]                 # (B,T)
    if window is not None:
        allow &= (positions[:, None] - kpos[None, :]) < window
    kc = shard_hint(k_cache, "batch", "kv_seq", None, None)
    vc = shard_hint(v_cache, "batch", "kv_seq", None, None)
    s = torch.einsum("bgmh,btgh->bgmt", qg, kc.float()) * scale
    s = softcap(s, logit_softcap)
    s = torch.where(allow[:, None, None, :], s, NEG_INF)
    s = shard_hint(s, "batch", None, None, "kv_seq")
    p = softmax_keys(s).to(vc.dtype).float()
    ctx = torch.einsum("bgmt,btgh->bgmh", p, vc.float())
    return ctx.reshape(B, 1, hq_pad, hd).to(q.dtype)
