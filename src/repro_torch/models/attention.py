"""Attention: GQA projections, flash attention for prefill, decode attention.

The param layout is the JAX package's: Q heads are padded to a multiple of
the TPU mesh's model axis (group-major flat layout, head h = g*M_pad + m), and
the padded heads' context is masked before W_o, so the math is exact.
Keeping that layout lets the parity tests load JAX params unchanged.

`flash_attention` is the kernel wrapper: the hand-written CUDA kernel on the
card, the plain blockwise version on the CPU, causal or not (whisper's
encoder and cross-attention), with the key length free of the query
length.  It reads K/V by group, so the expanded K/V copy is never built on
the card.  `attend_once` is the one-shot softmax whisper's decode runs its
cross-attention through, as the JAX model does.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels.flash_attention.ops import flash_attention  # noqa: F401
from repro_torch.kernels.flash_attention.ref import NEG_INF, expand_kv  # noqa: F401
from repro_torch.models.common import dense_init, grad_cast, shard_hint, softcap

MODEL_AXIS_SIZE = 16          # the JAX package's production model-axis width


def head_padding(cfg, model_size: int = MODEL_AXIS_SIZE):
    """(Hq_pad, M_pad): pad per-group head count so G*M_pad % model == 0."""
    G = cfg.n_kv_heads
    M = cfg.n_heads // G
    m_pad = M
    while (G * m_pad) % model_size:
        m_pad += 1
    return G * m_pad, m_pad


def kv_shardable(cfg, model_size: int = MODEL_AXIS_SIZE) -> bool:
    return cfg.n_kv_heads % model_size == 0


def head_mask(cfg, device="cuda"):
    """(Hq_pad,) 1.0 for real heads, 0.0 for padding."""
    hq_pad, m_pad = head_padding(cfg)
    M = cfg.n_heads // cfg.n_kv_heads
    return ((torch.arange(hq_pad, device=device) % m_pad) < M).float()


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


def init_attention(gen, cfg, n_layers: int, *, device="cuda",
                   d_in: Optional[int] = None, d_out: Optional[int] = None):
    """Stacked GQA projection params: (L, ...) leading dim; flat head dims
    (padded for Q/O)."""
    d = d_in or cfg.d_model
    do = d_out or cfg.d_model
    hd = cfg.resolved_head_dim
    hq_pad, _ = head_padding(cfg)
    hkv = cfg.n_kv_heads
    L = (n_layers,) if n_layers else ()
    p = {
        "wq": dense_init(gen, L + (d, hq_pad * hd), d, device),
        "wk": dense_init(gen, L + (d, hkv * hd), d, device),
        "wv": dense_init(gen, L + (d, hkv * hd), d, device),
        "wo": dense_init(gen, L + (hq_pad * hd, do), hq_pad * hd, device),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros(L + (hq_pad * hd,), device=device)
        p["bk"] = torch.zeros(L + (hkv * hd,), device=device)
        p["bv"] = torch.zeros(L + (hkv * hd,), device=device)
    return p


def _gather_weights(x, w) -> bool:
    """On a DTensor x: whether a (D, N) weight is no larger than the
    (tokens, N) rows of this device's tokens.  False on a plain tensor."""
    if not hasattr(x, "device_mesh"):
        return False
    return w.shape[0] <= math.prod(x.to_local().shape[:-1])


def _softmax_keys(s):
    """Softmax over the last dim (the keys).  On a DTensor split over the
    keys, each shard's max and sum reduce across the shards
    (flash-decoding), where `torch.softmax` would gather the scores."""
    if not (hasattr(s, "device_mesh")
            and any(p.is_shard(s.dim() - 1) for p in s.placements)):
        return torch.softmax(s, dim=-1)
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    return e / e.sum(dim=-1, keepdim=True)


def project_qkv(p, x, cfg):
    """x (B,S,D) -> q (B,S,Hq_pad,hd), k/v (B,S,G,hd)."""
    hd = cfg.resolved_head_dim
    hq_pad, _ = head_padding(cfg)
    B, S, _ = x.shape
    wk, wv = p["wk"].to(x.dtype), p["wv"].to(x.dtype)
    bk, bv = (p["bk"].to(x.dtype), p["bv"].to(x.dtype)) if "bq" in p \
        else (None, None)
    if not kv_shardable(cfg) and _gather_weights(x, wk):
        # K/V too few to split over the model axis: each model shard
        # computes them whole, from gathered weights where those are no
        # larger than the K/V it would gather, as XLA's partitioner
        # chooses for the reference
        wk, wv = shard_hint(wk, None, None), shard_hint(wv, None, None)
        if bk is not None:
            bk, bv = shard_hint(bk, None), shard_hint(bv, None)
    q = x @ p["wq"].to(x.dtype)
    k = x @ wk
    v = x @ wv
    if "bq" in p:
        q = q + p["bq"].to(x.dtype)
        k = k + bk
        v = v + bv
    q = shard_hint(q, "batch", None, "model_ff")
    if kv_shardable(cfg):
        k = shard_hint(k, "batch", None, "model_ff")
        v = shard_hint(v, "batch", None, "model_ff")
    else:
        k = shard_hint(k, "batch", None, None)
        v = shard_hint(v, "batch", None, None)
    return (grad_cast(q.reshape(B, S, hq_pad, hd)),
            grad_cast(k.reshape(B, S, cfg.n_kv_heads, hd)),
            grad_cast(v.reshape(B, S, cfg.n_kv_heads, hd)))


def project_out(p, ctx, cfg):
    """ctx (B,S,Hq_pad,hd) -> (B,S,d_out); masks padded heads first."""
    B, S = ctx.shape[:2]
    mask = head_mask(cfg, ctx.device)[None, None, :, None].to(ctx.dtype)
    out = (grad_cast(ctx) * mask).reshape(B, S, -1) @ p["wo"].to(ctx.dtype)
    return shard_hint(out, "batch", None, None)


# ---------------------------------------------------------------------------
# One-shot attention (decode / small cross-attention) — plain torch
# ---------------------------------------------------------------------------


def attend_once(q, k, v, *, scale: float):
    """q (B,S,Hq,hd); k, v (B,T,G,hd) with G dividing Hq (head h reads
    group h // (Hq/G), as `expand_kv` lays them out).  A full softmax over
    every key in fp32, no blocks and no mask: the JAX model's `attend_once`
    as whisper's cross-attention calls it, on K/V read by group instead of
    expanded."""
    B, S, H, hd = q.shape
    G = k.shape[2]
    q = shard_hint(q, "batch", None, None, None)     # as decode_attention's
    qg = q.float().reshape(B, S, G, H // G, hd)
    s = torch.einsum("bsgmh,btgh->bgmst", qg, k.float()) * scale
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bgmst,btgh->bsgmh", p, v.float())
    return out.reshape(B, S, H, v.shape[-1]).to(q.dtype)


# ---------------------------------------------------------------------------
# Decode attention (one new token against the cache) — plain torch
# ---------------------------------------------------------------------------


def decode_attention(q, k_cache, v_cache, positions, *, window=None,
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
    p = _softmax_keys(s).to(vc.dtype).float()
    ctx = torch.einsum("bgmt,btgh->bgmh", p, vc.float())
    return ctx.reshape(B, 1, hq_pad, hd).to(q.dtype)
