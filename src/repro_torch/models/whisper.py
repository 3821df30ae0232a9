"""Whisper-style encoder-decoder backbone (audio family), as the JAX
package's `models/whisper.py`.

The conv frontend is a stub: the caller supplies frame embeddings
(B, n_frames, d_model).  Positions are sinusoidal on both sides; norms are
LayerNorm; the MLP is the non-gated GELU one; a decoder block is causal
self-attention, cross-attention to the encoder's memory, then the MLP.

Attention runs through the flash op: the encoder's and the
cross-attention's without the causal mask (the cross-attention's S decoder
queries against the F frames), the decoder's self-attention causal.  K/V
are read by group, never expanded.  Unlike the JAX version, which returns
a small cache that `greedy_generate` splices into the large one, prefill
writes the self-attention K/V and the memory into the preallocated cache
(see init_cache) in place; decode writes its token's K/V in place and runs
the cross-attention through `attend_once`, recomputing the memory's K/V
every step as the JAX version does.
"""
from __future__ import annotations

import math

import torch

from repro_torch.models import attention as attn
from repro_torch.models.common import (Options, embed_init, layer_norm,
                                       layer_params, unstack)
from repro_torch.models.transformer import apply_ffn, init_ffn

_ENC_KEYS = ("ln1", "attn", "ln2", "mlp")
_DEC_KEYS = ("ln1", "self_attn", "ln_x", "cross_attn", "ln2", "mlp")


def sinusoid(positions, D: int):
    """(S,) or (B,S) int -> (..., D) fp32 sinusoidal embedding (whisper
    layout: the sines, then the cosines)."""
    half = D // 2
    freq = torch.exp(-math.log(10000.0) * torch.arange(
        half, dtype=torch.float32, device=positions.device) / (half - 1))
    ang = positions.float()[..., None] * freq
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _ln(n_layers, D, device):
    L = (n_layers,) if n_layers else ()
    return {"s": torch.ones(L + (D,), device=device),
            "b": torch.zeros(L + (D,), device=device)}


def init_lm(gen, cfg, device="cuda"):
    """fp32 params {"embed", "enc", "dec"}, the JAX package's tree; the
    layers stacked on a leading (L, ...) dim."""
    Le, Ld, D = cfg.encoder.n_layers, cfg.n_layers, cfg.d_model
    return {
        "embed": embed_init(gen, (cfg.padded_vocab, D), device),
        "enc": {
            "ln1": _ln(Le, D, device),
            "attn": attn.init_attention(gen, cfg, Le, device=device),
            "ln2": _ln(Le, D, device),
            "mlp": init_ffn(gen, cfg, Le, device=device),
            "ln_post": _ln(0, D, device),
        },
        "dec": {
            "ln1": _ln(Ld, D, device),
            "self_attn": attn.init_attention(gen, cfg, Ld, device=device),
            "ln_x": _ln(Ld, D, device),
            "cross_attn": attn.init_attention(gen, cfg, Ld, device=device),
            "ln2": _ln(Ld, D, device),
            "mlp": init_ffn(gen, cfg, Ld, device=device),
            "ln_post": _ln(0, D, device),
        },
    }


def _norm(x, p):
    return layer_norm(x, p["s"], p["b"])


def _scale(cfg) -> float:
    return cfg.resolved_head_dim ** -0.5


def encode(params, cfg, frames, *, opts: Options):
    """frames (B,F,D) -> memory (B,F,D): non-causal self-attention."""
    ep = params["enc"]
    x = frames + sinusoid(torch.arange(frames.shape[1], device=frames.device),
                          cfg.d_model).to(frames.dtype)
    for lp in unstack({k: ep[k] for k in _ENC_KEYS}, cfg.encoder.n_layers):
        h = _norm(x, lp["ln1"])
        q, k, v = attn.project_qkv(lp["attn"], h, cfg)
        ctx = attn.flash_attention(q, k, v, causal=False, scale=_scale(cfg),
                                   q_block=opts.q_block,
                                   kv_block=opts.kv_block)
        x = x + attn.project_out(lp["attn"], ctx, cfg)
        h = _norm(x, lp["ln2"])
        x = x + apply_ffn(lp["mlp"], h, cfg)
    return _norm(x, ep["ln_post"])


def _cross_q(lp, h, cfg):
    B, S, _ = h.shape
    hq_pad, _ = attn.head_padding(cfg)
    return (h @ lp["cross_attn"]["wq"].to(h.dtype)).reshape(
        B, S, hq_pad, cfg.resolved_head_dim)


def _cross_kv(lp, memory, cfg):
    """The memory's cross-attention K/V, each (B,F,G,hd)."""
    hd = cfg.resolved_head_dim
    B, F, _ = memory.shape
    k = (memory @ lp["cross_attn"]["wk"].to(memory.dtype)).reshape(
        B, F, cfg.n_kv_heads, hd)
    v = (memory @ lp["cross_attn"]["wv"].to(memory.dtype)).reshape(
        B, F, cfg.n_kv_heads, hd)
    return k, v


def _logits(params, x):
    return x @ params["embed"].to(x.dtype).T


def forward(params, cfg, tokens, *, encoder_frames, opts: Options = None,
            mode: str = "train", dtype=torch.bfloat16, cache=None):
    """tokens (B,S) + encoder_frames (B,F,D) -> logits (B,S,Vp) (train), or
    (last-position logits (B,Vp), cache) (prefill).

    Prefill writes the decoder's K/V into rows [0, S) of `cache["kv"]` and
    the memory into `cache["memory"]`, in place (see init_cache); without
    a cache it returns {"kv": (K, V) each (L,B,S,G,hd), "memory"}."""
    opts = opts or Options()
    B, S = tokens.shape
    memory = encode(params, cfg, encoder_frames.to(dtype), opts=opts)
    dp = params["dec"]
    x = params["embed"][tokens].to(dtype)
    x = x + sinusoid(torch.arange(S, device=tokens.device),
                     cfg.d_model).to(dtype)
    kw = dict(scale=_scale(cfg), q_block=opts.q_block, kv_block=opts.kv_block)
    entries = []
    for i, lp in enumerate(unstack({k: dp[k] for k in _DEC_KEYS},
                                   cfg.n_layers)):
        h = _norm(x, lp["ln1"])
        q, k, v = attn.project_qkv(lp["self_attn"], h, cfg)
        ctx = attn.flash_attention(q, k, v, causal=True, **kw)
        x = x + attn.project_out(lp["self_attn"], ctx, cfg)
        h = _norm(x, lp["ln_x"])
        kc, vc = _cross_kv(lp, memory, cfg)
        ctx = attn.flash_attention(_cross_q(lp, h, cfg), kc, vc,
                                   causal=False, **kw)
        x = x + attn.project_out(lp["cross_attn"], ctx, cfg)
        h = _norm(x, lp["ln2"])
        x = x + apply_ffn(lp["mlp"], h, cfg)
        if mode == "prefill" and cache is None:
            entries.append((k, v))
        elif mode == "prefill":
            for dst, src in zip(cache["kv"], (k, v)):
                dst[i, :, :S] = src                           # in place
    x = _norm(x, dp["ln_post"])
    if mode == "prefill":
        # serving only needs next-token logits after prefill
        logits = _logits(params, x[:, -1:])[:, 0]
        if cache is None:
            cache = {"kv": tuple(torch.stack(t) for t in zip(*entries)),
                     "memory": memory}
        else:
            cache["memory"][...] = memory                     # in place
        return logits, cache
    return _logits(params, x)


def init_cache(cfg, batch: int, max_len: int, dtype=torch.bfloat16,
               device="cuda"):
    """{"kv": (K, V) each (L, B, max_len, G, hd), "memory" (B, F, D)} of
    zeros."""
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads,
             cfg.resolved_head_dim)
    return {"kv": (torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device)),
            "memory": torch.zeros((batch, cfg.encoder.n_frames, cfg.d_model),
                                  dtype=dtype, device=device)}


def decode_step(params, cfg, tokens, positions, cache, *, opts: Options = None,
                dtype=torch.bfloat16):
    """One decoder token per sequence against the self-attention cache and
    the encoder's memory.  tokens/positions (B,).  Writes the token's K/V
    into `cache` in place.  Returns (logits (B,Vp), cache)."""
    B = tokens.shape[0]
    dp = params["dec"]
    memory = cache["memory"].to(dtype)
    x = params["embed"][tokens[:, None]].to(dtype)
    x = x + sinusoid(positions[:, None], cfg.d_model).to(dtype)
    rows = torch.arange(B, device=tokens.device)
    for i in range(cfg.n_layers):
        lp = layer_params({k: dp[k] for k in _DEC_KEYS}, i)
        h = _norm(x, lp["ln1"])
        q, k_new, v_new = attn.project_qkv(lp["self_attn"], h, cfg)
        k_c, v_c = (c[i] for c in cache["kv"])
        k_c[rows, positions] = k_new[:, 0].to(k_c.dtype)       # in place
        v_c[rows, positions] = v_new[:, 0].to(v_c.dtype)
        ctx = attn.decode_attention(q, k_c.to(q.dtype), v_c.to(q.dtype),
                                    positions, scale=_scale(cfg))
        x = x + attn.project_out(lp["self_attn"], ctx, cfg)
        h = _norm(x, lp["ln_x"])
        kc, vc = _cross_kv(lp, memory, cfg)
        ctx = attn.attend_once(_cross_q(lp, h, cfg), kc, vc,
                               scale=_scale(cfg))
        x = x + attn.project_out(lp["cross_attn"], ctx, cfg)
        h = _norm(x, lp["ln2"])
        x = x + apply_ffn(lp["mlp"], h, cfg)
    x = _norm(x, dp["ln_post"])
    return _logits(params, x)[:, 0], cache
