"""Decoder-only transformer LM, dense family (gemma2-2b and kin).

Layers are stacked on a leading (L, ...) dim, as in the JAX package, and run
by a Python loop over their `unstack`ed views.  In training each block runs
under `maybe_remat(opts.remat)`, as the JAX scan body does; the JAX package
applies remat in the transformer only, so the rwkv and hybrid families
accept the option and ignore it there too.  The MoE and MLA branches of the
JAX file are not ported yet and raise.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models import attention as attn
from repro_torch.models.common import (Options, activation, dense_init,
                                       embed_init, layer_params, maybe_remat,
                                       ones_init, rms_norm, softcap, unstack)
from repro_torch.models.rope import apply_rope, rope_angles


def _check_family(cfg):
    if cfg.mla is not None or cfg.moe is not None or cfg.mrope:
        raise NotImplementedError(
            f"{cfg.name}: MLA, MoE and M-RoPE are not ported yet")


# ---------------------------------------------------------------------------
# FFN
# ---------------------------------------------------------------------------


def init_ffn(gen, cfg, n_layers: int, *, device="cuda",
             d_ff: Optional[int] = None):
    D, F = cfg.d_model, d_ff or cfg.d_ff
    L = (n_layers,) if n_layers else ()
    p = {"w1": dense_init(gen, L + (D, F), D, device)}
    if cfg.gated_mlp:
        p["w3"] = dense_init(gen, L + (D, F), D, device)
    p["w2"] = dense_init(gen, L + (F, D), F, device)
    return p


def apply_ffn(p, x, cfg):
    act = activation(cfg.act)
    h = x @ p["w1"].to(x.dtype)
    if "w3" in p:
        h = act(h) * (x @ p["w3"].to(x.dtype))
    else:
        h = act(h)
    return h @ p["w2"].to(x.dtype)


# ---------------------------------------------------------------------------
# Block
# ---------------------------------------------------------------------------


def init_block(gen, cfg, n_layers: int, *, device="cuda"):
    L = (n_layers,) if n_layers else ()
    fill = torch.zeros if cfg.rms_plus_one else ones_init  # gemma: zero-centred
    p = {"ln1": fill(L + (cfg.d_model,), device=device),
         "ln2": fill(L + (cfg.d_model,), device=device)}
    if cfg.post_norms:
        p["pn1"] = p["ln1"].clone()
        p["pn2"] = p["ln2"].clone()
    p["attn"] = attn.init_attention(gen, cfg, n_layers, device=device)
    p["mlp"] = init_ffn(gen, cfg, n_layers, device=device)
    return p


def _norm(x, scale, cfg):
    return rms_norm(x, scale, cfg.norm_eps, plus_one=cfg.rms_plus_one)


def _attn_scale(cfg) -> float:
    if cfg.query_pre_attn_scalar:
        return cfg.query_pre_attn_scalar ** -0.5
    return cfg.resolved_head_dim ** -0.5


def apply_block(bp, x, cfg, sin, cos, *, opts: Options, window=None,
                cache=None, positions=None):
    """One transformer block; returns (x, (k, v)) with the block's new K/V.

    Without `cache`: causal attention over x itself (train / prefill).
    With `cache`, (k, v) (B,T,G,hd) views of one layer of the decode cache:
    one decode step; the new token's K/V are written into the cache in
    place at each row's position before attention reads it.
    """
    h = _norm(x, bp["ln1"], cfg)
    q, k, v = attn.project_qkv(bp["attn"], h, cfg)
    q = apply_rope(q, sin, cos)
    k = apply_rope(k, sin, cos)
    if cache is not None:
        k_c, v_c = cache
        rows = torch.arange(x.shape[0], device=x.device)
        k_c[rows, positions] = k[:, 0].to(k_c.dtype)     # in place
        v_c[rows, positions] = v[:, 0].to(v_c.dtype)
        ctx = attn.decode_attention(
            q, k_c.to(q.dtype), v_c.to(q.dtype), positions, window=window,
            logit_softcap=cfg.attn_logit_softcap, scale=_attn_scale(cfg))
    else:
        ctx = attn.flash_attention(
            q, k, v, window=window, logit_softcap=cfg.attn_logit_softcap,
            scale=_attn_scale(cfg), q_block=opts.q_block,
            kv_block=opts.kv_block)
    a_out = attn.project_out(bp["attn"], ctx, cfg)
    if cfg.post_norms:
        a_out = _norm(a_out, bp["pn1"], cfg)
    x = x + a_out

    h = _norm(x, bp["ln2"], cfg)
    f_out = apply_ffn(bp["mlp"], h, cfg)
    if cfg.post_norms:
        f_out = _norm(f_out, bp["pn2"], cfg)
    return x + f_out, (k, v)


def _train_block(bp, x, sin, cos, *, cfg, opts: Options, window):
    """apply_block in training: the residual stream alone, so that remat
    keeps nothing of the block but its inputs."""
    return apply_block(bp, x, cfg, sin, cos, opts=opts, window=window)[0]


# ---------------------------------------------------------------------------
# Full LM
# ---------------------------------------------------------------------------


def init_lm(gen, cfg, device="cuda"):
    """fp32 params: {"embed", "blocks", "final_norm"[, "head"]}."""
    _check_family(cfg)
    p = {"embed": embed_init(gen, (cfg.padded_vocab, cfg.d_model), device)}
    p["blocks"] = init_block(gen, cfg, cfg.n_layers, device=device)
    fill = torch.zeros if cfg.rms_plus_one else ones_init
    p["final_norm"] = fill((cfg.d_model,), device=device)
    if not cfg.tie_embeddings:
        p["head"] = dense_init(gen, (cfg.d_model, cfg.padded_vocab),
                               cfg.d_model, device)
    return p


def _layer_windows(cfg, n_layers: int, seq_len: int):
    """Per-layer attention window (None = causal only)."""
    if not cfg.sliding_window:
        return [None] * n_layers
    if not cfg.local_global_every:
        return [cfg.sliding_window] * n_layers
    e = cfg.local_global_every
    return [seq_len + 1 if i % e == e - 1 else cfg.sliding_window
            for i in range(n_layers)]


def _embed(params, cfg, tokens, dtype):
    x = params["embed"][tokens].to(dtype)
    if cfg.embed_scale:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=dtype)
    return x


def _head(params, cfg, x):
    if cfg.tie_embeddings:
        logits = x @ params["embed"].to(x.dtype).T
    else:
        logits = x @ params["head"].to(x.dtype)
    return softcap(logits, cfg.final_logit_softcap)


def forward(params, cfg, tokens, *, opts: Options = None, mode: str = "train",
            dtype=torch.bfloat16, cache=None):
    """tokens (B,S) -> logits (B,S,Vp)  (train), or
    (last-position logits (B,Vp), cache) (prefill).

    Prefill returns {"layers": (k, v)} stacked (L,B,S,G,hd); given a
    preallocated `cache` (see init_cache) it writes into it instead."""
    _check_family(cfg)
    opts = opts or Options()
    B, S = tokens.shape
    x = _embed(params, cfg, tokens, dtype)
    sin, cos = rope_angles(torch.arange(S, device=tokens.device),
                           cfg.resolved_head_dim, cfg.rope_theta)
    L = cfg.n_layers
    windows = _layer_windows(cfg, L, S)
    ks, vs = [], []
    block = maybe_remat(_train_block, opts.remat)
    for i, bp in enumerate(unstack(params["blocks"], L)):
        if mode == "train":
            x = block(bp, x, sin, cos, cfg=cfg, opts=opts, window=windows[i])
            continue
        x, (k, v) = apply_block(bp, x, cfg, sin, cos, opts=opts,
                                window=windows[i])
        if mode == "prefill" and cache is None:
            ks.append(k)
            vs.append(v)
        elif mode == "prefill":
            cache["layers"][0][i, :, :S] = k                  # in place
            cache["layers"][1][i, :, :S] = v

    if mode == "prefill":
        # serving only needs next-token logits after prefill
        x_last = _norm(x[:, -1:], params["final_norm"], cfg)
        logits = _head(params, cfg, x_last)[:, 0]
        if cache is None:
            cache = {"layers": (torch.stack(ks), torch.stack(vs))}
        return logits, cache
    x = _norm(x, params["final_norm"], cfg)
    return _head(params, cfg, x)


def init_cache(cfg, batch: int, max_len: int, dtype=torch.bfloat16,
               device="cuda"):
    """Decode cache: {"layers": (k, v)}, each (L, B, max_len, G, hd)."""
    _check_family(cfg)
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads,
             cfg.resolved_head_dim)
    return {"layers": (torch.zeros(shape, dtype=dtype, device=device),
                       torch.zeros(shape, dtype=dtype, device=device))}


def decode_step(params, cfg, tokens, positions, cache, *, opts: Options = None,
                dtype=torch.bfloat16):
    """One token per sequence. tokens/positions (B,).  Writes the new K/V
    into `cache` in place.  Returns (logits (B,Vp), cache)."""
    _check_family(cfg)
    opts = opts or Options()
    x = _embed(params, cfg, tokens[:, None], dtype)
    sin, cos = rope_angles(positions[:, None], cfg.resolved_head_dim,
                           cfg.rope_theta)
    k_all, v_all = cache["layers"]
    windows = _layer_windows(cfg, cfg.n_layers, k_all.shape[2])
    for i in range(cfg.n_layers):
        x, _ = apply_block(layer_params(params["blocks"], i), x, cfg, sin,
                           cos, opts=opts, window=windows[i],
                           cache=(k_all[i], v_all[i]), positions=positions)
    x = _norm(x, params["final_norm"], cfg)
    return _head(params, cfg, x)[:, 0], cache
