"""Decoder-only transformer LM covering the dense / moe / vlm families:
gemma2-2b (local + global layers, softcaps), deepseek-7b, qwen2.5-32b,
deepseek-67b, qwen2-vl-2b (M-RoPE), deepseek-v2-lite (MLA + MoE) and
arctic-480b (MoE + dense residual).

Layers are stacked on a leading (L, ...) dim, as in the JAX package, and run
by a Python loop over their `unstack`ed views; MoE configs with
`first_dense_layers` keep those leading layers unstacked in
`params["first"]`.  In training each stacked block runs under
`maybe_remat(opts.remat)`, as the JAX scan body does; the JAX package
applies remat in the transformer only, so the rwkv and hybrid families
accept the option and ignore it there too.  In training, `forward(...,
return_aux=True)` also returns the sum over the MoE layers of
`apply_moe`'s router aux loss, which `runtime.train_step` adds to the
loss, as the JAX package's train mode returns and adds it.

Each block runs in two spans (`core.engine.tracing.span`): `block.attention`,
holding `attention.qkv` (projections and rope), `attention.cache_write`,
`attention.core` (flash in prefill, `decode_attention` in decode) and
`attention.out`, then `block.ffn`; the embedding and the head run in
`model.embed` and `model.head`.  Without a profiler they record nothing.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core.engine.tracing import span
from repro_torch.models import attention as attn
from repro_torch.models import mla as mla_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models.common import (Options, activation, dense_init,
                                       embed_init, layer_params, maybe_remat,
                                       ones_init, rms_norm, shard_hint,
                                       softcap, unstack, write_at,
                                       write_rows)
from repro_torch.models.rope import apply_rope, mrope_angles, rope_angles


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
    h = shard_hint(h, "batch", None, "model_ff")
    return shard_hint(h @ p["w2"].to(x.dtype), "batch", None, None)


# ---------------------------------------------------------------------------
# Block
# ---------------------------------------------------------------------------


def init_block(gen, cfg, n_layers: int, *, device="cuda",
               use_moe: bool = False, d_ff: Optional[int] = None):
    L = (n_layers,) if n_layers else ()
    fill = torch.zeros if cfg.rms_plus_one else ones_init  # gemma: zero-centred
    p = {"ln1": fill(L + (cfg.d_model,), device=device),
         "ln2": fill(L + (cfg.d_model,), device=device)}
    if cfg.post_norms:
        p["pn1"] = p["ln1"].clone()
        p["pn2"] = p["ln2"].clone()
    if cfg.mla is not None:
        p["attn"] = mla_mod.init_mla(gen, cfg, n_layers, device=device)
    else:
        p["attn"] = attn.init_attention(gen, cfg, n_layers, device=device)
    if use_moe:
        p["mlp"] = moe_mod.init_moe(gen, cfg, n_layers, device=device)
    else:
        p["mlp"] = init_ffn(gen, cfg, n_layers, device=device, d_ff=d_ff)
    return p


def _norm(x, scale, cfg):
    return rms_norm(x, scale, cfg.norm_eps, plus_one=cfg.rms_plus_one)


def _attn_scale(cfg) -> float:
    if cfg.query_pre_attn_scalar:
        return cfg.query_pre_attn_scalar ** -0.5
    return cfg.resolved_head_dim ** -0.5


def _attention(bp, h, cfg, sin, cos, *, opts: Options, window, cache,
               positions):
    """The block's attention on normed h: (out, the block's new cache
    entry): K/V (B,S,G,hd), or MLA's (ckv, krope)."""
    if cfg.mla is not None:
        if cache is not None:
            return mla_mod.mla_decode(bp["attn"], h, cfg, sin, cos, cache,
                                      positions, absorb=opts.mla_absorb)
        return mla_mod.mla_forward(bp["attn"], h, cfg, sin, cos,
                                   q_block=opts.q_block,
                                   kv_block=opts.kv_block,
                                   probs_bf16=opts.probs_bf16)
    with span("attention.qkv"):
        q, k, v = attn.project_qkv(bp["attn"], h, cfg)
        q = apply_rope(q, sin, cos)
        k = apply_rope(k, sin, cos)
    if cache is not None:
        k_c, v_c = cache
        with span("attention.cache_write"):
            write_rows(k_c, k[:, 0], positions)             # in place
            write_rows(v_c, v[:, 0], positions)
        with span("attention.core"):
            ctx = attn.decode_attention(
                q, k_c.to(q.dtype), v_c.to(q.dtype), positions,
                window=window, logit_softcap=cfg.attn_logit_softcap,
                scale=_attn_scale(cfg))
    else:
        with span("attention.core"):
            ctx = attn.flash_attention(
                q, k, v, window=window,
                logit_softcap=cfg.attn_logit_softcap,
                scale=_attn_scale(cfg), q_block=opts.q_block,
                kv_block=opts.kv_block, probs_bf16=opts.probs_bf16)
    with span("attention.out"):
        return attn.project_out(bp["attn"], ctx, cfg), (k, v)


def apply_block(bp, x, cfg, sin, cos, *, opts: Options, window=None,
                cache=None, positions=None):
    """One transformer block; returns (x, the block's new cache entry,
    the MoE's aux loss): the entry (k, v) (B,S,G,hd), or MLA's (ckv (B,S,r),
    krope (B,S,dr)); the aux loss an fp32 scalar, None without a MoE (so
    that a dense decode step launches nothing for it).

    Without `cache`: causal attention over x itself (train / prefill).
    With `cache`, views of one layer of the decode cache, (k, v) (B,T,G,hd)
    or MLA's (ckv, krope): one decode step; the new token's entry is
    written into the cache in place at each row's position before
    attention reads it.
    """
    with span("block.attention"):
        h = _norm(x, bp["ln1"], cfg)
        a_out, entry = _attention(bp, h, cfg, sin, cos, opts=opts,
                                  window=window, cache=cache,
                                  positions=positions)
        if cfg.post_norms:
            a_out = _norm(a_out, bp["pn1"], cfg)
        x = x + a_out

    with span("block.ffn"):
        h = _norm(x, bp["ln2"], cfg)
        if "router" in bp["mlp"]:
            f_out, aux = moe_mod.apply_moe(bp["mlp"], h, cfg,
                                           group_size=opts.moe_group)
        else:
            f_out, aux = apply_ffn(bp["mlp"], h, cfg), None
        if cfg.post_norms:
            f_out = _norm(f_out, bp["pn2"], cfg)
        return x + f_out, entry, aux


def _train_block(bp, x, sin, cos, *, cfg, opts: Options, window):
    """apply_block in training: the residual stream and the aux loss
    alone, so that remat keeps nothing of the block but its inputs."""
    x, _, aux = apply_block(bp, x, cfg, sin, cos, opts=opts, window=window)
    return x, aux


# ---------------------------------------------------------------------------
# Full LM
# ---------------------------------------------------------------------------


def _n_first(cfg) -> int:
    return cfg.moe.first_dense_layers if cfg.moe is not None else 0


def init_lm(gen, cfg, device="cuda"):
    """fp32 params: {"embed"[, "first"], "blocks", "final_norm"[, "head"]};
    "first" is a tuple of unstacked dense blocks at the MoE's dense_d_ff."""
    p = {"embed": embed_init(gen, (cfg.padded_vocab, cfg.d_model), device)}
    n_first = _n_first(cfg)
    if n_first:
        dff = cfg.moe.dense_d_ff or cfg.d_ff
        p["first"] = tuple(init_block(gen, cfg, 0, device=device, d_ff=dff)
                           for _ in range(n_first))
    p["blocks"] = init_block(gen, cfg, cfg.n_layers - n_first, device=device,
                             use_moe=cfg.moe is not None)
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
    with span("model.embed"):
        x = F.embedding(tokens, params["embed"]).to(dtype)
        if cfg.embed_scale:
            x = x * torch.tensor(cfg.d_model ** 0.5, dtype=dtype)
        return shard_hint(x, "batch", None, None)


def _head(params, cfg, x):
    with span("model.head"):
        if cfg.tie_embeddings:
            logits = x @ params["embed"].to(x.dtype).T
        else:
            logits = x @ params["head"].to(x.dtype)
        return shard_hint(softcap(logits, cfg.final_logit_softcap), "batch",
                          None, "vocab")


def _angles(cfg, positions, mrope_positions=None):
    """RoPE sin/cos at `positions`, over MLA's rope dims under MLA, or
    M-RoPE's from the (3, B, S) streams where the config and the caller
    give them."""
    hd = (cfg.mla.qk_rope_head_dim if cfg.mla is not None
          else cfg.resolved_head_dim)
    if cfg.mrope and mrope_positions is not None:
        return mrope_angles(mrope_positions, cfg.mrope_sections, hd,
                            cfg.rope_theta)
    return rope_angles(positions, hd, cfg.rope_theta)


def forward(params, cfg, tokens, *, opts: Options = None, mode: str = "train",
            dtype=torch.bfloat16, cache=None, mrope_positions=None,
            return_aux: bool = False):
    """tokens (B,S) -> logits (B,S,Vp)  (train; with return_aux, (logits,
    the MoE layers' summed aux loss, an fp32 scalar)), or
    (last-position logits (B,Vp), cache) (prefill).

    Prefill returns {"layers": entries stacked over the stacked blocks,
    "first": one entry a first layer}, an entry being (k, v) (B,S,G,hd) or
    MLA's (ckv, krope); given a preallocated `cache` (see init_cache) it
    writes into it instead.  mrope_positions: (3, B, S) M-RoPE streams."""
    opts = opts or Options()
    B, S = tokens.shape
    x = _embed(params, cfg, tokens, dtype)
    sin, cos = _angles(cfg, torch.arange(S, device=tokens.device),
                       mrope_positions)
    L = cfg.n_layers - _n_first(cfg)
    windows = _layer_windows(cfg, L, S)
    firsts, auxes = [], []
    for i, fb in enumerate(params.get("first", ())):
        x, entry, aux_l = apply_block(fb, x, cfg, sin, cos, opts=opts)
        auxes.append(aux_l)
        if mode == "prefill" and cache is None:
            firsts.append(entry)
        elif mode == "prefill":
            with span("attention.cache_write"):
                for dst, src in zip(cache["first"][i], entry):
                    write_at(dst, (slice(None), slice(0, S)), src)  # in place
    entries = []
    block = maybe_remat(_train_block, opts.remat)
    for i, bp in enumerate(unstack(params["blocks"], L)):
        if mode == "train":
            x, aux_l = block(bp, x, sin, cos, cfg=cfg, opts=opts,
                             window=windows[i])
            auxes.append(aux_l)
            continue
        x, entry, _ = apply_block(bp, x, cfg, sin, cos, opts=opts,
                                  window=windows[i])
        if mode == "prefill" and cache is None:
            entries.append(entry)
        elif mode == "prefill":
            with span("attention.cache_write"):
                for dst, src in zip(cache["layers"], entry):
                    write_at(dst, (i, slice(None), slice(0, S)), src)

    if mode == "prefill":
        # serving only needs next-token logits after prefill
        x_last = _norm(x[:, -1:], params["final_norm"], cfg)
        logits = _head(params, cfg, x_last)[:, 0]
        if cache is None:
            cache = {"layers": tuple(torch.stack(t) for t in zip(*entries)),
                     "first": tuple(firsts)}
        return logits, cache
    x = _norm(x, params["final_norm"], cfg)
    logits = _head(params, cfg, x)
    if not return_aux:
        return logits
    aux = torch.zeros((), dtype=torch.float32, device=tokens.device)
    for a in auxes:
        if a is not None:
            aux = aux + a
    return logits, aux


def init_cache(cfg, batch: int, max_len: int, dtype=torch.bfloat16,
               device="cuda"):
    """Decode cache: {"layers": entry with a leading dim over the stacked
    blocks, "first": one entry a first layer}; an entry is (k, v), each
    (B, max_len, G, hd), or MLA's (ckv (B, max_len, r), krope (B, max_len,
    dr))."""
    n_first = _n_first(cfg)
    L = cfg.n_layers - n_first
    if cfg.mla is not None:
        def entry(n):
            return mla_mod.init_mla_cache(cfg, batch, max_len, dtype, n,
                                          device)
    else:
        def entry(n):
            shape = ((n,) if n else ()) + (batch, max_len, cfg.n_kv_heads,
                                           cfg.resolved_head_dim)
            return (torch.zeros(shape, dtype=dtype, device=device),
                    torch.zeros(shape, dtype=dtype, device=device))
    return {"layers": entry(L),
            "first": tuple(entry(0) for _ in range(n_first))}


def decode_step(params, cfg, tokens, positions, cache, *, opts: Options = None,
                dtype=torch.bfloat16):
    """One token per sequence. tokens/positions (B,).  Writes the new cache
    entries into `cache` in place.  Returns (logits (B,Vp), cache)."""
    opts = opts or Options()
    B = tokens.shape[0]
    x = _embed(params, cfg, tokens[:, None], dtype)
    pos2d = positions[:, None]                               # (B,1)
    mpos = pos2d[None].expand(3, B, 1) if cfg.mrope else None
    sin, cos = _angles(cfg, pos2d, mpos)
    for fb, fc in zip(params.get("first", ()), cache["first"]):
        x, _, _ = apply_block(fb, x, cfg, sin, cos, opts=opts, cache=fc,
                              positions=positions)
    layers = cache["layers"]
    L = cfg.n_layers - _n_first(cfg)
    windows = _layer_windows(cfg, L, layers[0].shape[2])
    for i in range(L):
        x, _, _ = apply_block(layer_params(params["blocks"], i), x, cfg,
                              sin, cos, opts=opts, window=windows[i],
                              cache=tuple(c[i] for c in layers),
                              positions=positions)
    x = _norm(x, params["final_norm"], cfg)
    return _head(params, cfg, x)[:, 0], cache
