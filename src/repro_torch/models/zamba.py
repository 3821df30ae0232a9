"""Zamba2-style hybrid: Mamba2 backbone + weight-shared attention blocks.

`cfg.n_layers` Mamba2 layers are grouped; after every `cfg.attn_every`
Mamba layers, a single weight-SHARED transformer block (attention + FFN,
operating on concat(hidden, embedding), 2*d_model in) is applied, followed
by a per-application (unshared) linear adapter back to d_model, following
the Zamba2 design.

Serving: `forward(mode="prefill", cache=...)` runs the whole prompt at
once, each Mamba2 layer through the chunked SSD (the kernel on the card)
and the shared block through flash attention, and writes every layer's SSM
state and conv ring and every application's K/V into the cache in place;
`decode_step` then carries that cache one token at a time
(`mamba2.mamba_decode`, decode attention).  The cache keeps the JAX
package's tree and layout (`init_cache`).
"""
from __future__ import annotations

import torch

from repro_torch.models import attention as attn
from repro_torch.models import mamba2
from repro_torch.models.common import (Options, dense_init, embed_init,
                                       ones_init, rms_norm, unstack)
from repro_torch.models.rope import apply_rope, rope_angles
from repro_torch.models.transformer import apply_ffn, init_ffn

def n_groups(cfg) -> int:
    if cfg.n_layers % cfg.attn_every:
        raise ValueError(f"n_layers {cfg.n_layers} is not a multiple of "
                         f"attn_every {cfg.attn_every}")
    return cfg.n_layers // cfg.attn_every


def init_lm(gen, cfg, device="cuda"):
    """fp32 params, the JAX package's tree."""
    G = n_groups(cfg)
    D = cfg.d_model
    shared = {
        "ln1": ones_init((2 * D,), device=device),
        "attn": attn.init_attention(gen, cfg, 0, device=device, d_in=2 * D),
        "ln2": ones_init((D,), device=device),
        "mlp": init_ffn(gen, cfg, 0, device=device),
    }
    return {
        "embed": embed_init(gen, (cfg.padded_vocab, D), device),
        "mamba_ln": ones_init((cfg.n_layers, D), device=device),
        "mamba": mamba2.init_mamba(gen, cfg, cfg.n_layers, device=device),
        "shared": shared,
        "adapters": dense_init(gen, (G, D, D), D, device),
        "final_norm": ones_init((D,), device=device),
        "head": dense_init(gen, (D, cfg.padded_vocab), D, device),
    }


def _shared_block(params, cfg, x, x0, sin, cos, adapter, *, opts, kv=None,
                  positions=None):
    """Shared attention block on concat(x, x0); the adapter projects back.

    Without `positions`: causal flash attention over the whole sequence
    (train, prefill), and with `kv`, (k, v) (B,T,n_kv,hd) views of this
    application's cache, the sequence's K/V written into rows [0, S).
    With `positions` (decode): the new token's K/V are written into `kv`
    at each row's position and decode attention reads the cache.  Writes
    are in place."""
    sp = params["shared"]
    h = rms_norm(torch.cat([x, x0], dim=-1), sp["ln1"], cfg.norm_eps)
    q, k, v = attn.project_qkv(sp["attn"], h, cfg)
    q = apply_rope(q, sin, cos)
    k = apply_rope(k, sin, cos)
    scale = cfg.resolved_head_dim ** -0.5
    if positions is None:
        ctx = attn.flash_attention(q, k, v, scale=scale,
                                   q_block=opts.q_block,
                                   kv_block=opts.kv_block,
                                   probs_bf16=opts.probs_bf16)
        if kv is not None:
            S = x.shape[1]
            kv[0][:, :S] = k                                    # in place
            kv[1][:, :S] = v
    else:
        k_c, v_c = kv
        rows = torch.arange(x.shape[0], device=x.device)
        k_c[rows, positions] = k[:, 0].to(k_c.dtype)            # in place
        v_c[rows, positions] = v[:, 0].to(v_c.dtype)
        ctx = attn.decode_attention(q, k_c.to(q.dtype), v_c.to(q.dtype),
                                    positions, scale=scale)
    a = attn.project_out(sp["attn"], ctx, cfg)
    a = a + apply_ffn(sp["mlp"], rms_norm(a, sp["ln2"], cfg.norm_eps), cfg)
    return x + a @ adapter.to(x.dtype)


def _layers(params, cfg):
    """Per-layer views of the stacked Mamba2 params and norms and of the
    adapters (`unstack`)."""
    G = n_groups(cfg)
    return (unstack(params["mamba"], cfg.n_layers),
            unstack(params["mamba_ln"], cfg.n_layers),
            unstack(params["adapters"], G))


def forward(params, cfg, tokens, *, opts: Options = None, mode: str = "train",
            dtype=torch.bfloat16, cache=None):
    """tokens (B,S) -> logits (B,S,Vp) (train), or (last-position logits
    (B,Vp), cache) (prefill).  Prefill writes every layer's SSM state and
    conv ring and each shared-block application's K/V (rows [0, S)) into
    `cache` (see init_cache) in place; without one it makes a cache of
    max_len S in `dtype`."""
    if mode not in ("train", "prefill"):
        raise ValueError(f"mode {mode!r}")
    opts = opts or Options()
    B, S = tokens.shape
    G, E = n_groups(cfg), cfg.attn_every
    prefill = mode == "prefill"
    if prefill and cache is None:
        cache = init_cache(cfg, B, S, dtype=dtype, device=tokens.device)
    x = params["embed"][tokens].to(dtype)
    x0 = x
    sin, cos = rope_angles(torch.arange(S, device=tokens.device),
                           cfg.resolved_head_dim, cfg.rope_theta)
    layers, norms, adapters = _layers(params, cfg)
    for g in range(G):
        for i in range(g * E, (g + 1) * E):
            h = rms_norm(x, norms[i], cfg.norm_eps)
            if prefill:
                out, st = mamba2.mamba_forward(layers[i], h, cfg,
                                               return_cache=True)
                cache["mamba"]["ssm"][i] = st["ssm"]            # in place
                cache["mamba"]["conv"][i] = st["conv"]
                x = x + out
            else:
                x = x + mamba2.mamba_forward(layers[i], h, cfg)
        kv = (cache["kv"][0][g], cache["kv"][1][g]) if prefill else None
        x = _shared_block(params, cfg, x, x0, sin, cos, adapters[g],
                          opts=opts, kv=kv)
    if prefill:
        # serving only needs next-token logits; the norm is per position
        x = rms_norm(x[:, -1], params["final_norm"], cfg.norm_eps)
        return x @ params["head"].to(x.dtype), cache
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return x @ params["head"].to(x.dtype)


def init_cache(cfg, batch: int, max_len: int, dtype=torch.bfloat16,
               device="cuda"):
    """{"kv": (k, v), each (G, B, max_len, n_kv, hd) in `dtype`, one per
    shared-block application; "mamba": {"ssm": (L, B, H, hd, N), "conv":
    (L, B, W-1, convch)} fp32}: the JAX package's tree, zeros."""
    shape = (n_groups(cfg), batch, max_len, cfg.n_kv_heads,
             cfg.resolved_head_dim)
    return {"kv": (torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device)),
            "mamba": mamba2.init_mamba_state(cfg, batch, cfg.n_layers,
                                             device=device)}


def decode_step(params, cfg, tokens, positions, cache, *, opts: Options = None,
                dtype=torch.bfloat16):
    """One token per sequence.  tokens/positions (B,).  Writes each layer's
    new SSM state and conv ring and each application's new K/V into `cache`
    in place.  Returns (logits (B,Vp), cache)."""
    opts = opts or Options()
    G, E = n_groups(cfg), cfg.attn_every
    x = params["embed"][tokens][:, None].to(dtype)
    x0 = x
    sin, cos = rope_angles(positions[:, None], cfg.resolved_head_dim,
                           cfg.rope_theta)
    layers, norms, adapters = _layers(params, cfg)
    ssm, conv = cache["mamba"]["ssm"], cache["mamba"]["conv"]
    for g in range(G):
        for i in range(g * E, (g + 1) * E):
            h = rms_norm(x, norms[i], cfg.norm_eps)
            out, st = mamba2.mamba_decode(layers[i], h, cfg,
                                          {"ssm": ssm[i], "conv": conv[i]})
            ssm[i] = st["ssm"]                                  # in place
            conv[i] = st["conv"]
            x = x + out
        x = _shared_block(params, cfg, x, x0, sin, cos, adapters[g],
                          opts=opts, kv=(cache["kv"][0][g], cache["kv"][1][g]),
                          positions=positions)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return (x @ params["head"].to(x.dtype))[:, 0], cache
