"""Zamba2-style hybrid: Mamba2 backbone + weight-shared attention blocks.

`cfg.n_layers` Mamba2 layers are grouped; after every `cfg.attn_every`
Mamba layers, a single weight-SHARED transformer block (attention + FFN,
operating on concat(hidden, embedding), 2*d_model in) is applied, followed
by a per-application (unshared) linear adapter back to d_model, following
the Zamba2 design.

The training forward is ported.  Prefill and decode wait for the zamba2
serving slice (ROADMAP Queue 1): the JAX package serves zamba2 token by
token through `mamba_decode`, which is not ported yet.
"""
from __future__ import annotations

import torch

from repro_torch.models import attention as attn
from repro_torch.models import mamba2
from repro_torch.models.common import (Options, dense_init, embed_init,
                                       ones_init, rms_norm, unstack)
from repro_torch.models.rope import apply_rope, rope_angles
from repro_torch.models.transformer import apply_ffn, init_ffn

_SERVING = ("zamba2 serving (prefill, decode, the recurrent state) is not "
            "ported yet: ROADMAP Queue 1, serving zamba2")


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


def _shared_block(params, cfg, x, x0, sin, cos, adapter, *, opts):
    """Shared attention block on concat(x, x0) (causal, over the whole
    sequence); the adapter projects back."""
    sp = params["shared"]
    h = rms_norm(torch.cat([x, x0], dim=-1), sp["ln1"], cfg.norm_eps)
    q, k, v = attn.project_qkv(sp["attn"], h, cfg)
    q = apply_rope(q, sin, cos)
    k = apply_rope(k, sin, cos)
    ctx = attn.flash_attention(q, k, v, scale=cfg.resolved_head_dim ** -0.5,
                               q_block=opts.q_block, kv_block=opts.kv_block)
    a = attn.project_out(sp["attn"], ctx, cfg)
    a = a + apply_ffn(sp["mlp"], rms_norm(a, sp["ln2"], cfg.norm_eps), cfg)
    return x + a @ adapter.to(x.dtype)


def forward(params, cfg, tokens, *, opts: Options = None, mode: str = "train",
            dtype=torch.bfloat16, cache=None):
    """tokens (B,S) -> logits (B,S,Vp).  Train mode only."""
    if mode != "train" or cache is not None:
        raise NotImplementedError(_SERVING)
    opts = opts or Options()
    S = tokens.shape[1]
    G, E = n_groups(cfg), cfg.attn_every
    x = params["embed"][tokens].to(dtype)
    x0 = x
    sin, cos = rope_angles(torch.arange(S, device=tokens.device),
                           cfg.resolved_head_dim, cfg.rope_theta)
    layers = unstack(params["mamba"], cfg.n_layers)
    norms = unstack(params["mamba_ln"], cfg.n_layers)
    adapters = unstack(params["adapters"], G)
    for g in range(G):
        for i in range(g * E, (g + 1) * E):
            h = rms_norm(x, norms[i], cfg.norm_eps)
            x = x + mamba2.mamba_forward(layers[i], h, cfg)
        x = _shared_block(params, cfg, x, x0, sin, cos, adapters[g],
                          opts=opts)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return x @ params["head"].to(x.dtype)


def init_cache(*_, **__):
    raise NotImplementedError(_SERVING)


def decode_step(*_, **__):
    raise NotImplementedError(_SERVING)
