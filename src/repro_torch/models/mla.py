"""Multi-head Latent Attention (DeepSeek-V2): a low-rank compressed KV cache.

The cache holds, per token, the normalised latent ckv (kv_lora_rank) and the
shared rope key krope (qk_rope_head_dim).  Prefill decompresses the latent
into per-head keys of head dim qk_nope + qk_rope (192 at full width) and
values of v_head_dim (128) and runs the flash op on them: on the card the
CUDA kernel's (192, 128) pair.  Decode has two branches, as in the JAX
package:
  * naive (the default): decompress the whole cache to K/V each step;
  * absorb: fold W_uk into the query and W_uv into the output, so attention
    runs against the compressed cache itself.
"""
from __future__ import annotations

import torch

from repro_torch.models import attention as attn
from repro_torch.models.attention import NEG_INF
from repro_torch.models.common import (dense_init, ones_init, rms_norm,
                                       shard_hint, softmax_keys, write_rows)
from repro_torch.models.rope import apply_rope


def init_mla(gen, cfg, n_layers: int, *, device="cuda"):
    m = cfg.mla
    D, H = cfg.d_model, cfg.n_heads
    dn, dr, dv, r = (m.qk_nope_head_dim, m.qk_rope_head_dim, m.v_head_dim,
                     m.kv_lora_rank)
    L = (n_layers,) if n_layers else ()
    return {"wq": dense_init(gen, L + (D, H * (dn + dr)), D, device),
            "wdkv": dense_init(gen, L + (D, r + dr), D, device),
            "kv_norm": ones_init(L + (r,), device=device),
            "wuk": dense_init(gen, L + (r, H * dn), r, device),
            "wuv": dense_init(gen, L + (r, H * dv), r, device),
            "wo": dense_init(gen, L + (H * dv, D), H * dv, device)}


def _project_q(p, x, cfg, sin, cos):
    m = cfg.mla
    H, dn, dr = cfg.n_heads, m.qk_nope_head_dim, m.qk_rope_head_dim
    B, S, _ = x.shape
    q = shard_hint(x @ p["wq"].to(x.dtype), "batch", None, "model_ff")
    q = q.reshape(B, S, H, dn + dr)
    return q[..., :dn], apply_rope(q[..., dn:], sin, cos)


def _compress_kv(p, x, cfg, sin, cos):
    m = cfg.mla
    r = m.kv_lora_rank
    ckv_full = x @ p["wdkv"].to(x.dtype)                      # (B,S,r+dr)
    ckv = rms_norm(ckv_full[..., :r], p["kv_norm"], cfg.norm_eps)
    krope = apply_rope(ckv_full[..., None, r:], sin, cos)[:, :, 0]
    return ckv, krope


def _scale(cfg) -> float:
    return (cfg.mla.qk_nope_head_dim + cfg.mla.qk_rope_head_dim) ** -0.5


def mla_forward(p, x, cfg, sin, cos, *, q_block=1024, kv_block=1024,
                probs_bf16=False):
    """Training / prefill: full-sequence causal MLA.  Returns (out (B,S,D),
    (ckv (B,S,r), krope (B,S,dr)))."""
    m = cfg.mla
    H, dn, dr, dv = (cfg.n_heads, m.qk_nope_head_dim, m.qk_rope_head_dim,
                     m.v_head_dim)
    B, S, _ = x.shape
    qn, qr = _project_q(p, x, cfg, sin, cos)
    ckv, krope = _compress_kv(p, x, cfg, sin, cos)
    kn = shard_hint(ckv @ p["wuk"].to(x.dtype), "batch", None, "model_ff")
    v = shard_hint(ckv @ p["wuv"].to(x.dtype), "batch", None, "model_ff")
    kn, v = kn.reshape(B, S, H, dn), v.reshape(B, S, H, dv)
    q = torch.cat([qn, qr], dim=-1)
    k = torch.cat([kn, krope[:, :, None, :].expand(B, S, H, dr)], dim=-1)
    ctx = attn.flash_attention(q, k, v, scale=_scale(cfg), q_block=q_block,
                               kv_block=kv_block,
                               probs_bf16=probs_bf16)      # (B,S,H,dv)
    out = ctx.reshape(B, S, H * dv) @ p["wo"].to(x.dtype)
    return shard_hint(out, "batch", None, None), (ckv, krope)


def _rows_times(c, w):
    """c @ w, c (B, T, r) and w (r, n).  On a mesh, where the cache c is
    split over B and T: w is made whole (a weight, small beside the cache)
    and each shard multiplies its own rows.  DTensor's matmul on torch 2.11
    folds B and T through a view, which it refuses with T split."""
    if not hasattr(c, "device_mesh"):
        return c @ w
    from repro_torch.kernels import _dist
    _dist.roles(c, {0: "batch", 1: "sequence"}, "mla_decode")
    w = shard_hint(w, None, None)
    return _dist.run(torch.matmul, c.device_mesh, (c, w),
                     (c.placements, w.placements), c.placements)


def mla_decode(p, x, cfg, sin, cos, cache, positions, *, absorb=False):
    """One decode step.  x (B,1,D); cache: (ckv (B,T,r), krope (B,T,dr))
    views of one layer of the decode cache, into which the new token's
    latent and rope key are written in place at each row's position before
    attention reads them.  Returns (out (B,1,D), cache)."""
    m = cfg.mla
    H, dn, dr, dv, r = (cfg.n_heads, m.qk_nope_head_dim, m.qk_rope_head_dim,
                        m.v_head_dim, m.kv_lora_rank)
    B = x.shape[0]
    ckv_c, krope_c = cache
    T = ckv_c.shape[1]
    qn, qr = _project_q(p, x, cfg, sin, cos)                 # (B,1,H,dn/dr)
    ckv_new, krope_new = _compress_kv(p, x, cfg, sin, cos)
    write_rows(ckv_c, ckv_new[:, 0], positions)              # in place
    write_rows(krope_c, krope_new[:, 0], positions)

    kpos = torch.arange(T, device=x.device)
    allow = (kpos[None, :] <= positions[:, None])[:, None, None, :]
    scale = _scale(cfg)
    if absorb:
        wuk = p["wuk"].to(x.dtype).reshape(r, H, dn)
        q_abs = torch.einsum("bshd,rhd->bshr", qn, wuk)      # (B,1,H,r)
        s = (torch.einsum("bshr,btr->bhst", q_abs.float(), ckv_c.float())
             + torch.einsum("bshd,btd->bhst", qr.float(),
                            krope_c.float())) * scale
        prob = torch.softmax(torch.where(allow, s, NEG_INF), dim=-1)
        ctx_r = torch.einsum("bhst,btr->bshr", prob, ckv_c.float())
        wuv = p["wuv"].to(x.dtype).reshape(r, H, dv)
        ctx = torch.einsum("bshr,rhd->bshd", ctx_r.to(x.dtype), wuv)
    else:
        ckv_x = ckv_c.to(x.dtype)
        kn = _rows_times(ckv_x, p["wuk"].to(x.dtype)).reshape(B, T, H, dn)
        vv = _rows_times(ckv_x, p["wuv"].to(x.dtype)).reshape(B, T, H, dv)
        # q whole over the heads (one token's: tiny) and the cache split
        # over its sequence, as attention.decode_attention: an einsum
        # folds B and H, which DTensor on torch 2.11 refuses with H split
        q = shard_hint(torch.cat([qn, qr], dim=-1), "batch", None, None, None)
        k = torch.cat([kn, krope_c.to(x.dtype)[:, :, None, :]
                       .expand(B, T, H, dr)], dim=-1)
        s = torch.einsum("bshe,bthe->bhst", q.float(), k.float()) * scale
        s = torch.where(allow, s, NEG_INF)
        prob = softmax_keys(shard_hint(s, "batch", None, None, "kv_seq"))
        ctx = torch.einsum("bhst,bthd->bshd", prob, vv.float()).to(x.dtype)
    out = ctx.reshape(B, 1, H * dv) @ p["wo"].to(x.dtype)
    return out, (ckv_c, krope_c)


def init_mla_cache(cfg, batch: int, max_len: int, dtype=torch.bfloat16,
                   n_layers=None, device="cuda"):
    """(ckv (L?, B, max_len, r), krope (L?, B, max_len, dr)) of zeros."""
    m = cfg.mla
    L = (n_layers,) if n_layers else ()
    return (torch.zeros(L + (batch, max_len, m.kv_lora_rank), dtype=dtype,
                        device=device),
            torch.zeros(L + (batch, max_len, m.qk_rope_head_dim),
                        dtype=dtype, device=device))
