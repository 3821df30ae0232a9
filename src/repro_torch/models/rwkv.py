"""RWKV6 (Finch): attention-free LM with data-dependent per-channel decay.

Time-mix runs the chunked WKV through `kernels.rwkv6_scan.ops.wkv6` (the
CUDA kernel on the card, the plain chunked version on the CPU): within a
chunk the decayed products exp(cum_excl[t,d] - cumw[j,d]) are <= 1 for
j < t, across chunks a (hd_k x hd_v) fp32 state is carried per head.
Decode is the O(1) recurrence.  Norms are LayerNorm (true to RWKV),
channel-mix uses squared ReLU.  Layers are stacked on a leading (L, ...) dim,
as in the JAX package, and run by a Python loop over it.

The dtypes are the JAX model's: projections in the compute dtype; r, k, v,
the log-decay, u and the group norm in fp32.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.rwkv6_scan.ops import wkv6
from repro_torch.models.common import (dense_init, embed_init, layer_norm,
                                       layer_params, ones_init, zeros_init)


def dims(cfg):
    hd = cfg.rwkv.head_dim
    H = cfg.d_model // hd
    return H, hd


def _ln_pair(n_layers, D, device):
    L = (n_layers,) if n_layers else ()
    return {"s": ones_init(L + (D,), device),
            "b": zeros_init(L + (D,), device)}


def init_time_mix(gen, cfg, n_layers: int, *, device="cuda"):
    D = cfg.d_model
    H, hd = dims(cfg)
    tsl, dl = cfg.rwkv.tokenshift_lora, cfg.rwkv.decay_lora
    L = (n_layers,) if n_layers else ()
    return {
        "maa_x": zeros_init(L + (D,), device),
        "maa": zeros_init(L + (5, D), device),              # w,k,v,r,g bases
        "maa_w1": dense_init(gen, L + (D, 5 * tsl), D, device),
        "maa_w2": dense_init(gen, L + (5, tsl, D), tsl, device),
        "w0": zeros_init(L + (D,), device) - 6.0,            # decay base
        "w1": dense_init(gen, L + (D, dl), D, device),
        "w2": dense_init(gen, L + (dl, D), dl, device),
        "u": zeros_init(L + (H, hd), device),                # bonus
        "wr": dense_init(gen, L + (D, D), D, device),
        "wk": dense_init(gen, L + (D, D), D, device),
        "wv": dense_init(gen, L + (D, D), D, device),
        "wg": dense_init(gen, L + (D, D), D, device),
        "out": dense_init(gen, L + (D, D), D, device),
        "ln_x": _ln_pair(n_layers, D, device),
    }


def init_channel_mix(gen, cfg, n_layers: int, *, device="cuda"):
    D, F_ = cfg.d_model, cfg.d_ff
    L = (n_layers,) if n_layers else ()
    return {
        "maa_k": zeros_init(L + (D,), device),
        "maa_r": zeros_init(L + (D,), device),
        "ck": dense_init(gen, L + (D, F_), D, device),
        "cv": dense_init(gen, L + (F_, D), F_, device),
        "cr": dense_init(gen, L + (D, D), D, device),
    }


def _shift(x, last=None):
    """xx[t] = x[t-1]; x (B,S,D); last (B,D) carries across calls."""
    first = (torch.zeros_like(x[:, :1]) if last is None
             else last[:, None].to(x.dtype))
    return torch.cat([first, x[:, :-1]], dim=1)


def _ddlerp(p, x, xx):
    """Data-dependent token-shift interpolation: (x_w, x_k, x_v, x_r, x_g)."""
    B, S, D = x.shape
    dxx = xx - x
    xxx = x + dxx * p["maa_x"].to(x.dtype)
    k = torch.tanh(xxx @ p["maa_w1"].to(x.dtype))             # (B,S,5*tsl)
    k = k.reshape(B, S, 5, k.shape[-1] // 5)
    off = torch.einsum("bstl,tld->bstd", k, p["maa_w2"].to(x.dtype))
    mix = p["maa"].to(x.dtype)[None, None] + off              # (B,S,5,D)
    return tuple(x + dxx * mix[:, :, i] for i in range(5))


def _log_decay_exponent(p, x_w):
    """w_log = w0 + tanh(x_w @ w1) @ w2: the LoRA's first product in the
    compute dtype, the rest in fp32; the log-decay is -exp(w_log)."""
    return (p["w0"].float()
            + torch.tanh(x_w @ p["w1"].to(x_w.dtype)).float()
            @ p["w2"].float())


def _group_norm(y, ln):
    """Per-head norm of fp32 y (..., H, hd) (biased variance, eps 64e-5),
    then ln_x's fp32 scale and bias -> (..., H*hd) fp32."""
    mu = y.mean(dim=-1, keepdim=True)
    var = y.var(dim=-1, keepdim=True, correction=0)
    y = (y - mu) * torch.rsqrt(var + 64e-5)
    return y.flatten(-2) * ln["s"] + ln["b"]


def time_mix(p, x, cfg, *, state=None, chunk=None):
    """x (B,S,D) -> (out, (last_x (B,D), S (B,H,hd,hd) fp32)).

    S is padded with zeros up to a multiple of the chunk: a padded step has
    log-decay 0 and k = 0, so the state passes through it unchanged.  (JAX
    takes one chunk of S steps when S < chunk; a full padded chunk is the
    same function and keeps the kernel's chunk size fixed.)"""
    H, hd = dims(cfg)
    B, S, D = x.shape
    xx = _shift(x, None if state is None else state[0])
    x_w, x_k, x_v, x_r, x_g = _ddlerp(p, x, xx)
    logw = -torch.exp(_log_decay_exponent(p, x_w))            # <= 0
    r = (x_r @ p["wr"].to(x.dtype)).reshape(B, S, H, hd).float()
    k = (x_k @ p["wk"].to(x.dtype)).reshape(B, S, H, hd).float()
    v = (x_v @ p["wv"].to(x.dtype)).reshape(B, S, H, hd).float()
    g = F.silu(x_g @ p["wg"].to(x.dtype))
    u = p["u"].float()

    Q = chunk or cfg.rwkv.chunk
    pad = (-S) % Q
    logw = logw.reshape(B, S, H, hd)
    if pad:
        r, k, v, logw = (F.pad(t, (0, 0, 0, 0, 0, pad))
                         for t in (r, k, v, logw))
    y, S_fin = wkv6(r, k, v, logw, u, chunk=Q,
                    initial_state=None if state is None else state[1])
    y = _group_norm(y[:, :S], p["ln_x"])
    out = (y.to(x.dtype) * g) @ p["out"].to(x.dtype)
    return out, (x[:, -1], S_fin)


def time_mix_decode(p, x, cfg, state):
    """x (B,1,D); state (last_x (B,D), S (B,H,hd,hd))."""
    H, hd = dims(cfg)
    B = x.shape[0]
    last_x, S0 = state
    xx = last_x[:, None].to(x.dtype)
    x_w, x_k, x_v, x_r, x_g = _ddlerp(p, x, xx)
    w = torch.exp(-torch.exp(_log_decay_exponent(p, x_w)))[:, 0] \
        .reshape(B, H, hd)
    r = (x_r @ p["wr"].to(x.dtype)).reshape(B, H, hd).float()
    k = (x_k @ p["wk"].to(x.dtype)).reshape(B, H, hd).float()
    v = (x_v @ p["wv"].to(x.dtype)).reshape(B, H, hd).float()
    g = F.silu(x_g @ p["wg"].to(x.dtype))[:, 0]
    u = p["u"].float()
    # y = r . (S0 + u (x) k v^T); S1 = diag(w) S0 + k v^T
    kv = torch.einsum("bhk,bhv->bhkv", k, v)
    y = torch.einsum("bhk,bhkv->bhv", r, S0 + u[None, ..., None] * kv)
    S1 = S0 * w[..., None] + kv
    y = (_group_norm(y, p["ln_x"]).to(x.dtype) * g) @ p["out"].to(x.dtype)
    return y[:, None], (x[:, -1], S1)


def channel_mix(p, x, cfg, *, state=None):
    xx = _shift(x, state)
    dxx = xx - x
    xk = x + dxx * p["maa_k"].to(x.dtype)
    xr = x + dxx * p["maa_r"].to(x.dtype)
    h = torch.square(F.relu(xk @ p["ck"].to(x.dtype)))
    out = torch.sigmoid(xr @ p["cr"].to(x.dtype)) * (h @ p["cv"].to(x.dtype))
    return out, x[:, -1]


# ---------------------------------------------------------------------------
# Full RWKV LM
# ---------------------------------------------------------------------------


def init_lm(gen, cfg, device="cuda"):
    """fp32 params with rwkv.init_lm's tree."""
    L, D = cfg.n_layers, cfg.d_model
    return {
        "embed": embed_init(gen, (cfg.padded_vocab, D), device),
        "ln0": _ln_pair(0, D, device),
        "ln1": _ln_pair(L, D, device),
        "ln2": _ln_pair(L, D, device),
        "tm": init_time_mix(gen, cfg, L, device=device),
        "cm": init_channel_mix(gen, cfg, L, device=device),
        "ln_out": _ln_pair(0, D, device),
        "head": dense_init(gen, (D, cfg.padded_vocab), D, device),
    }


def _block_params(params, i: int):
    return layer_params({k: params[k] for k in ("ln1", "ln2", "tm", "cm")}, i)


def forward(params, cfg, tokens, *, opts=None, mode: str = "train",
            dtype=torch.bfloat16, cache=None):
    """tokens (B,S) -> logits (B,S,Vp) (train), or (last-position logits
    (B,Vp), state) (prefill), the state in init_state's layout with tm_x and
    cm_x in the compute dtype.  `opts` and `cache` are accepted for the
    uniform model API and unused: prefill makes the state."""
    x = params["embed"][tokens].to(dtype)
    x = layer_norm(x, params["ln0"]["s"], params["ln0"]["b"])
    states = {"tm_x": [], "S": [], "cm_x": []}
    for i in range(cfg.n_layers):
        lp = _block_params(params, i)
        h = layer_norm(x, lp["ln1"]["s"], lp["ln1"]["b"])
        a, (tm_x, S_fin) = time_mix(lp["tm"], h, cfg)
        x = x + a
        h = layer_norm(x, lp["ln2"]["s"], lp["ln2"]["b"])
        c, cm_x = channel_mix(lp["cm"], h, cfg)
        x = x + c
        if mode == "prefill":
            for key, t in (("tm_x", tm_x), ("S", S_fin), ("cm_x", cm_x)):
                states[key].append(t)
    if mode == "prefill":
        # serving only needs next-token logits; the norm is per position
        x = layer_norm(x[:, -1], params["ln_out"]["s"], params["ln_out"]["b"])
        logits = x @ params["head"].to(x.dtype)
        return logits, {k: torch.stack(v) for k, v in states.items()}
    x = layer_norm(x, params["ln_out"]["s"], params["ln_out"]["b"])
    return x @ params["head"].to(x.dtype)


def init_state(cfg, batch: int, device="cuda"):
    """{"tm_x": (L,B,D), "S": (L,B,H,hd,hd), "cm_x": (L,B,D)}, fp32 zeros."""
    H, hd = dims(cfg)
    L, D = cfg.n_layers, cfg.d_model
    return {"tm_x": zeros_init((L, batch, D), device),
            "S": zeros_init((L, batch, H, hd, hd), device),
            "cm_x": zeros_init((L, batch, D), device)}


def decode_step(params, cfg, tokens, positions, state, *, opts=None,
                dtype=torch.bfloat16):
    """tokens (B,) -> (logits (B,Vp), new state).  RWKV needs no positions
    (kept for API uniformity)."""
    x = params["embed"][tokens][:, None].to(dtype)
    x = layer_norm(x, params["ln0"]["s"], params["ln0"]["b"])
    new = {"tm_x": [], "S": [], "cm_x": []}
    for i in range(cfg.n_layers):
        lp = _block_params(params, i)
        h = layer_norm(x, lp["ln1"]["s"], lp["ln1"]["b"])
        a, (tm_x, S1) = time_mix_decode(lp["tm"], h, cfg,
                                        (state["tm_x"][i], state["S"][i]))
        x = x + a
        h = layer_norm(x, lp["ln2"]["s"], lp["ln2"]["b"])
        c, cm_x = channel_mix(lp["cm"], h, cfg, state=state["cm_x"][i])
        x = x + c
        for key, t in (("tm_x", tm_x), ("S", S1), ("cm_x", cm_x)):
            new[key].append(t)
    x = layer_norm(x, params["ln_out"]["s"], params["ln_out"]["b"])
    logits = (x @ params["head"].to(x.dtype))[:, 0]
    return logits, {k: torch.stack(v) for k, v in new.items()}
