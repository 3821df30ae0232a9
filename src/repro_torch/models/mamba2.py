"""Mamba2 (SSD) block — chunked state-space-dual formulation.

Training uses the chunked algorithm (an intra-chunk "attention-like" term
plus the state carried from chunk to chunk), run by the `ssd` op: the
hand-written CUDA kernel on the card, the plain chunked version (this
file's `_ssd_chunk` over the chunks) on the CPU.  Decode and the recurrent
state wait for the zamba2 serving slice.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.mamba2_ssd import ops as ssd_ops
from repro_torch.models.common import (dense_init, ones_init, rms_norm,
                                       zeros_init)


def dims(cfg):
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    H = d_inner // s.head_dim
    G, N, W = s.n_groups, s.state_dim, s.conv_dim
    convch = d_inner + 2 * G * N
    d_in_proj = 2 * d_inner + 2 * G * N + H
    return d_inner, H, G, N, W, convch, d_in_proj


def init_mamba(gen, cfg, n_layers: int, *, device="cuda"):
    d_inner, H, G, N, W, convch, d_in_proj = dims(cfg)
    D = cfg.d_model
    L = (n_layers,) if n_layers else ()
    # A in [1, 16): A_log = log of evenly spaced values (mamba2 default)
    a0 = torch.log(torch.linspace(1.0, 16.0, H, dtype=torch.float32,
                                  device=device))
    return {
        "in_proj": dense_init(gen, L + (D, d_in_proj), D, device),
        "conv_w": dense_init(gen, L + (W, convch), W, device),
        "conv_b": zeros_init(L + (convch,), device=device),
        "A_log": a0.expand(L + (H,)).clone(),
        "dt_bias": zeros_init(L + (H,), device=device),
        "D_skip": ones_init(L + (H,), device=device),
        "norm": ones_init(L + (d_inner,), device=device),
        "out_proj": dense_init(gen, L + (d_inner, D), d_inner, device),
    }


def _split_proj(zxbcdt, cfg):
    d_inner, H, G, N, *_ = dims(cfg)
    z = zxbcdt[..., :d_inner]
    xin = zxbcdt[..., d_inner:2 * d_inner]
    Bc = zxbcdt[..., 2 * d_inner:2 * d_inner + G * N]
    Cc = zxbcdt[..., 2 * d_inner + G * N:2 * d_inner + 2 * G * N]
    dt = zxbcdt[..., 2 * d_inner + 2 * G * N:]
    return z, xin, Bc, Cc, dt


def _conv(xBC, w, b):
    """Causal depthwise conv, window W, then SiLU.  xBC: (B,S,C); w: (W,C)."""
    W = w.shape[0]
    full = F.pad(xBC, (0, 0, W - 1, 0))
    S = xBC.shape[1]
    out = full[:, 0:S] * w[0].to(xBC.dtype)
    for i in range(1, W):
        out = out + full[:, i:i + S] * w[i].to(xBC.dtype)
    out = out + b.to(xBC.dtype)
    return F.silu(out)


def _ssd_chunk(S0, blk, *, H, G, N, hd):
    """One chunk of the SSD recurrence.  S0 (B,H,hd,N); blk = (cum (B,Q,H),
    Bh/Ch (B,Q,G,N), xdt (B,Q,H,hd)).  Returns (S1, Y (B,Q,H,hd))."""
    cum, Bh, Ch, xdt = blk
    Hg = H // G
    B_, Q = cum.shape[0], cum.shape[1]
    cum_g = cum.reshape(B_, Q, G, Hg)
    xdt_g = xdt.reshape(B_, Q, G, Hg, hd)
    # intra-chunk: Y[i] += sum_{j<=i} exp(cum_i-cum_j) (C_i.B_j) xdt_j
    # (mask INSIDE the exponent: upper-triangle deltas are positive and
    # would overflow exp, poisoning gradients via inf*0)
    scores = torch.einsum("bign,bjgn->bijg", Ch, Bh)              # (B,Q,Q,G)
    mask = torch.ones((Q, Q), dtype=torch.bool, device=cum.device).tril()
    delta = cum_g[:, :, None] - cum_g[:, None, :, :]              # (B,Q,Q,G,Hg)
    Ldec = torch.exp(torch.where(mask[None, :, :, None, None], delta, -1e9))
    M = Ldec * scores[..., None]
    Y = torch.einsum("bijgh,bjghd->bighd", M, xdt_g)              # (B,Q,G,Hg,hd)
    # inter-chunk: Y[i] += exp(cum_i) C_i . S0
    S0_g = S0.reshape(B_, G, Hg, hd, N)
    Yin = torch.einsum("bign,bghdn->bighd", Ch, S0_g) \
        * torch.exp(cum_g)[..., None]
    Y = Y + Yin
    # state update: S1 = exp(cum_Q) S0 + sum_j exp(cum_Q - cum_j) xdt_j B_j
    dec_end = torch.exp(cum_g[:, -1:, :, :] - cum_g)              # (B,Q,G,Hg)
    Supd = torch.einsum("bjgh,bjghd,bjgn->bghdn", dec_end, xdt_g, Bh)
    S1 = S0_g * torch.exp(cum_g[:, -1])[..., None, None] + Supd
    return S1.reshape(B_, H, hd, N), Y.reshape(B_, Q, H, hd)


def mamba_forward(p, x, cfg):
    """x: (B,S,D) -> (B,S,D).  Chunked SSD over the full sequence; S is
    padded to a multiple of the chunk for the scan and cut back after."""
    s = cfg.ssm
    d_inner, H, G, N, W, convch, _ = dims(cfg)
    hd = s.head_dim
    B_, S, D = x.shape
    Q = min(s.chunk, S)
    pad = (-S) % Q
    zxbcdt = x @ p["in_proj"].to(x.dtype)
    z, xin, Bc, Cc, dt = _split_proj(zxbcdt, cfg)
    xBC = _conv(torch.cat([xin, Bc, Cc], -1), p["conv_w"], p["conv_b"])
    xin, Bc, Cc = (xBC[..., :d_inner], xBC[..., d_inner:d_inner + G * N],
                   xBC[..., d_inner + G * N:])
    dt = F.softplus(dt.float() + p["dt_bias"].float())
    A = -torch.exp(p["A_log"].float())                            # (H,)
    dA = dt * A                                                   # (B,S,H)
    xdt = xin.reshape(B_, S, H, hd).float() * dt[..., None]       # (B,S,H,hd)
    Bh = Bc.reshape(B_, S, G, N).float()
    Ch = Cc.reshape(B_, S, G, N).float()
    if pad:
        dA = F.pad(dA, (0, 0, 0, pad))
        xdt = F.pad(xdt, (0, 0, 0, 0, 0, pad))
        Bh = F.pad(Bh, (0, 0, 0, 0, 0, pad))
        Ch = F.pad(Ch, (0, 0, 0, 0, 0, pad))
    Y = ssd_ops.ssd(xdt, dA, Bh, Ch, chunk=Q)[:, :S]
    Y = Y + p["D_skip"].float()[:, None] * xin.reshape(B_, S, H, hd).float()
    y = Y.reshape(B_, S, d_inner).to(x.dtype)
    y = rms_norm(y * F.silu(z), p["norm"], cfg.norm_eps)
    return y @ p["out_proj"].to(x.dtype)

