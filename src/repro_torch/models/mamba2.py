"""Mamba2 (SSD) block — chunked state-space-dual formulation.

Training and prefill use the chunked algorithm (an intra-chunk
"attention-like" term plus the state carried from chunk to chunk), run by
the `ssd` op: the hand-written CUDA kernel on the card, the plain chunked
version (this file's `_ssd_chunk` over the chunks) on the CPU.
`mamba_forward` takes an initial state and returns the final state as the
JAX layer does (no gradient through either), and with `return_cache` the
conv ring too, for serving.  Decode (`mamba_decode`) is the O(1)-state
recurrence, one token a step, in plain tensor ops.

State per layer: ssm (B, H, hd, N) fp32 + conv ring (B, W-1, convch) of
the last pre-conv inputs (`init_mamba_state`).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.mamba2_ssd import ops as ssd_ops
from repro_torch.models.common import (dense_init, ones_init, rms_norm,
                                       shard_hint, zero_pad, zeros_init)


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


def _softplus(x):
    """F.softplus; on a DTensor, which has no rule for softplus's
    backward, the same function as max(x, 0) + log1p(exp(-|x|))."""
    if hasattr(x, "device_mesh"):
        return torch.clamp(x, min=0) + torch.log1p(torch.exp(-torch.abs(x)))
    return F.softplus(x)


def _split_proj(zxbcdt, cfg):
    d_inner, H, G, N, *_ = dims(cfg)
    z = zxbcdt[..., :d_inner]
    xin = zxbcdt[..., d_inner:2 * d_inner]
    Bc = zxbcdt[..., 2 * d_inner:2 * d_inner + G * N]
    Cc = zxbcdt[..., 2 * d_inner + G * N:2 * d_inner + 2 * G * N]
    dt = zxbcdt[..., 2 * d_inner + 2 * G * N:]
    return z, xin, Bc, Cc, dt


def _conv(xBC, w, b, conv_state=None):
    """Causal depthwise conv, window W, then SiLU.  xBC: (B,S,C); w: (W,C);
    conv_state: (B, W-1, C) ring of the trailing pre-conv inputs, or None
    (zeros).  Returns (silu(out), new ring): the last W-1 rows of the input
    behind the ring, in xBC's dtype."""
    W = w.shape[0]
    if conv_state is not None:
        full = torch.cat([conv_state.to(xBC.dtype), xBC], dim=1)
    else:
        full = zero_pad(xBC, (0, 0, W - 1, 0))
    S = xBC.shape[1]
    out = full[:, 0:S] * w[0].to(xBC.dtype)
    for i in range(1, W):
        out = out + full[:, i:i + S] * w[i].to(xBC.dtype)
    out = out + b.to(xBC.dtype)
    return F.silu(out), full[:, S:]


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


def mamba_forward(p, x, cfg, *, initial_state=None, return_state=False,
                  return_cache=False):
    """x: (B,S,D) -> (B,S,D), or (out, final SSM state (B,H,hd,N) fp32) with
    `return_state`, or (out, {"ssm": that state, "conv": the conv ring
    (B,W-1,convch) in x's dtype}) with `return_cache`; the scan starts from
    initial_state (B,H,hd,N) fp32, or 0, and the conv from zeros.  Chunked
    SSD over the full sequence; S is padded to a multiple of the chunk for
    the scan and cut back after (the padded steps, dA 0 and x 0, leave the
    state as it was at step S)."""
    s = cfg.ssm
    d_inner, H, G, N, W, convch, _ = dims(cfg)
    hd = s.head_dim
    B_, S, D = x.shape
    Q = min(s.chunk, S)
    pad = (-S) % Q
    # On a mesh the fused projection and the conv's output are each
    # gathered once and split locally: a slice of a split dim gathers the
    # whole tensor for each piece.  The conv runs split by channels, so
    # that its backward gathers its input's gradient once, not per piece.
    zxbcdt = shard_hint(x @ p["in_proj"].to(x.dtype), "batch", None, None)
    z, xin, Bc, Cc, dt = _split_proj(zxbcdt, cfg)
    xBC = shard_hint(torch.cat([xin, Bc, Cc], -1), "batch", None, "model_ff")
    xBC, ring = _conv(xBC, p["conv_w"], p["conv_b"])
    xBC = shard_hint(xBC, "batch", None, None)
    xin, Bc, Cc = (xBC[..., :d_inner], xBC[..., d_inner:d_inner + G * N],
                   xBC[..., d_inner + G * N:])
    xin = shard_hint(xin, "batch", None, "model_ff")
    dt = _softplus(dt.float() + p["dt_bias"].float())
    A = -torch.exp(p["A_log"].float())                            # (H,)
    dA = dt * A                                                   # (B,S,H)
    xdt = xin.reshape(B_, S, H, hd).float() * dt[..., None]       # (B,S,H,hd)
    Bh = Bc.reshape(B_, S, G, N).float()
    Ch = Cc.reshape(B_, S, G, N).float()
    if pad:
        dA = zero_pad(dA, (0, 0, 0, pad))
        xdt = zero_pad(xdt, (0, 0, 0, 0, 0, pad))
        Bh = zero_pad(Bh, (0, 0, 0, 0, 0, pad))
        Ch = zero_pad(Ch, (0, 0, 0, 0, 0, pad))
    with_state = return_state or return_cache
    Y = ssd_ops.ssd(xdt, dA, Bh, Ch, chunk=Q, initial_state=initial_state,
                    return_state=with_state)
    if with_state:
        Y, S_fin = Y
    Y = Y[:, :S]
    Y = Y + p["D_skip"].float()[:, None] * xin.reshape(B_, S, H, hd).float()
    y = Y.reshape(B_, S, d_inner).to(x.dtype)
    y = rms_norm(y * F.silu(z), p["norm"], cfg.norm_eps)
    out = shard_hint(y @ p["out_proj"].to(x.dtype), "batch", None, None)
    if return_cache:
        return out, {"ssm": S_fin, "conv": ring}
    return (out, S_fin) if return_state else out


def mamba_decode(p, x, cfg, state):
    """One step.  x: (B,1,D); state {"ssm": (B,H,hd,N) fp32, "conv":
    (B,W-1,convch)} -> (out (B,1,D), new state in that layout, the ring in
    x's dtype)."""
    s = cfg.ssm
    d_inner, H, G, N, W, convch, _ = dims(cfg)
    hd = s.head_dim
    B_ = x.shape[0]
    Hg = H // G
    zxbcdt = x @ p["in_proj"].to(x.dtype)
    z, xin, Bc, Cc, dt = _split_proj(zxbcdt, cfg)
    xBC, ring = _conv(torch.cat([xin, Bc, Cc], -1), p["conv_w"],
                      p["conv_b"], conv_state=state["conv"])
    xin, Bc, Cc = (xBC[..., :d_inner], xBC[..., d_inner:d_inner + G * N],
                   xBC[..., d_inner + G * N:])
    dt = _softplus(dt.float() + p["dt_bias"].float())             # (B,1,H)
    A = -torch.exp(p["A_log"].float())
    dA = torch.exp(dt[:, 0] * A)                                  # (B,H)
    xh = xin.reshape(B_, G, Hg, hd).float()
    xdt = xh * dt[:, 0].reshape(B_, G, Hg)[..., None]
    Bh = Bc.reshape(B_, G, N).float()
    Ch = Cc.reshape(B_, G, N).float()
    # S1 = exp(dt A) S0 + (dt x) (x) B;  Y = C . S1 + D x
    S1 = (state["ssm"].reshape(B_, G, Hg, hd, N)
          * dA.reshape(B_, G, Hg)[..., None, None]
          + torch.einsum("bghd,bgn->bghdn", xdt, Bh))
    Y = torch.einsum("bgn,bghdn->bghd", Ch, S1)
    Y = Y + p["D_skip"].float().reshape(G, Hg)[None, :, :, None] * xh
    y = Y.reshape(B_, 1, d_inner).to(x.dtype)
    y = rms_norm(y * F.silu(z), p["norm"], cfg.norm_eps)
    out = y @ p["out_proj"].to(x.dtype)
    return out, {"ssm": S1.reshape(B_, H, hd, N), "conv": ring}


def init_mamba_state(cfg, batch: int, n_layers: int = 0, *, device="cuda"):
    """{"ssm": ([L,] B, H, hd, N), "conv": ([L,] B, W-1, convch)}, fp32
    zeros."""
    d_inner, H, G, N, W, convch, _ = dims(cfg)
    L = (n_layers,) if n_layers else ()
    return {"ssm": zeros_init(L + (batch, H, cfg.ssm.head_dim, N),
                              device=device),
            "conv": zeros_init(L + (batch, W - 1, convch), device=device)}

