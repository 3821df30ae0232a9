"""A plain PyTorch reference of the benchmark's dense decoder.

Written from the published description of DeepSeek LLM 7B (RMSNorm, rotary
positions by halves, causal multi-head attention, a SiLU-gated MLP), with
what the configuration file lists under `assumed`.

Everything is computed in fp32 with TF32 off, from the weights and tokens
that the benchmark made, a layer at a time so that it fits beside nothing
else on the card.  With `precision="fp8"` every linear layer's operands are
first rounded to float8 e4m3 (one scale per tensor): the control, one step
of precision below the bf16 that the configurations serve in.

This module imports neither the program under test nor JAX: it reads the
weights by the names the benchmark gives them, and works out again what the
program derives from them (the rotary tables)."""
from __future__ import annotations

import contextlib
import math

import torch

FP8_MAX = 448.0          # largest finite float8 e4m3fn


@contextlib.contextmanager
def exact_fp32():
    """fp32 matrix products without TF32, restored on exit."""
    m, c = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    prec = torch.get_float32_matmul_precision()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c
        torch.set_float32_matmul_precision(prec)


def fp8_round(t):
    """t rounded to float8 e4m3 under one scale (the largest magnitude maps
    to the format's largest finite value), in fp32."""
    t = t.float()
    scale = t.abs().amax().clamp(min=1e-30) / FP8_MAX
    return (t / scale).to(torch.float8_e4m3fn).float() * scale


class Linear:
    """x @ w in fp32, or on fp8-rounded operands for the control."""

    def __init__(self, precision: str):
        if precision not in ("fp32", "fp8"):
            raise ValueError(f"precision {precision!r}: want fp32 or fp8")
        self.fp8 = precision == "fp8"

    def __call__(self, x, w):
        w = w.float()
        if self.fp8:
            return fp8_round(x) @ fp8_round(w)
        return x @ w


def rms_norm(x, scale, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale.float()


def rotate(x, theta):
    """Rotary positions 0..T-1 on x (B, T, H, hd), the two halves of each
    head rotated as one pair per frequency."""
    T, hd = x.shape[1], x.shape[-1]
    half = hd // 2
    freq = theta ** (-torch.arange(half, dtype=torch.float64,
                                   device=x.device) / half)
    ang = torch.arange(T, dtype=torch.float64, device=x.device)[:, None] * freq
    cos = torch.cos(ang).float()[None, :, None, :]
    sin = torch.sin(ang).float()[None, :, None, :]
    a, b = x[..., :half], x[..., half:]
    return torch.cat([a * cos - b * sin, b * cos + a * sin], dim=-1)


def causal_attention(q, k, v, q_rows: int = 1024):
    """softmax(q k^T / sqrt(hd)) v over keys at or before each query, exact,
    a block of queries at a time.  q, k, v (B, T, H, hd)."""
    B, T, H, hd = q.shape
    out = torch.empty_like(q)
    kt = k.permute(0, 2, 3, 1)                     # (B,H,hd,T)
    vh = v.transpose(1, 2)                         # (B,H,T,hd)
    for i0 in range(0, T, q_rows):
        i1 = min(i0 + q_rows, T)
        s = q[:, i0:i1].transpose(1, 2) @ kt[..., :i1] / math.sqrt(hd)
        keep = (torch.arange(i1, device=q.device)[None, :]
                <= torch.arange(i0, i1, device=q.device)[:, None])
        s = s.masked_fill(~keep, float("-inf"))
        out[:, i0:i1] = (torch.softmax(s, -1) @ vh[:, :, :i1]).transpose(1, 2)
    return out


def attention(p, h, cfg, lin):
    """Multi-head attention of the normed input h (B, T, d_in)."""
    B, T, _ = h.shape
    H, hd = cfg["n_heads"], cfg["head_dim"]
    if cfg["n_kv_heads"] != H:
        raise ValueError("the reference takes multi-head attention only")
    # the weights' query heads may be padded per group (the layout a
    # 16-wide model axis takes); the real ones are the first of each group
    per_group = p["wq"].shape[-1] // (hd * H)
    real = (torch.arange(H, device=h.device) * per_group)[:, None] * hd \
        + torch.arange(hd, device=h.device)
    real = real.reshape(-1)
    wq, wo = p["wq"][..., real], p["wo"][real]
    q = rotate(lin(h, wq).view(B, T, H, hd), cfg["rope_theta"])
    k = rotate(lin(h, p["wk"]).view(B, T, H, hd), cfg["rope_theta"])
    v = lin(h, p["wv"]).view(B, T, H, hd)
    return lin(causal_attention(q, k, v).reshape(B, T, H * hd), wo)


def mlp(p, h, cfg, lin):
    if cfg["act"] != "silu":
        raise ValueError(f"activation {cfg['act']!r}: the reference's is silu")
    g = lin(h, p["w1"])
    return lin(g * torch.sigmoid(g) * lin(h, p["w3"]), p["w2"])


def layer(tree, i):
    """Layer i of a tree whose leaves are stacked on a leading dim."""
    if isinstance(tree, dict):
        return {k: layer(v, i) for k, v in tree.items()}
    return tree[i]


# ---------------------------------------------------------------------------
# Whole models: logits at chosen positions
# ---------------------------------------------------------------------------


def _hidden(params, cfg, tokens, lin):
    eps = cfg["norm_eps"]

    def block(x, bp):
        x = x + attention(bp["attn"], rms_norm(x, bp["ln1"], eps), cfg, lin)
        return x + mlp(bp["mlp"], rms_norm(x, bp["ln2"], eps), cfg, lin)

    x = params["embed"].float()[tokens]
    for i in range(cfg["n_layers"]):
        x = block(x, layer(params["blocks"], i))
    return x


def logits_at(params, cfg, tokens, positions, precision: str = "fp32"):
    """Logits (B, len(positions), vocab_size) of the real vocabulary at the
    given positions of tokens (B, T), the whole sequence run causally."""
    lin = Linear(precision)
    with exact_fp32(), torch.no_grad():
        x = _hidden(params, cfg, tokens.long(), lin)
        x = rms_norm(x[:, positions], params["final_norm"], cfg["norm_eps"])
        return lin(x, params["head"])[..., :cfg["vocab_size"]]
