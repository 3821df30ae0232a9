"""Rotary position embeddings (half-split convention): standard RoPE and
Qwen2-VL's M-RoPE."""
from __future__ import annotations

import torch


def rope_angles(positions, head_dim: int, theta: float):
    """positions (..., S) int -> (sin, cos) of shape (..., S, head_dim//2)."""
    half = head_dim // 2
    exponent = torch.arange(half, dtype=torch.float32,
                            device=positions.device) / half
    inv_freq = 1.0 / (theta ** exponent)
    ang = positions.float()[..., None] * inv_freq
    return torch.sin(ang), torch.cos(ang)


def mrope_angles(mpositions, sections, head_dim: int, theta: float):
    """Multimodal RoPE (Qwen2-VL).

    mpositions: (3, B, S) temporal / height / width position streams.
    sections: each stream's rotary half-dims, summing to head_dim//2.
    Returns (sin, cos) of shape (B, S, head_dim//2)."""
    half = head_dim // 2
    if sum(sections) != half:
        raise ValueError(f"mrope sections {sections} do not sum to {half}")
    exponent = torch.arange(half, dtype=torch.float32,
                            device=mpositions.device) / half
    inv_freq = 1.0 / (theta ** exponent)
    stream = torch.repeat_interleave(
        torch.arange(len(sections), device=mpositions.device),
        torch.tensor(sections, device=mpositions.device),
        output_size=sum(sections))                             # (half,)
    pos = mpositions[stream].movedim(0, -1).float()            # (B, S, half)
    ang = pos * inv_freq
    return torch.sin(ang), torch.cos(ang)


def apply_rope(x, sin, cos):
    """x: (..., S, H, hd); sin/cos: (..., S, hd//2) broadcast over heads.
    Half-split (llama) convention."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    s, c = sin[..., None, :], cos[..., None, :]
    out = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
    return out.to(x.dtype)
