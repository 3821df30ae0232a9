"""Gradient compression for a slow all-reduce leg: int8 block quantization
with error feedback, as the JAX package's `optim/compress.py`.

Each tensor is cut into blocks of BLOCK values (the last zero-padded); a
block keeps its largest |value| / 127 as an fp32 scale and its values as
int8, rounded half to even (`torch.round`, as `jnp.round`).  Error
feedback keeps what the round trip lost and adds it to the next step's
gradient, which restores convergence to the uncompressed trajectory
(Seide et al.; Karimireddy et al.).  Nothing in the training path calls it
yet, as in the JAX package: it is what a cross-node reduction would send.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.common import tree_map

BLOCK = 256


def quantize_int8(x: torch.Tensor):
    """Per-block symmetric int8 quantization. Returns (q (n, BLOCK) int8,
    scales (n, 1) fp32)."""
    flat = x.reshape(-1)
    pad = (-flat.numel()) % BLOCK
    if pad:
        flat = F.pad(flat, (0, pad))
    blocks = flat.reshape(-1, BLOCK).float()
    scale = blocks.abs().amax(dim=1, keepdim=True) / 127.0
    scale = torch.clamp(scale, min=1e-12)
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q, scale, shape):
    """The fp32 tensor of `shape` that (q, scale) stand for."""
    flat = (q.float() * scale).reshape(-1)
    return flat[:math.prod(shape)].reshape(shape)


def compress_roundtrip(x):
    q, s = quantize_int8(x)
    return dequantize_int8(q, s, tuple(x.shape))


def compressed_grads(grads, error_state):
    """Int8 compression with error feedback over a gradient tree.

    Returns (decompressed grads, each in its gradient's dtype, new error
    state, fp32); error_state None starts from zeros."""
    if error_state is None:
        error_state = tree_map(
            lambda g: torch.zeros_like(g, dtype=torch.float32), grads)
    corrected = tree_map(lambda g, e: g.float() + e, grads, error_state)
    out = tree_map(compress_roundtrip, corrected)
    return (tree_map(lambda o, g: o.to(g.dtype), out, grads),
            tree_map(torch.sub, corrected, out))
