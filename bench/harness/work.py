"""The yardstick: the card's published peaks, the least time a kernel call
could take, and the model FLOPs of a served batch, counted from the
configuration's shapes alone (the same count whatever implements the work).

Peaks: NVIDIA's H100 SXM data sheet, dense rates: 989 TFLOP/s bf16 on the
tensor cores, 3.35 TB/s of HBM3.  They assume the card's full 700 W; each
run prints its power limit beside them."""
from __future__ import annotations

from bench.harness import cost

PEAK_BF16 = 989e12
HBM_BYTES_S = 3.35e12


def flash_least_s(b, s, h, g, hd, itemsize=2) -> float:
    """Least time of one causal flash call: its FLOPs at the bf16 peak or
    its bytes at the HBM rate, whichever is longer."""
    c = cost.flash_attention(b, s, h, g, hd, itemsize=itemsize)
    return max(c.flops / PEAK_BF16, c.nbytes / HBM_BYTES_S)


def _attn_params(m: dict) -> int:
    hq, hkv = m["n_heads"] * m["head_dim"], m["n_kv_heads"] * m["head_dim"]
    return m["d_model"] * (hq + 2 * hkv) + hq * m["d_model"]


def _mlp_params(m: dict) -> int:
    return 3 * m["d_model"] * m["d_ff"]


def layer_shape(m: dict):
    """(matrix params a token meets outside the output head, attention
    layers) of a dense decoder."""
    if m["family"] != "dense":
        raise ValueError(f"family {m['family']!r}: the count is a dense one")
    per_layer = _attn_params(m) + _mlp_params(m)
    return m["n_layers"] * per_layer, m["n_layers"]


def prefill_flops(m: dict, b: int, s: int) -> float:
    """Model FLOPs of a prefill of b prompts of s tokens: the matrix
    products, causal attention's pairs (as `cost.flash_attention` counts
    them), and the head at the last position."""
    params, attn_layers = layer_shape(m)
    f = 2.0 * params * b * s + 2.0 * m["d_model"] * m["vocab_size"] * b
    f += attn_layers * cost.flash_attention(
        b, s, m["n_heads"], m["n_kv_heads"], m["head_dim"], itemsize=2).flops
    return f


def decode_flops(m: dict, b: int, t: int) -> float:
    """Model FLOPs of one decode step of b sequences whose new token sits
    at position t (t + 1 keys in the cache)."""
    params, attn_layers = layer_shape(m)
    f = b * (2.0 * params + 2.0 * m["d_model"] * m["vocab_size"])
    return f + attn_layers * b * 4.0 * m["n_heads"] * m["head_dim"] * (t + 1)


def serve_flops(m: dict, b: int, s: int, new: int) -> float:
    """A served batch: its prefill and its new - 1 decode steps."""
    return prefill_flops(m, b, s) + sum(decode_flops(m, b, t)
                                        for t in range(s, s + new - 1))
