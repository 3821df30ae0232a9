"""Serving steps: prefill (fill the cache, emit first-token logits) and
decode (one token per sequence against the cache).  Sampling is greedy
argmax over the real vocabulary, for determinism.

Unlike the JAX version, which returns new caches, prefill writes its K/V
straight into the preallocated `cache_len` cache and each decode step writes
its token's K/V in place at the row's position."""
from __future__ import annotations

import time

import torch

# param keys that stay fp32: rms_norm upcasts them anyway
_NORM_KEYS = ("ln1", "ln2", "pn1", "pn2", "final_norm")


def serving_params(params, dtype=torch.bfloat16):
    """Cast the matrices to `dtype` once at load; norm scales stay fp32.

    The model casts every matrix to the compute dtype at use, so for a model
    served in that dtype this is exact, and each decode step reads half the
    bytes."""
    return {k: (v if k in _NORM_KEYS else
                serving_params(v, dtype) if isinstance(v, dict) else
                v.to(dtype))
            for k, v in params.items()}


def make_prefill_step(model):
    cfg = model.cfg

    def prefill_step(params, batch, cache=None):
        logits, cache = model.forward(params, batch, mode="prefill",
                                      cache=cache)
        next_tok = torch.argmax(logits[..., :cfg.vocab_size], dim=-1)
        return next_tok, cache

    return prefill_step


def make_decode_step(model):
    cfg = model.cfg

    def serve_step(params, tokens, positions, cache):
        logits, cache = model.decode_step(params, tokens, positions, cache)
        next_tok = torch.argmax(logits[..., :cfg.vocab_size], dim=-1)
        return next_tok, cache

    return serve_step


def _now(device) -> float:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()


@torch.inference_mode()
def greedy_generate(model, params, batch, max_new: int, cache_len: int,
                    timings: dict = None):
    """Prefill then greedy-decode: returns (B, max_new) int64 tokens.

    If `timings` is a dict, it receives "prefill_s" and "decode_s" (the
    device synchronised at each boundary)."""
    if model.cfg.family in ("ssm", "hybrid"):
        raise NotImplementedError(
            f"family {model.cfg.family!r}: recurrent serving is not ported")
    tokens = batch["tokens"]
    B, S = tokens.shape
    dev = tokens.device
    prefill, decode = make_prefill_step(model), make_decode_step(model)
    t0 = _now(dev) if timings is not None else 0.0
    cache = model.init_cache(B, cache_len, device=dev)
    tok, cache = prefill(params, batch, cache)
    t1 = _now(dev) if timings is not None else 0.0
    out = [tok]
    for t in range(S, S + max_new - 1):
        pos = torch.full((B,), t, dtype=torch.long, device=dev)
        tok, cache = decode(params, tok, pos, cache)
        out.append(tok)
    if timings is not None:
        timings["prefill_s"] = t1 - t0
        timings["decode_s"] = _now(dev) - t1
    return torch.stack(out, dim=1)
