"""Serving steps: prefill (fill the cache, emit first-token logits) and
decode (one token per sequence against the cache).  Sampling is greedy
argmax over the real vocabulary, for determinism.

Unlike the JAX version, which returns new caches, prefill writes its K/V
straight into the preallocated `cache_len` cache and each decode step writes
its token's K/V in place at the row's position.  An ssm model (rwkv6)
prefills with its chunked forward, which returns the recurrent state that
decode then carries.  A hybrid model (zamba2) takes the transformer's
branch: its preallocated cache holds the shared block's K/V and every
Mamba2 layer's SSM state and conv ring, which the chunked prefill fills in
place.  JAX's `greedy_generate` prefills both recurrent families token by
token through `decode_step` instead: the same function up to rounding, but
one that never runs the chunked-WKV or the SSD kernel.  An audio model
(whisper) takes the transformer's branch too: its cache holds the
decoder's K/V and the encoder's memory, which prefill writes in place from
the batch's "encoder_frames"."""
from __future__ import annotations

import itertools
import time

import torch
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode

from repro_torch.core.engine.tracing import span
from repro_torch.models.common import on_draw, shard_hint


class _LeafReads(TorchFunctionMode):
    """Sees every torch call while active.  For each param leaf, and each view
    indexed or unbound out of one (a layer) and the rows an embedding
    lookup takes from one, it records whether a call reads it through a
    cast to `dtype` or some other way."""

    def __init__(self, leaves: dict, dtype):
        super().__init__()
        self.path = {id(t): p for p, t in leaves.items()}
        self.keep = list(leaves.values())    # tracked ids stay unique
        self.dtype = dtype
        self.cast, self.other = set(), set()

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        read = {self.path[id(a)] for a in (*args, *kwargs.values())
                if isinstance(a, torch.Tensor) and id(a) in self.path}
        if read and func in (torch.Tensor.unbind, torch.unbind):
            for t in out:                        # the layers of a stack
                self.path[id(t)] = self.path[id(args[0])]
                self.keep.append(t)
        elif read and isinstance(out, torch.Tensor):
            rows_of = (args[0] if func is torch.Tensor.__getitem__
                       else args[1] if func is F.embedding else None)
            if rows_of is not None and id(rows_of) in self.path:
                self.path[id(out)] = self.path[id(rows_of)]
                self.keep.append(out)
            elif func is torch.Tensor.to and out.dtype == self.dtype:
                self.cast |= read
            else:
                self.other |= read
        return out


def _leaves(tree, prefix=()):
    """(path, leaf) of a param tree of dicts and tuples; a tuple's items
    are keyed by their index."""
    items = (tree.items() if isinstance(tree, dict)
             else enumerate(tree) if isinstance(tree, (tuple, list)) else ())
    for k, v in items:
        if isinstance(v, (dict, tuple, list)):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _cast_tree(tree, cast: set, dtype, prefix=()):
    """`tree` with the leaves at the paths in `cast` cast to `dtype`."""
    if isinstance(tree, dict):
        return {k: _cast_tree(v, cast, dtype, prefix + (k,))
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_cast_tree(v, cast, dtype, prefix + (i,))
                          for i, v in enumerate(tree))
    return tree.to(dtype) if prefix in cast else tree


def _cast_only_leaves(model, dtype=torch.bfloat16) -> set:
    """Paths of the param leaves that `model`'s serving path reads only
    through a cast to `dtype`.  Found by serving two tokens through the
    model's reduced config on the CPU and watching every read of every leaf,
    so the answer follows the model code."""
    from repro_torch.models.model import build_model
    tiny = build_model(model.cfg.reduced(), model.opts)
    params = tiny.init(torch.Generator().manual_seed(0), "cpu")
    probe = _LeafReads(dict(_leaves(params)), dtype)
    batch = {"tokens": torch.ones((1, 2), dtype=torch.long)}
    if tiny.cfg.family == "audio":
        batch["encoder_frames"] = torch.zeros(
            (1, tiny.cfg.encoder.n_frames, tiny.cfg.d_model), dtype=dtype)
    with probe:
        greedy_generate(tiny, params, batch, max_new=2, cache_len=4)
    return probe.cast - probe.other


def serving_params(model, params, dtype=torch.bfloat16):
    """Cast to `dtype` once at load every leaf that the model reads only
    through a cast to `dtype` (projection matrices, embeddings, mixing
    vectors); every leaf it reads in its own fp32 keeps it (norm scales and
    biases; rwkv's decay base w0, decay LoRA w2, bonus u and ln_x; the
    Mamba2 layers' A_log, dt_bias and D_skip).

    For a model served in `dtype` this is exact, leaf by leaf: the model
    computes the same values from the cast params, and each decode step reads
    half the bytes of the matrices."""
    return _cast_tree(params, _cast_only_leaves(model, dtype), dtype)


def _draw_paths(model) -> dict:
    """{n: path} of the param leaves that `model.init` draws through
    dense_init / embed_init, n counting the draws in order.  Found by
    running `model.init` on the meta device (no storage)."""
    drawn = []

    def keep(shape, device):
        drawn.append(torch.empty(shape, device=device, dtype=torch.float32))
        return drawn[-1]

    with on_draw(keep):
        params = model.init(torch.Generator().manual_seed(0), "meta")
    at = {id(t): n for n, t in enumerate(drawn)}
    return {at[id(t)]: path for path, t in _leaves(params) if id(t) in at}


def init_serving_params(model, generator, device, dtype=torch.bfloat16):
    """`serving_params(model, model.init(generator, device), dtype)`, bit
    for bit, without the whole fp32 tree: each leaf that the model reads
    only through a cast to `dtype` is made in `dtype`, and `Model.init`
    fills it from `generator` a matrix at a time, each drawn in fp32 and
    cast as it is drawn.  The peak is the served params plus one fp32
    matrix, where `serving_params` of a whole fp32 tree holds both trees
    at once."""
    cast = _cast_only_leaves(model, dtype)
    paths = _draw_paths(model)
    count = itertools.count()

    def finish(shape, device):
        keep = dtype if paths.get(next(count)) in cast else torch.float32
        return torch.empty(shape, device=device, dtype=keep)

    with on_draw(finish):
        params = model.init(generator, device)
    # leaves made otherwise (biases, norm scales) are cast here
    return _cast_tree(params, cast, dtype)


def _greedy(logits, vocab_size: int):
    """The argmax over the real vocabulary; a logits DTensor split over the
    vocab is gathered first (its rows are one token's)."""
    with span("serve_step.sample"):
        logits = shard_hint(logits, "batch", None)
        return torch.argmax(logits[..., :vocab_size], dim=-1)


def make_prefill_step(model):
    cfg = model.cfg

    def prefill_step(params, batch, cache=None):
        logits, cache = model.forward(params, batch, mode="prefill",
                                      cache=cache)
        return _greedy(logits, cfg.vocab_size), cache

    return prefill_step


def make_decode_step(model):
    cfg = model.cfg

    def serve_step(params, tokens, positions, cache):
        logits, cache = model.decode_step(params, tokens, positions, cache)
        return _greedy(logits, cfg.vocab_size), cache

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
    device synchronised at each boundary).  The steps run in the spans
    `serve_step.cache_init`, `serve_step.prefill` and one
    `serve_step.decode` a step (`core.engine.tracing.span`)."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    dev = tokens.device
    prefill, decode = make_prefill_step(model), make_decode_step(model)
    t0 = _now(dev) if timings is not None else 0.0
    # an ssm prefill returns its state; a transformer's or a hybrid's fills
    # this cache
    with span("serve_step.cache_init"):
        cache = (None if model.cfg.family == "ssm"
                 else model.init_cache(B, cache_len, device=dev))
    with span("serve_step.prefill"):
        tok, cache = prefill(params, batch, cache)
    t1 = _now(dev) if timings is not None else 0.0
    out = [tok]
    for t in range(S, S + max_new - 1):
        with span("serve_step.decode"):
            pos = torch.full((B,), t, dtype=torch.long, device=dev)
            tok, cache = decode(params, tok, pos, cache)
        out.append(tok)
    if timings is not None:
        timings["prefill_s"] = t1 - t0
        timings["decode_s"] = _now(dev) - t1
    return torch.stack(out, dim=1)
