"""Shared building blocks: init helpers, norms, activations, softcap, the
loss, the cotangent cast at the attention boundary, and sharding hints.

Parameters are plain nested dicts of tensors.  Layer-stacked parameters carry
a leading ``(L, ...)`` dim, as in the JAX package, and the model loops over it.
"""
from __future__ import annotations

import contextlib
import functools
import math
import threading
from typing import Optional

import torch
import torch.nn.functional as F
import torch.utils.checkpoint as ckpt

# ---------------------------------------------------------------------------
# Ambient mesh for sharding hints (no-op when absent or on a plain tensor)
# ---------------------------------------------------------------------------

_STATE = threading.local()


def current_mesh():
    return getattr(_STATE, "mesh", None)


def current_rules():
    return getattr(_STATE, "rules", None)


@contextlib.contextmanager
def mesh_context(mesh, rules=None):
    """Install an ambient `DeviceMesh` (+ logical sharding rules, see
    `runtime.sharding.logical_rules`) for `shard_hint`."""
    prev = (getattr(_STATE, "mesh", None), getattr(_STATE, "rules", None))
    _STATE.mesh, _STATE.rules = mesh, rules
    try:
        yield mesh
    finally:
        _STATE.mesh, _STATE.rules = prev


def shard_hint(x, *logical_axes):
    """Redistribute a DTensor to the placements that the logical axis
    names ("batch", "model_ff", "vocab", "expert", ...) take under the
    ambient rules: the port's `with_sharding_constraint`.  A dimension
    that the named axes do not divide stays whole (XLA pads an uneven
    shard; DTensor could not reshape one).  Returns `x` itself when no
    mesh is installed or `x` is a plain tensor."""
    mesh = current_mesh()
    if mesh is None or not hasattr(x, "device_mesh"):
        return x
    from repro_torch.placement import placements
    rules = current_rules() or {}
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    spec = []
    for d, a in enumerate(logical_axes):
        e = rules.get(a) if isinstance(a, str) else a
        n = math.prod(sizes[ax] for ax in
                      (e if isinstance(e, tuple) else (e,)) if ax)
        spec.append(e if x.shape[d] % n == 0 else None)
    return _Hint.apply(x, mesh, placements(mesh, spec))


class _Hint(torch.autograd.Function):
    """x.redistribute(mesh, placements), whose gradient goes back to x's
    placements as DTensor's own backward sends it, except that a partial
    sum reaching a placement of another partial type (an embedding's
    masked lookup: DTensor cannot convert one into the other) is summed
    first."""

    @staticmethod
    def forward(ctx, x, mesh, placements):
        ctx.mesh, ctx.src = mesh, tuple(x.placements)
        return x.redistribute(mesh, placements)

    @staticmethod
    def backward(ctx, g):
        from torch.distributed.tensor import Replicate
        want = tuple(
            s if not s.is_partial() or (type(p) is type(s) and p == s)
            else Replicate() for s, p in zip(ctx.src, g.placements))
        return g.redistribute(ctx.mesh, want), None, None


def write_at(dst, index: tuple, src):
    """dst[index] = src in place, `index` a tuple of ints and slices of
    step 1 over dst's leading dims.  On a DTensor dst, shard by shard:
    `src` follows dst's split along a dim that `index` takes whole and is
    made whole along the others, and each shard writes the part of `src`
    that falls in it."""
    if not hasattr(dst, "device_mesh"):
        dst[index] = src
        return
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    mesh = dst.device_mesh
    index = tuple(index) + (slice(None),) * (dst.dim() - len(index))
    ranges, src_dim = [], {}
    for d, e in enumerate(index):
        if isinstance(e, slice):
            a, b, step = e.indices(dst.shape[d])
            if step != 1:
                raise ValueError(f"write_at: step {step}")
            src_dim[d] = len(src_dim)
            ranges.append((a, b))
        else:
            ranges.append(e % dst.shape[d])
    whole = {d for d, r in enumerate(ranges) if r == (0, dst.shape[d])}
    want = []
    for p in dst.placements:
        if p.is_partial():
            raise ValueError(f"write_at: dst {dst.placements}")
        want.append(Shard(src_dim[p.dim]) if p.is_shard() and p.dim in whole
                    else Replicate())
    if not hasattr(src, "device_mesh"):
        src = DTensor.from_local(src, mesh, [Replicate()] * mesh.ndim,
                                 run_check=False)
    src_l = src.redistribute(mesh, want).to_local()
    shape, offset = compute_local_shape_and_global_offset(
        dst.shape, mesh, dst.placements)
    di, si = [], []
    for d, r in enumerate(ranges):
        lo, hi = offset[d], offset[d] + shape[d]
        if d in whole:
            di.append(slice(None))
            si.append(slice(None))
        elif isinstance(r, int):
            if not lo <= r < hi:
                return                      # not in this shard
            di.append(r - lo)
        else:
            a, b = max(r[0], lo), min(r[1], hi)
            if a >= b:
                return
            di.append(slice(a - lo, b - lo))
            si.append(slice(a - r[0], b - r[0]))
    dst.to_local()[tuple(di)] = src_l[tuple(si)]


def zero_pad(x, pad):
    """F.pad(x, pad) with zeros.  On a DTensor each shard is padded on its
    own (DTensor's own rule for the pad raises an IndexError in its
    redistribution on torch 2.11), so a padded dim must not be split."""
    if not hasattr(x, "device_mesh"):
        return F.pad(x, pad)
    from torch.distributed.tensor import DTensor
    shape = list(x.shape)
    for i, n in enumerate(pad):
        shape[-1 - i // 2] += n
    padded = {x.dim() - 1 - i // 2 for i, n in enumerate(pad) if n}
    if any(p.is_shard() and p.dim in padded for p in x.placements):
        raise ValueError(f"zero_pad: {pad} on a dim split by {x.placements}")
    return DTensor.from_local(
        F.pad(x.to_local(), pad), x.device_mesh, x.placements,
        run_check=False, shape=torch.Size(shape),
        stride=torch.empty(shape, device="meta").stride())


def write_rows(cache, new, positions):
    """cache[b, positions[b]] = new[b] for every row b, in place: a decode
    step's entry (new (B, ...)) into a cache (B, T, ...).  On a DTensor
    cache, shard by shard with no communication: `new` and `positions`
    follow the cache's batch split, and a shard of the sequence writes the
    rows whose position falls in it (the others write back what they
    read)."""
    if not hasattr(cache, "device_mesh"):
        rows = torch.arange(cache.shape[0], device=cache.device)
        cache[rows, positions] = new.to(cache.dtype)
        return
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    mesh = cache.device_mesh
    follow = tuple(Shard(0) if p == Shard(0) else Replicate()
                   for p in cache.placements)
    if any(p.is_shard() and p.dim > 1 for p in cache.placements):
        raise ValueError(f"write_rows: cache {cache.placements}")
    new_l = new.redistribute(mesh, follow).to_local().to(cache.dtype)
    pos_l = (positions.redistribute(mesh, follow).to_local()
             if hasattr(positions, "device_mesh") else positions)
    cache_l = cache.to_local()
    _, offset = compute_local_shape_and_global_offset(
        cache.shape, mesh, cache.placements)
    idx = pos_l - offset[1]
    inside = (idx >= 0) & (idx < cache_l.shape[1])
    idx = idx.clamp(0, cache_l.shape[1] - 1)
    rows = torch.arange(cache_l.shape[0], device=cache_l.device)
    keep = inside.reshape((-1,) + (1,) * (new_l.dim() - 1))
    cache_l[rows, idx] = torch.where(keep, new_l, cache_l[rows, idx])


# ---------------------------------------------------------------------------
# Initializers (fp32 params, as the JAX package keeps them)
# ---------------------------------------------------------------------------

_TRUNC_LO = math.erf(-2.0 / math.sqrt(2.0))   # 2*Phi(-2) - 1
_on_draw = None        # see `on_draw`


@contextlib.contextmanager
def on_draw(fn):
    """Within: dense_init and embed_init ask fn(shape, device), once a leaf
    and in draw order, for the empty leaf to fill (by default fp32), so a
    caller can keep each matrix in another dtype, cast as it is drawn."""
    global _on_draw
    prev, _on_draw = _on_draw, fn
    try:
        yield
    finally:
        _on_draw = prev


def _fill(leaf, draw):
    """Fills `leaf` a matrix (its last two dims) at a time, each drawn in
    fp32 by draw(t), in place, and cast into the leaf if it is not fp32: a
    stacked (L, ...) leaf is never drawn whole in fp32, so the init's peak
    is its tree plus one fp32 matrix."""
    if leaf.dim() > 2:
        for m in leaf.unbind(0):
            _fill(m, draw)
    elif leaf.dtype == torch.float32:
        draw(leaf)
    else:
        leaf.copy_(draw(torch.empty(leaf.shape, device=leaf.device,
                                     dtype=torch.float32)))


def _leaf(shape, device, draw):
    leaf = (torch.empty(shape, device=device, dtype=torch.float32)
            if _on_draw is None
            else _on_draw(tuple(shape), device))
    _fill(leaf, draw)
    return leaf


def dense_init(gen: torch.Generator, shape, in_axis_size: Optional[int] = None,
               device="cuda"):
    """Truncated-normal (+-2 sigma) fan-in init. `shape` may include a leading
    stack dim — pass `in_axis_size` explicitly for stacked weights."""
    fan_in = in_axis_size if in_axis_size is not None else shape[-2]

    def draw(t):
        # inverse-CDF sampling of a normal truncated to [-2, 2]
        t.uniform_(_TRUNC_LO, -_TRUNC_LO, generator=gen)
        t.erfinv_().mul_(math.sqrt(2.0)).clamp_(-2.0, 2.0)
        return t.mul_(1.0 / math.sqrt(fan_in))

    return _leaf(shape, device, draw)


def embed_init(gen: torch.Generator, shape, device="cuda"):
    return _leaf(shape, device,
                 lambda t: t.normal_(0.0, 0.02, generator=gen))


def zeros_init(shape, device="cuda", dtype=torch.float32):
    return torch.zeros(shape, device=device, dtype=dtype)


def ones_init(shape, device="cuda", dtype=torch.float32):
    return torch.ones(shape, device=device, dtype=dtype)


def layer_params(tree, i: int):
    """Layer i of a stacked param tree."""
    if isinstance(tree, dict):
        return {k: layer_params(v, i) for k, v in tree.items()}
    return tree[i]


def unstack(tree, n: int) -> list:
    """The n layers of a stacked param tree, as a list of trees of views.

    One `unbind` per leaf: its backward stacks the n layer gradients once,
    where indexing each layer (`layer_params`) would add a zero-filled
    full-size gradient per layer."""
    if isinstance(tree, dict):
        per_key = {k: unstack(v, n) for k, v in tree.items()}
        return [{k: v[i] for k, v in per_key.items()} for i in range(n)]
    if tree.shape[0] != n:
        raise ValueError(f"stacked dim {tree.shape[0]} is not {n}")
    return list(tree.unbind(0))


def tree_leaves(tree) -> list:
    """Leaves of a param tree of dicts and tuples (a MoE model's "first"
    layers), in insertion order."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_map(fn, tree, *rest):
    """fn over the leaves of a param tree of dicts and tuples (and of
    same-shaped trees `rest`)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, *xs) for xs in zip(tree, *rest))
    return fn(tree, *rest)


def param_count(params) -> int:
    return sum(x.numel() for x in tree_leaves(params))


# ---------------------------------------------------------------------------
# Norms & activations (computed in fp32, cast back)
# ---------------------------------------------------------------------------


def rms_norm(x, scale, eps: float = 1e-6, *, plus_one: bool = False):
    dtype = x.dtype
    x = x.float()
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    y = x * torch.rsqrt(var + eps)
    s = scale.float()
    if plus_one:            # gemma-style (1 + scale)
        s = 1.0 + s
    return (y * s).to(dtype)


def layer_norm(x, scale, bias, eps: float = 1e-5):
    dtype = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mu), dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(dtype)


def activation(name: str):
    return {
        "silu": F.silu,
        "gelu": lambda x: F.gelu(x, approximate="tanh"),
        "relu": F.relu,
        "relu2": lambda x: torch.square(F.relu(x)),
    }[name]


def softcap(x, cap: float):
    """Logit soft-capping: cap * tanh(x / cap) (Gemma2)."""
    if not cap:
        return x
    return cap * torch.tanh(x / cap)


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------


def softmax_xent(logits, labels, vocab_size: int, z_loss: float = 1e-4):
    """Cross-entropy with optional z-loss; logits in fp32.  labels == -1 are
    masked out.  `vocab_size` masks the padded vocab columns.  On a logits
    DTensor split over the vocab, the log-sum-exp's max and sum and the
    gold logit (a masked sum) reduce across the shards, where `logsumexp`
    and `gather` would gather the logits."""
    logits = logits.float()
    if vocab_size < logits.shape[-1]:
        vmask = torch.arange(logits.shape[-1], device=logits.device) \
            < vocab_size
        logits = torch.where(vmask, logits, -1e9)
    valid = labels >= 0
    labels = torch.where(valid, labels, 0).long()
    if hasattr(logits, "device_mesh"):
        m = logits.amax(dim=-1).detach()
        lse = torch.log(torch.exp(logits - m[..., None]).sum(-1)) + m
        col = torch.arange(logits.shape[-1], device=logits.device)
        gold = torch.where(col == labels[..., None], logits, 0.0).sum(-1)
    else:
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, labels[..., None])[..., 0]
    nll = lse - gold
    if z_loss:
        nll = nll + z_loss * torch.square(lse)
    nll = torch.where(valid, nll, 0.0)
    denom = torch.clamp(valid.sum(), min=1)
    return nll.sum() / denom


class _GradCast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.dtype = x.dtype
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.to(ctx.dtype)


def grad_cast(x):
    """Identity whose cotangent is cast to the primal's dtype: the
    mixed-precision boundary guard the JAX model puts on q, k, v and the
    attention context, so fp32 attention internals hand bf16 cotangents to
    the projections.  Outside autograd it returns `x` itself."""
    if not (torch.is_grad_enabled() and x.requires_grad):
        return x
    return _GradCast.apply(x)


class Options:
    """Runtime knobs threaded through model apply.

    q_block / kv_block size the blocks of the plain blockwise attention, the
    path tensors on the CPU take; the CUDA kernel tiles on its own.  remat
    is `maybe_remat`'s policy for the transformer's training blocks.
    mla_absorb picks MLA decode's absorbed branch (attention against the
    compressed cache); moe_group is the MoE's largest token group.
    probs_bf16 rounds the attention probabilities to V's dtype before
    P.V, in the kernel and the plain version alike (`launch.serve` and
    `launch.train` take it as --probs-bf16)."""

    def __init__(self, *, q_block: int = 1024, kv_block: int = 1024,
                 remat: str = "none", mla_absorb: bool = False,
                 moe_group: int = 1024, probs_bf16: bool = False):
        self.q_block = q_block
        self.kv_block = kv_block
        self.remat = remat
        self.mla_absorb = mla_absorb
        self.moe_group = moe_group
        self.probs_bf16 = probs_bf16

    def replace(self, **kw):
        cur = dict(q_block=self.q_block, kv_block=self.kv_block,
                   remat=self.remat, mla_absorb=self.mla_absorb,
                   moe_group=self.moe_group, probs_bf16=self.probs_bf16)
        cur.update(kw)
        return Options(**cur)


# the matmuls whose outputs "dots" keeps, as JAX's checkpoint_dots keeps
# its dot_generals' outputs
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
         torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return (ckpt.CheckpointPolicy.MUST_SAVE if op in _DOTS
            else ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


def maybe_remat(fn, remat: str):
    """fn, or fn under activation checkpointing, as the JAX package's
    `maybe_remat`: "none" keeps every activation; "full" keeps only the
    inputs and reruns fn in the backward; "dots" keeps the matmul outputs
    and reruns the rest.  A kernel op is not an aten matmul, so "dots"
    reruns it, and its launch count counts the rerun too."""
    if remat == "none":
        return fn
    if remat == "full":
        return functools.partial(ckpt.checkpoint, fn, use_reentrant=False)
    if remat == "dots":
        return functools.partial(
            ckpt.checkpoint, fn, use_reentrant=False,
            context_fn=functools.partial(
                ckpt.create_selective_checkpoint_contexts, _save_dots))
    raise ValueError(f"remat {remat!r}: want none, dots or full")
