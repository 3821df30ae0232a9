"""Shared building blocks: init helpers, norms, activations, softcap, the
loss, and the cotangent cast at the attention boundary.

Parameters are plain nested dicts of tensors.  Layer-stacked parameters carry
a leading ``(L, ...)`` dim, as in the JAX package, and the model loops over it.
"""
from __future__ import annotations

import contextlib
import functools
import math
from typing import Optional

import torch
import torch.nn.functional as F
import torch.utils.checkpoint as ckpt

# ---------------------------------------------------------------------------
# Initializers (fp32 params, as the JAX package keeps them)
# ---------------------------------------------------------------------------

_TRUNC_LO = math.erf(-2.0 / math.sqrt(2.0))   # 2*Phi(-2) - 1
_on_draw = None        # see `on_draw`


@contextlib.contextmanager
def on_draw(fn):
    """Within: each tensor that dense_init and embed_init draw is passed,
    in draw order, through fn, which returns the tensor to keep (so a
    caller can cast each matrix as soon as it is drawn)."""
    global _on_draw
    prev, _on_draw = _on_draw, fn
    try:
        yield
    finally:
        _on_draw = prev


def _drawn(t):
    return t if _on_draw is None else _on_draw(t)


def dense_init(gen: torch.Generator, shape, in_axis_size: Optional[int] = None,
               device="cuda", dtype=torch.float32):
    """Truncated-normal (+-2 sigma) fan-in init. `shape` may include a leading
    stack dim — pass `in_axis_size` explicitly for stacked weights."""
    fan_in = in_axis_size if in_axis_size is not None else shape[-2]
    t = torch.empty(shape, device=device, dtype=torch.float32)
    # inverse-CDF sampling of a normal truncated to [-2, 2]
    t.uniform_(_TRUNC_LO, -_TRUNC_LO, generator=gen)
    t.erfinv_().mul_(math.sqrt(2.0)).clamp_(-2.0, 2.0)
    return _drawn(t.mul_(1.0 / math.sqrt(fan_in)).to(dtype))


def embed_init(gen: torch.Generator, shape, device="cuda", dtype=torch.float32):
    t = torch.empty(shape, device=device, dtype=torch.float32)
    return _drawn(t.normal_(0.0, 0.02, generator=gen).to(dtype))


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
    """Leaves of a nested dict tree (a param tree), in insertion order."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    return [tree]


def tree_map(fn, tree, *rest):
    """fn over the leaves of a nested dict tree (and of same-shaped trees
    `rest`)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
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
    masked out.  `vocab_size` masks the padded vocab columns."""
    logits = logits.float()
    if vocab_size < logits.shape[-1]:
        vmask = torch.arange(logits.shape[-1], device=logits.device) \
            < vocab_size
        logits = torch.where(vmask, logits, -1e9)
    valid = labels >= 0
    labels = torch.where(valid, labels, 0).long()
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
    compressed cache); moe_group is the MoE's largest token group."""

    def __init__(self, *, q_block: int = 1024, kv_block: int = 1024,
                 remat: str = "none", mla_absorb: bool = False,
                 moe_group: int = 1024):
        self.q_block = q_block
        self.kv_block = kv_block
        self.remat = remat
        self.mla_absorb = mla_absorb
        self.moe_group = moe_group

    def replace(self, **kw):
        cur = dict(q_block=self.q_block, kv_block=self.kv_block,
                   remat=self.remat, mla_absorb=self.mla_absorb,
                   moe_group=self.moe_group)
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
