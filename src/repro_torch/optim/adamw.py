"""AdamW from scratch: global-norm clipping, decoupled weight decay,
warmup + cosine schedule, optional reduced-precision moments.

The JAX version is pure and returns new trees.  This one updates params and
moments in place and returns the same trees: at zamba2-2.7b's width the
fp32 params, gradients and two moments already take 40 GB of the card, and
fresh copies of them would not fit beside.  Each leaf is updated a slice of
at most `SLICE` elements at a time, so the scratch stays small beside them.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.models.common import tree_leaves, tree_map

SLICE = 1 << 24


class OptState(NamedTuple):
    count: torch.Tensor       # () int32
    m: dict
    v: dict


def init_opt(params, rc) -> OptState:
    dt = getattr(torch, rc.adam_state_dtype)
    leaves = tree_leaves(params)
    zeros = lambda x: torch.zeros(x.shape, dtype=dt, device=x.device)  # noqa: E731
    return OptState(
        count=torch.zeros((), dtype=torch.int32, device=leaves[0].device),
        m=tree_map(zeros, params), v=tree_map(zeros, params))


def lr_schedule(step, rc):
    """Warmup then cosine, in fp32; `step` a 0-d tensor."""
    step = step.float()
    warm = rc.lr * (step + 1.0) / max(rc.warmup_steps, 1)
    t = torch.clamp((step - rc.warmup_steps)
                    / max(rc.total_steps - rc.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * rc.lr * (1.0 + torch.cos(math.pi * t))
    return torch.where(step < rc.warmup_steps, warm, cos)


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tree_leaves(tree)))


def clip_by_global_norm(grads, max_norm: float):
    """Scales the gradients in place; returns (grads, norm before)."""
    g = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(g, min=1e-9), max=1.0)
    for x in tree_leaves(grads):
        for xs in _slices(x):
            xs.copy_(xs.float() * scale)
    return grads, g


def _slices(x):
    """x's elements as views of at most SLICE elements; a DTensor whole
    (its shards are what each device updates)."""
    if not type(x) is torch.Tensor and hasattr(x, "device_mesh"):
        return [x]
    flat = x.view(-1)
    return [flat[i:i + SLICE] for i in range(0, flat.numel(), SLICE)]


def _as_moment(g, m):
    """A DTensor gradient placed as its moment is (ZeRO-1: each device's
    share of the data axis): a partial sum over the data axis becomes one
    reduce-scatter, and the norm and the update then run on the shards
    alone.  A plain tensor as it is."""
    if not hasattr(g, "device_mesh") or tuple(g.placements) == \
            tuple(m.placements):
        return g
    return g.redistribute(m.device_mesh, m.placements)


@torch.no_grad()
def adamw_update(grads, state: OptState, params, rc):
    """Returns (params, state, metrics); params and the moments are updated
    in place, and so are the gradients, unless they are DTensors placed
    otherwise than their moments (then their copies placed as the moments
    are)."""
    grads = tree_map(_as_moment, grads, state.m)
    if rc.grad_clip:
        grads, gnorm = clip_by_global_norm(grads, rc.grad_clip)
    else:
        gnorm = global_norm(grads)
    count = state.count + 1
    lr = lr_schedule(state.count, rc)
    b1, b2, eps, wd = rc.beta1, rc.beta2, rc.eps, rc.weight_decay
    bc1 = 1.0 - torch.pow(b1, count.float())
    bc2 = 1.0 - torch.pow(b2, count.float())
    for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads),
                          tree_leaves(state.m), tree_leaves(state.v)):
        for ps, gs, ms, vs in zip(*map(_slices, (p, g, m, v))):
            gf = gs.float()
            mf = b1 * ms.float() + (1 - b1) * gf
            vf = b2 * vs.float() + (1 - b2) * torch.square(gf)
            step = (mf / bc1) / (torch.sqrt(vf / bc2) + eps)
            pf = ps.float()
            ps.copy_(pf - lr * (step + wd * pf))
            ms.copy_(mf)
            vs.copy_(vf)
    metrics = {"grad_norm": gnorm, "lr": lr}
    return params, OptState(count, state.m, state.v), metrics
