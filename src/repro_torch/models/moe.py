"""Mixture-of-Experts FFN: grouped, capacity-dropped dispatch, as the JAX
package's `apply_moe`.

Tokens are cut into groups of g; each group gives every expert C slots.  A
token's k choices take slots choice-major (GShard: all first choices of the
group, then all second choices, ...); a choice whose slot is C or more is
dropped.  The experts run as batched products over (group, expert, slot),
padded slots included, so the dropped choices and the padding are exactly
the reference's.  Shared experts (DeepSeek-V2) and Arctic's dense residual
are one wide gated FFN applied to every token.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.models.common import activation, dense_init, shard_hint


def shared_width(cfg) -> int:
    m = cfg.moe
    w = m.n_shared_experts * m.d_expert
    if m.dense_residual:
        w += m.dense_d_ff or cfg.d_ff
    return w


def init_moe(gen, cfg, n_layers: int, *, device="cuda"):
    m = cfg.moe
    D, E, Fe = cfg.d_model, m.n_experts, m.d_expert
    L = (n_layers,) if n_layers else ()
    p = {"router": dense_init(gen, L + (D, E), D, device),
         "w1": dense_init(gen, L + (E, D, Fe), D, device),
         "w3": dense_init(gen, L + (E, D, Fe), D, device),
         "w2": dense_init(gen, L + (E, Fe, D), Fe, device)}
    sw = shared_width(cfg)
    if sw:
        p["ws1"] = dense_init(gen, L + (D, sw), D, device)
        p["ws3"] = dense_init(gen, L + (D, sw), D, device)
        p["ws2"] = dense_init(gen, L + (sw, D), sw, device)
    return p


def _capacity(g: int, k: int, cf: float, E: int) -> int:
    c = int(g * k * cf / E)
    c = max(8, ((c + 7) // 8) * 8)
    return min(c, g * k)


def token_group(T: int, group: int) -> int:
    """The largest of group, group/2, group/4, ... (at most T) dividing T."""
    g = min(group, T)
    while T % g:
        g //= 2
    return g


class Routing(NamedTuple):
    """One layer's routing of G groups of g tokens, choice-major: entry
    j*g + t of a group is token t's (j+1)-th choice."""
    idx: torch.Tensor      # (G, k*g) expert
    slot: torch.Tensor     # (G, k*g) position within the expert's slots
    keep: torch.Tensor     # (G, k*g) slot < C
    gate: torch.Tensor     # (G, k*g) fp32 renormalised top-k probability
    capacity: int          # C
    aux: torch.Tensor      # Switch load-balance loss, fp32 scalar


def route(router, xg, cfg) -> Routing:
    """Route xg (G, g, D): fp32 router logits, softmax, top-k renormalised
    by its sum (clamped at 1e-9), the Switch aux loss, and the choice-major
    slots by a cumulative sum over the group's k*g choices."""
    m = cfg.moe
    E, k = m.n_experts, m.top_k
    G, g, _ = xg.shape
    logits = xg.float() @ router.float()                             # (G,g,E)
    probs = torch.softmax(logits, dim=-1)
    vals, idx = torch.topk(probs, k, dim=-1)                         # (G,g,k)
    vals = vals / torch.clamp(vals.sum(-1, keepdim=True), min=1e-9)
    me = probs.mean(dim=(0, 1))                                      # (E,)
    ce = F.one_hot(idx, E).float().sum(2).mean(dim=(0, 1))           # (E,)
    aux = E * torch.sum(me * ce) * m.router_aux_loss
    idx_km = idx.transpose(1, 2).reshape(G, k * g)
    oh = F.one_hot(idx_km, E)                                        # (G,kg,E)
    slot = ((torch.cumsum(oh, dim=1) - oh) * oh).sum(-1)
    C = _capacity(g, k, m.capacity_factor, E)
    return Routing(idx_km, slot, slot < C,
                   vals.transpose(1, 2).reshape(G, k * g), C, aux)


def _dispatch(xg, idx, slot, keep, *, E: int, C: int):
    """(G, E, C, D): each kept choice's token row at (group, expert, slot);
    a dropped choice adds zeros at slot 0, as the reference's scatter
    does."""
    G, g, D = xg.shape
    tok = torch.arange(g, device=xg.device).repeat(idx.shape[1] // g)
    upd = torch.where(keep[..., None], xg[:, tok], 0)               # (G,kg,D)
    base = (torch.arange(G, device=xg.device)[:, None] * E + idx) * C
    ein = torch.zeros((G * E * C, D), dtype=xg.dtype, device=xg.device)
    ein.index_add_(0, (base + torch.where(keep, slot, 0)).reshape(-1),
                   upd.reshape(-1, D))
    return ein.reshape(G, E, C, D)


def _combine(eout, idx, slot, keep, gate, *, k: int, C: int):
    """(G, g, D): each choice's expert row, weighted by gate * keep (a
    dropped choice reads a clamped slot and weighs 0), summed over the k
    choices (entry j*g + t of a group is token t's (j+1)-th choice)."""
    G, E, _, D = eout.shape
    kg = idx.shape[1]
    base = (torch.arange(G, device=eout.device)[:, None] * E + idx) * C
    rows = eout.reshape(G * E * C, D)[
        (base + slot.clamp(max=C - 1)).reshape(-1)].reshape(G, kg, D)
    w = gate.to(eout.dtype) * keep.to(eout.dtype)
    return (rows * w[..., None]).reshape(G, k, kg // k, D).sum(1)


def _by_group(fn, *ts, **kw):
    """fn(*ts, **kw), each tensor's dim 0 the group.  On DTensors, group
    by group on each shard of the groups (fn's indices are the shard's
    own): the inputs are first replicated over every other mesh dim."""
    if not hasattr(ts[0], "device_mesh"):
        return fn(*ts, **kw)
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = ts[0].device_mesh
    want = [Shard(0) if p == Shard(0) else Replicate()
            for p in ts[0].placements]
    ts = [t.redistribute(mesh, want) for t in ts]
    return local_map(lambda *ls: fn(*ls, **kw), out_placements=want,
                     in_placements=(want,) * len(ts), device_mesh=mesh)(*ts)


def apply_moe(p, x, cfg, *, group_size: int = 1024):
    """x: (B, S, D) -> (out (B, S, D), aux_loss fp32 scalar)."""
    m = cfg.moe
    E, k = m.n_experts, m.top_k
    B, S, D = x.shape
    T = B * S
    g = token_group(T, group_size)
    G = T // g
    xg = shard_hint(x.reshape(G, g, D), "moe_groups", None, None)
    r = route(p["router"], xg, cfg)
    C = r.capacity

    ein = _by_group(_dispatch, xg, r.idx, r.slot, r.keep, E=E, C=C)
    ein = shard_hint(ein, "moe_groups", "expert", None, "moe_ff")

    act = activation(cfg.act)
    h = torch.einsum("gecd,edf->gecf", ein, p["w1"].to(x.dtype))
    h = act(h) * torch.einsum("gecd,edf->gecf", ein, p["w3"].to(x.dtype))
    h = shard_hint(h, "moe_groups", "expert", None, "moe_ff")
    eout = torch.einsum("gecf,efd->gecd", h, p["w2"].to(x.dtype))
    eout = shard_hint(eout, "moe_groups", "expert", None, None)
    del ein, h
    y = _by_group(_combine, eout, r.idx, r.slot, r.keep, r.gate, k=k,
                  C=C).reshape(B, S, D)

    if "ws1" in p:
        hs = act(x @ p["ws1"].to(x.dtype)) * (x @ p["ws3"].to(x.dtype))
        hs = shard_hint(hs, "batch", None, "model_ff")
        y = y + hs @ p["ws2"].to(x.dtype)
    return shard_hint(y, "batch", None, None), r.aux
