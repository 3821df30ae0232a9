"""A kernel op on DTensors: it runs shard by shard through `local_map`,
each shard through the op itself (the kernel on the card, the plain version
on meta or on the CPU), on the placements under which the shards are
independent: a mesh dim may split the batch or the heads, never a
dimension the op reduces over.  An input replicated where the op wants it
split is split locally (each rank keeps its chunk, with no communication);
a Partial input, or one split on another dimension, raises: the op never
gathers without saying so."""
from __future__ import annotations

import torch


def is_dtensor(x) -> bool:
    if x is None or type(x) is torch.Tensor:
        return False
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def roles(x, dims: dict, op: str) -> list:
    """For each mesh dim of DTensor `x`: dims[d] where x is Shard(d), None
    where it is replicated; raises for any other placement."""
    out = []
    for i, pl in enumerate(x.placements):
        if pl.is_replicate():
            out.append(None)
        elif pl.is_shard() and pl.dim in dims:
            out.append(dims[pl.dim])
        else:
            raise ValueError(
                f"{op}: {pl} on mesh dim {i} of an input of shape "
                f"{tuple(x.shape)}: the op runs shard by shard only over "
                f"dims {sorted(dims)} ({', '.join(dims.values())})")
    return out


def want(rs: list, dims: dict) -> tuple:
    """The placements of a tensor whose dim d plays role dims[d], under
    the per-mesh-dim roles `rs`: Shard where it has that role's dim,
    Replicate elsewhere."""
    from torch.distributed.tensor import Replicate, Shard
    at = {role: d for d, role in dims.items()}
    return tuple(Shard(at[r]) if r in at else Replicate() for r in rs)


def place(x, placements, op: str, mesh=None):
    """`x` redistributed to `placements` where that moves no data between
    ranks (Replicate -> Shard); raises where it would gather or reduce.  A
    plain tensor is taken as replicated on `mesh`."""
    if not is_dtensor(x):
        from torch.distributed.tensor import DTensor, Replicate
        x = DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                               run_check=False)
    have = tuple(x.placements)
    for i, (h, w) in enumerate(zip(have, placements)):
        if h != w and not (h.is_replicate() and w.is_shard()):
            raise ValueError(
                f"{op}: an input of shape {tuple(x.shape)} is {h} on mesh "
                f"dim {i} where the op needs {w}; redistribute it first")
    return x if have == tuple(placements) else x.redistribute(
        x.device_mesh, placements)


def run(fn, mesh, args, in_placements, out_placements):
    """fn over the local shards of `args` (DTensors), its outputs DTensors
    with `out_placements`: one output's placements, or a tuple of them.
    An input replicated over a mesh dim that splits the outputs feeds
    each shard's part of the work, so its gradient there is the sum of
    the shards' (Partial)."""
    from torch.distributed.tensor import Partial, Placement
    from torch.distributed.tensor.experimental import local_map
    if isinstance(out_placements[0], Placement):
        outs = list(out_placements)
        first = outs
    else:
        outs = tuple(list(p) for p in out_placements)
        first = outs[0]
    grads = tuple([Partial() if p.is_replicate() and not o.is_replicate()
                   else p for p, o in zip(ps, first)]
                  for ps in in_placements)
    return local_map(fn, out_placements=outs,
                     in_placements=tuple(list(p) for p in in_placements),
                     in_grad_placements=grads, device_mesh=mesh)(*args)
