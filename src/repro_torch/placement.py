"""Partition specs and their DTensor placements, below every layer that
places a tensor on a mesh (the models' hints, checkpoints, the sharding
rules).

A spec is a `P`: a tuple of per-dimension entries, each None, a mesh axis
name or a tuple of names (a dimension split over several axes), as JAX's
`PartitionSpec`."""
from __future__ import annotations


class P(tuple):
    """A partition spec: P("model", None), P(("pod", "data"), None), P().
    A one-name tuple entry is kept as the name, as JAX keeps it."""

    def __new__(cls, *entries):
        return super().__new__(cls, tuple(
            e[0] if isinstance(e, tuple) and len(e) == 1 else e
            for e in entries))

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"


def placements(mesh, spec) -> tuple:
    """DTensor placements of `spec` on `mesh`: for each mesh dim, in mesh
    order, Shard(d) where tensor dim d names that axis, else Replicate.  A
    tensor dim named by several axes is sharded on each of them in mesh
    order, JAX's major-to-minor order."""
    from torch.distributed.tensor import Replicate, Shard
    at = {}
    for d, entry in enumerate(spec):
        for ax in (entry if isinstance(entry, tuple) else (entry,)):
            if ax is not None:
                at[ax] = d
    return tuple(Shard(at[ax]) if ax in at else Replicate()
                 for ax in mesh.mesh_dim_names)
