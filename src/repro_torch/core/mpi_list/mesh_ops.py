"""DFM device bridge: the mpi-list bulk operations on tensors on one torch
device or on a `DeviceMesh`, the port's counterpart of the JAX package's
`repro.core.mpi_list.mesh_ops`, which lowers them onto a jax mesh.

A "device DFM" is a pytree (a tensor, or nested dict / list / tuple of
tensors) whose leading dim is the global list index.  On one device the
paper's contiguous-block partition is the whole list in one block, so the
ops are the bulk operations themselves:

    map         -> torch.func.vmap(f)   (elementwise over the list dim)
    reduce      -> a pairwise tree, the JAX bridge's order of combines
    scan        -> an inclusive prefix in ceil(log2 N) doubling passes
    repartition -> the identity, placed on the device
    group       -> stable sort by destination + a gather of every leaf

Every function takes `device` (a `torch.device` or a string) where the JAX
bridge takes `mesh`, or a `DeviceMesh`.  On a mesh a DFM is a DTensor split
over ("pod", "data") or ("data",) on its list dim with the contiguous-block
partition (`Shard(0)`), replicated over the other axes, as the JAX
bridge's `data_sharding`:

    map         -> vmap(f) on each rank's block (no communication)
    sum         -> each block's sum, then an all-reduce
    reduce,     -> the list gathered on every rank, the one-device function
    scan, group    there, and the result split again (reduce's replicated)
    repartition -> placed in the canonical partition

so every op gives the one-device path's result (the sum up to the order
of a floating-point sum).
"""
from __future__ import annotations

from typing import Callable

import torch
from torch.utils import _pytree as pytree


def _is_mesh(where) -> bool:
    return hasattr(where, "mesh_dim_names")


def _device(device) -> torch.device:
    if isinstance(device, str):
        return torch.device(device)
    if isinstance(device, torch.device):
        return device
    raise NotImplementedError(f"the DFM bridge runs on one device or on a "
                              f"DeviceMesh, got {device!r}")


def data_placements(mesh) -> list:
    """`Shard(0)` on the ("pod", "data") axes of `mesh`, `Replicate`
    elsewhere."""
    from torch.distributed.tensor import Replicate, Shard
    return [Shard(0) if a in ("pod", "data") else Replicate()
            for a in mesh.mesh_dim_names]


def _whole(v) -> torch.Tensor:
    """A leaf as one tensor on this rank: a DTensor gathered."""
    return v.full_tensor() if hasattr(v, "full_tensor") else v


def _split(mesh, v):
    """A whole tensor (every rank holds it) as a DFM leaf on `mesh`."""
    from torch.distributed.tensor import distribute_tensor
    v = torch.as_tensor(v).to(mesh.device_type)
    return distribute_tensor(v, mesh, data_placements(mesh),
                             src_data_rank=None)


def iterates(device, N: int) -> torch.Tensor:
    """0 .. N-1 as int32 (the JAX bridge's `jnp.arange` without x64)."""
    if _is_mesh(device):
        return _split(device, torch.arange(N, dtype=torch.int32))
    return torch.arange(N, dtype=torch.int32, device=_device(device))


def scatter(device, x) -> torch.Tensor:
    if _is_mesh(device):
        return _split(device, x)
    return torch.as_tensor(x, device=_device(device))


def dfm_map(device, f: Callable, dfm, *, donate: bool = False):
    """f over every element (`torch.func.vmap`).  `donate` is accepted for
    the JAX bridge's signature and has no effect: the inputs are kept."""
    dfm = repartition(device, dfm)
    if not _is_mesh(device):
        return torch.func.vmap(f)(dfm)
    from torch.distributed.tensor import DTensor
    mesh = device
    leaves, spec = pytree.tree_flatten(dfm)
    n = leaves[0].shape[0]
    out = torch.func.vmap(f)(pytree.tree_unflatten(
        [v.to_local() for v in leaves], spec))

    def wrap(o):
        shape = (n,) + tuple(o.shape[1:])
        return DTensor.from_local(o, mesh, data_placements(mesh),
                                  run_check=False, shape=shape,
                                  stride=torch.empty(shape,
                                                     device="meta").stride())
    return pytree.tree_map(wrap, out)


def _pairwise(f_monoid):
    def pairwise(v):
        n = v.shape[0]
        if n == 1:
            return v[0]
        if n % 2:
            return f_monoid(pairwise(v[:-1]), v[-1])
        return pairwise(f_monoid(v[0::2], v[1::2]))
    return pairwise


def dfm_reduce(device, f_monoid: Callable, dfm):
    """Tree-reduction over the global list with an associative monoid, in
    the JAX bridge's order: halve by combining even and odd rows, and fold
    the last row of an odd length in after the rest.  On a mesh the
    result is the same on every rank."""
    pairwise = _pairwise(f_monoid)
    dfm = repartition(device, dfm)
    return pytree.tree_map(lambda v: pairwise(_whole(v)), dfm)


_NARROW = (torch.bool, torch.uint8, torch.int8, torch.int16, torch.int32)


def _sum(v: torch.Tensor) -> torch.Tensor:
    # jnp.sum's types without x64: bools and narrow integers sum to int32
    dtype = torch.int32 if v.dtype in _NARROW else v.dtype
    s = v.sum(dim=0, dtype=dtype)
    return s.full_tensor() if hasattr(s, "full_tensor") else s


def dfm_sum(device, dfm):
    return pytree.tree_map(_sum, repartition(device, dfm))


def _scan(f_assoc):
    def scan(v):
        out, s = v, 1
        while s < v.shape[0]:
            out = torch.cat([out[:s], f_assoc(out[:-s], out[s:])])
            s *= 2
        return out
    return scan


def dfm_scan(device, f_assoc: Callable, dfm):
    """Inclusive prefix scan of each leaf for any associative `f_assoc`: pass
    k sets out[i] = f(out[i - s], out[i]) for i >= s = 2^k, the earlier
    rows always the first operand, so a non-commutative f comes out in list
    order."""
    scan = _scan(f_assoc)
    dfm = repartition(device, dfm)
    if not _is_mesh(device):
        return pytree.tree_map(scan, dfm)
    return pytree.tree_map(lambda v: _split(device, scan(_whole(v))), dfm)


def repartition(device, dfm):
    """Rebalance to the canonical contiguous-block partition: on one device,
    every leaf placed there; on a mesh, split over the data axes."""
    if not _is_mesh(device):
        dev = _device(device)
        return pytree.tree_map(lambda v: torch.as_tensor(v).to(dev), dfm)
    mesh = device
    want = data_placements(mesh)

    def place(v):
        if hasattr(v, "device_mesh"):
            return v if list(v.placements) == want else v.redistribute(
                mesh, want)
        return _split(mesh, v)
    return pytree.tree_map(place, dfm)


def group(device, dest, dfm):
    """Move row i to bucket dest[i]: rows in bucket order, stable within a
    bucket (the all-to-all exchange pattern of mpi-list.group)."""
    if _is_mesh(device):
        if not isinstance(dest, torch.Tensor):
            dest = torch.as_tensor(dest)
        dest = _whole(repartition(device, dest))
        order = torch.argsort(dest, stable=True)
        return pytree.tree_map(
            lambda v: _split(device, _whole(v).index_select(0, order)),
            repartition(device, dfm))
    dev = _device(device)
    order = torch.argsort(torch.as_tensor(dest, device=dev), stable=True)
    return pytree.tree_map(lambda v: v.index_select(0, order),
                           repartition(dev, dfm))


def collect(dfm):
    """Every leaf as a numpy array on the host (a DTensor gathered)."""
    return pytree.tree_map(lambda v: _whole(v).detach().cpu().numpy(), dfm)
