"""DFM device bridge: the mpi-list bulk operations on tensors on one torch
device, the port's counterpart of the JAX package's
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
bridge takes `mesh`.  A layout over several cards needs the port's
`torch.distributed` sharding, which is not written yet, so anything that is
not one device raises `NotImplementedError`.
"""
from __future__ import annotations

from typing import Callable

import torch
from torch.utils import _pytree as pytree


def _device(device) -> torch.device:
    if isinstance(device, str):
        return torch.device(device)
    if isinstance(device, torch.device):
        return device
    raise NotImplementedError(
        f"the port's DFM bridge runs on one device, got {device!r}: a layout "
        f"over several cards needs torch.distributed sharding, not ported "
        f"yet")


def iterates(device, N: int) -> torch.Tensor:
    """0 .. N-1 as int32 (the JAX bridge's `jnp.arange` without x64)."""
    return torch.arange(N, dtype=torch.int32, device=_device(device))


def scatter(device, x) -> torch.Tensor:
    return torch.as_tensor(x, device=_device(device))


def dfm_map(device, f: Callable, dfm, *, donate: bool = False):
    """f over every element (`torch.func.vmap`).  `donate` is accepted for
    the JAX bridge's signature and has no effect: the inputs are kept."""
    return torch.func.vmap(f)(repartition(device, dfm))


def dfm_reduce(device, f_monoid: Callable, dfm):
    """Tree-reduction over the global list with an associative monoid, in
    the JAX bridge's order: halve by combining even and odd rows, and fold
    the last row of an odd length in after the rest."""
    def pairwise(v):
        n = v.shape[0]
        if n == 1:
            return v[0]
        if n % 2:
            return f_monoid(pairwise(v[:-1]), v[-1])
        return pairwise(f_monoid(v[0::2], v[1::2]))
    return pytree.tree_map(pairwise, repartition(device, dfm))


_NARROW = (torch.bool, torch.uint8, torch.int8, torch.int16, torch.int32)


def _sum(v: torch.Tensor) -> torch.Tensor:
    # jnp.sum's types without x64: bools and narrow integers sum to int32
    dtype = torch.int32 if v.dtype in _NARROW else v.dtype
    return v.sum(dim=0, dtype=dtype)


def dfm_sum(device, dfm):
    return pytree.tree_map(_sum, repartition(device, dfm))


def dfm_scan(device, f_assoc: Callable, dfm):
    """Inclusive prefix scan of each leaf for any associative `f_assoc`: pass
    k sets out[i] = f(out[i - s], out[i]) for i >= s = 2^k, the earlier
    rows always the first operand, so a non-commutative f comes out in list
    order."""
    def scan(v):
        out, s = v, 1
        while s < v.shape[0]:
            out = torch.cat([out[:s], f_assoc(out[:-s], out[s:])])
            s *= 2
        return out
    return pytree.tree_map(scan, repartition(device, dfm))


def repartition(device, dfm):
    """Rebalance to the canonical contiguous-block partition: on one device,
    every leaf placed there."""
    dev = _device(device)
    return pytree.tree_map(lambda v: torch.as_tensor(v).to(dev), dfm)


def group(device, dest, dfm):
    """Move row i to bucket dest[i]: rows in bucket order, stable within a
    bucket (the all-to-all exchange pattern of mpi-list.group)."""
    dev = _device(device)
    order = torch.argsort(torch.as_tensor(dest, device=dev), stable=True)
    return pytree.tree_map(lambda v: v.index_select(0, order),
                   repartition(dev, dfm))


def collect(dfm):
    """Every leaf as a numpy array on the host."""
    return pytree.tree_map(lambda v: v.detach().cpu().numpy(), dfm)
