"""Param trees between numpy and torch.

torch cannot reproduce `jax.random`, so parity tests make the JAX package's
params, turn them into numpy (``jax.tree_util.tree_map(np.asarray, params)``)
and hand them here.  Keys, tuple structure, stacked ``(L, ...)`` leading dims
and the padded Q heads stay exactly as they are.  A NamedTuple is rebuilt
field by field, as its own type or as the one the caller maps it to.
"""
from __future__ import annotations

import numpy as np
import torch


def _rebuild(tree, items, types=None):
    """A tuple/list/NamedTuple of the same kind as `tree` from `items`; a
    NamedTuple whose type is a key of `types` becomes that value's type,
    which must have the same fields."""
    if hasattr(tree, "_fields"):
        kind = (types or {}).get(type(tree), type(tree))
        if kind._fields != tree._fields:
            raise TypeError(f"{type(tree).__name__} fields {tree._fields} "
                            f"are not {kind._fields}")
        return kind._make(items)
    return type(tree)(items)


def from_jax(tree, device="cuda", types=None):
    """Nested dict/tuple/list of numpy arrays -> the same tree of tensors.

    numpy has no bfloat16 of its own: arrays whose dtype is named "bfloat16"
    (ml_dtypes) go through float32, which holds every bf16 value exactly.
    `types` maps a NamedTuple type of the tree (e.g. the JAX package's AdamW
    state) onto the port's type with the same fields.
    """
    if isinstance(tree, dict):
        return {k: from_jax(v, device, types) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return _rebuild(tree, [from_jax(v, device, types) for v in tree],
                        types)
    arr = np.asarray(tree)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(arr, copy=True)).to(device)


def to_numpy(tree):
    """Tree of tensors -> the same tree of numpy arrays (bf16 as float32)."""
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return _rebuild(tree, [to_numpy(v) for v in tree])
    t = tree.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()
