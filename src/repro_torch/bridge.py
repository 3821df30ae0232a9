"""Param trees between numpy and torch.

torch cannot reproduce `jax.random`, so parity tests make the JAX package's
params, turn them into numpy (``jax.tree_util.tree_map(np.asarray, params)``)
and hand them here.  Keys, tuple structure, stacked ``(L, ...)`` leading dims
and the padded Q heads stay exactly as they are.
"""
from __future__ import annotations

import numpy as np
import torch


def from_jax(tree, device="cuda"):
    """Nested dict/tuple/list of numpy arrays -> the same tree of tensors.

    numpy has no bfloat16 of its own: arrays whose dtype is named "bfloat16"
    (ml_dtypes) go through float32, which holds every bf16 value exactly.
    """
    if isinstance(tree, dict):
        return {k: from_jax(v, device) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(from_jax(v, device) for v in tree)
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
        return type(tree)(to_numpy(v) for v in tree)
    t = tree.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()
