"""The weights of a cell, made from its seed on the device.

The tree's layout (names and shapes) is the program's: `model.init` on the
meta device gives it without storage.  Which leaves are served in bf16 is
the program's serving policy too (`serving_params` of that meta tree, whose
probe watches how the model reads each leaf).  The values are the
benchmark's own: one draw a leaf from a generator on the device, seeded
from the cell's seed and the leaf's index, in the dtype the leaf is served
in, so that any single leaf can be drawn again for the reference without
the others.  The rules that set each leaf's distribution are the
configuration file's `init`, by the leaf's last name."""
from __future__ import annotations

import math

import torch

SEED_MOD = 1 << 63


def leaves(tree, prefix=()):
    """(path, leaf) of a tree of dicts and tuples, in insertion order."""
    items = (tree.items() if isinstance(tree, dict)
             else enumerate(tree) if isinstance(tree, (tuple, list)) else ())
    for k, v in items:
        if isinstance(v, (dict, tuple, list)):
            yield from leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def rebuild(tree, values: dict, prefix=()):
    """`tree` with each leaf replaced by values[path]."""
    if isinstance(tree, dict):
        return {k: rebuild(v, values, prefix + (k,)) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(rebuild(v, values, prefix + (i,))
                          for i, v in enumerate(tree))
    return values[prefix]


def leaf_seed(seed: int, index: int) -> int:
    return (int(seed) * 1_000_003 + index) % SEED_MOD


def draw(shape, dtype, rule, seed: int, device):
    """One leaf by `rule` ([kind, a, b]) from a generator seeded `seed`."""
    gen = torch.Generator(device=device).manual_seed(seed)
    kind, a, b = rule
    t = torch.empty(shape, dtype=torch.float32 if kind != "fan_in" else dtype,
                    device=device)
    if kind == "fan_in":                 # N(0, 1/fan_in), fan_in = shape[-2]
        return t.normal_(0.0, a / math.sqrt(shape[-2]), generator=gen)
    if kind != "normal":
        raise ValueError(f"init rule {kind!r}")
    t.normal_(a, b, generator=gen)
    return t.to(dtype)


def rule_for(path, shape, rules: dict):
    name = str(path[-1])
    if name in rules:
        return rules[name]
    return rules["matrix"] if len(shape) >= 2 else rules["vector"]


def layout(model, served_dtype=torch.bfloat16):
    """The program's tree on the meta device, each leaf in the dtype the
    program serves it in."""
    from repro_torch.runtime.serve_step import serving_params
    meta = model.init(torch.Generator().manual_seed(0), "meta")
    return serving_params(model, meta, served_dtype)


def make(skeleton, rules: dict, seed: int, device, *, dtype=None,
         only=None):
    """The weights of `skeleton`'s layout from `seed`: each leaf in its
    skeleton dtype (or `dtype` for all), or only the leaves whose index is
    in `only` (the others None)."""
    values = {}
    for i, (path, t) in enumerate(leaves(skeleton)):
        if only is not None and i not in only:
            values[path] = None
            continue
        values[path] = draw(tuple(t.shape), dtype or t.dtype,
                            rule_for(path, t.shape, rules),
                            leaf_seed(seed, i), device)
    return rebuild(skeleton, values)
