"""Sharding rules: DP over (pod, data), TP/EP over model, ZeRO-1 over data.

Parameter specs are derived from leaf names (stable across stacked /
unstacked layouts); activations are guided by `shard_hint` logical rules.

A spec is a `P` (`repro_torch.placement`).  `to_named` turns a spec into
DTensor placements on a `DeviceMesh`, and `distribute` places a tree of
tensors with them.  A tree is nested dicts and tuples (a MoE model's
"first" layers); a path is the tuple of its dict keys (str) and tuple
indices (int).
"""
from __future__ import annotations

import math
from typing import Optional

from repro_torch.placement import P, placements  # noqa: F401 (re-exported)

# leaf-name classes --------------------------------------------------------

# output-feature sharded (last dim -> model)
_ROW = {"wq", "wk", "wv", "wg", "wr", "w1", "w3", "ws1", "ws3", "in_proj",
        "ck", "router", "wdkv", "wuk", "wuv", "conv_w", "conv_b", "cr",
        "bq", "bk", "bv", "norm"}
# input-feature sharded (dim -2 -> model)
_COL = {"wo", "w2", "ws2", "out", "out_proj", "cv"}
# per-head vectors (dim holding H -> model)
_HEAD_VEC = {"A_log", "dt_bias", "D_skip"}
_HEAD_MAT = {"u"}
_REPLICATED = {"ln1", "ln2", "pn1", "pn2", "final_norm", "kv_norm", "ln0",
               "ln_x", "ln_out", "s", "b", "maa_x", "maa", "maa_w1", "maa_w2",
               "w0", "maa_k", "maa_r", "mamba_ln"}


def _mesh_sizes(mesh) -> dict:
    """{axis name: size} of a `DeviceMesh`, or of a stand-in whose `shape`
    is already that dict (as the reference's tests build)."""
    if isinstance(mesh.shape, dict):
        return dict(mesh.shape)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def _axis_names(mesh) -> tuple:
    names = getattr(mesh, "axis_names", None)
    return tuple(names if names is not None else mesh.mesh_dim_names)


def batch_axes(mesh) -> tuple:
    names = _axis_names(mesh)
    return ("pod", "data") if "pod" in names else ("data",)


def effective_batch_axes(mesh, global_batch: int):
    """Largest batch-sharding axis set that divides the global batch
    (long-context B=1 shards nothing on the batch dim)."""
    ba = batch_axes(mesh)
    sizes = _mesh_sizes(mesh)
    while ba:
        size = math.prod(sizes[a] for a in ba)
        if global_batch % size == 0 and global_batch >= size:
            return ba
        ba = ba[1:]
    return None


def logical_rules(mesh, *, global_batch: int = 0,
                  seq_shard_kv: bool = False,
                  shard_params_2d: bool = False) -> dict:
    """Logical activation axis -> mesh axes, consumed by shard_hint."""
    ba = (effective_batch_axes(mesh, global_batch) if global_batch
          else batch_axes(mesh))
    return {
        "batch": ba,
        "heads": "model",
        "model_ff": "model",
        "vocab": "model",
        "expert": "model",
        # 2D-weight serving: the data axis holds weight shards, so token
        # groups stay unsharded there (they are tiny at decode batch sizes)
        "moe_groups": None if shard_params_2d else ba,
        # expert-FFN hidden dim: follows the 2D weight sharding so expert
        # matmuls stay local
        "moe_ff": "data" if shard_params_2d else None,
        "kv_seq": tuple(_axis_names(mesh)) if seq_shard_kv else "model",
    }


# trees ----------------------------------------------------------------------


def tree_items(tree, path=()):
    """(path, leaf) of a tree of dicts and tuples, in insertion order; a
    `P` is a leaf."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from tree_items(v, path + (k,))
    elif isinstance(tree, (tuple, list)) and not isinstance(tree, P):
        for i, v in enumerate(tree):
            yield from tree_items(v, path + (i,))
    else:
        yield path, tree


def tree_map_with_path(fn, tree, *rest, path=()):
    """fn(path, leaf, *rest leaves) over a tree of dicts and tuples (a `P`
    is a leaf), keeping its structure (a NamedTuple's type included)."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, *(r[k] for r in rest),
                                      path=path + (k,))
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)) and not isinstance(tree, P):
        items = [tree_map_with_path(fn, *xs, path=path + (i,))
                 for i, xs in enumerate(zip(tree, *rest))]
        return (type(tree)(*items) if hasattr(tree, "_fields")
                else type(tree)(items))
    return fn(path, tree, *rest)


def _leaf_name(path) -> str:
    for entry in reversed(path):
        if isinstance(entry, str):
            return entry
    return ""


def _path_names(path) -> list:
    return [e for e in path if isinstance(e, str)]


# parameter specs ------------------------------------------------------------


def param_pspec(path, leaf, n_experts: Optional[int] = None) -> P:
    """PartitionSpec for one parameter leaf."""
    name = _leaf_name(path)
    names = _path_names(path)
    nd = len(leaf.shape)
    none = (None,) * nd

    if name == "embed":
        return P("model", None)
    if name == "head":
        return P(None, "model")
    if name == "adapters":
        return P(None, None, "model")
    # rwkv decay loras w1/w2 live under "tm" and are tiny -> replicate
    if "tm" in names and name in ("w1", "w2"):
        return P(*none)
    # MoE expert-stacked weights: (L, E, D, F) or (E, D, F)
    if name in ("w1", "w2", "w3") and "mlp" in names and nd >= 3:
        if n_experts is not None and leaf.shape[nd - 3] == n_experts:
            spec = [None] * nd
            spec[nd - 3] = "model"
            return P(*spec)
    if name in _ROW:
        spec = [None] * nd
        spec[-1] = "model"
        return P(*spec)
    if name in _COL and nd >= 2:
        spec = [None] * nd
        spec[-2] = "model"
        return P(*spec)
    if name in _HEAD_VEC:
        spec = [None] * nd
        spec[-1] = "model"
        return P(*spec)
    if name in _HEAD_MAT and nd >= 2:
        spec = [None] * nd
        spec[-2] = "model"
        return P(*spec)
    return P(*none)


def param_specs(params, cfg) -> dict:
    """Same-structure tree of specs for a param tree (meta tensors will
    do: only shapes are read)."""
    n_experts = cfg.moe.n_experts if cfg.moe is not None else None
    return tree_map_with_path(
        lambda p, x: param_pspec(p, x, n_experts), params)


def zero1_spec(spec: P, shape, data_size: int, axis: str = "data") -> P:
    """Additionally shard an optimizer-state tensor over the data axis, on
    the first unsharded dim divisible by the data-axis size."""
    entries = list(spec) + [None] * (len(shape) - len(spec))
    for i, (e, s) in enumerate(zip(entries, shape)):
        if e is None and s % data_size == 0 and s >= data_size:
            entries[i] = axis
            return P(*entries)
    return P(*entries)


def _data_size(mesh) -> int:
    sizes = _mesh_sizes(mesh)
    return math.prod(sizes[a] for a in batch_axes(mesh))


def param_specs_2d(pspecs, params, mesh, *, min_elems: int = 1 << 26) -> dict:
    """Serving-time 2D weight sharding: additionally spread the DOMINANT
    parameter tensors (expert stacks, embeddings, LM heads) over the data
    axis — without this, a 480B MoE's expert weights are replicated 16x
    across the data axis (~117 GB/device).  Dense projection weights stay
    1D (their data-axis gathers/psums cost more than they save)."""
    data_size = _data_size(mesh)

    def upd(path, sp, x):
        name = _leaf_name(path)
        names = _path_names(path)
        is_expert = "mlp" in names and len(x.shape) >= 3 and name in (
            "w1", "w2", "w3")
        if not (is_expert or name in ("embed", "head")):
            return sp
        if math.prod(x.shape) < min_elems:
            return sp
        return zero1_spec(sp, x.shape, data_size)

    return tree_map_with_path(upd, pspecs, params)


def opt_state_specs(pspecs, params, mesh, zero1: bool) -> dict:
    if not zero1:
        return pspecs
    data_size = _data_size(mesh)
    return tree_map_with_path(
        lambda _, sp, x: zero1_spec(sp, x.shape, data_size), pspecs, params)


# ---------------------------------------------------------------------------
# Batch / cache specs
# ---------------------------------------------------------------------------


def batch_specs(cfg, shape_cfg, mesh) -> dict:
    ba = effective_batch_axes(mesh, shape_cfg.global_batch)
    sp: dict = {}
    if shape_cfg.mode == "train":
        sp["tokens"] = P(ba, None)
        sp["labels"] = P(ba, None)
    elif shape_cfg.mode == "prefill":
        sp["tokens"] = P(ba, None)
    else:
        sp["tokens"] = P(ba)
        sp["positions"] = P(ba)
    if cfg.mrope and shape_cfg.mode != "decode":
        sp["mrope_positions"] = P(None, ba, None)
    if cfg.family == "audio":
        sp["encoder_frames"] = P(ba, None, None)
    return sp


def cache_specs(cfg, cache, mesh, *, global_batch: int,
                seq_shard_kv: bool = False):
    """Spec tree matching a model's decode cache (the port's layout: see
    each family's `init_cache`).

    KV caches are SEQUENCE-sharded on the model axis (flash-decoding style:
    universal divisibility, softmax stats reduce with tiny psums) with the
    batch on the data axes; `seq_shard_kv` (long-context, batch too small
    to shard) spreads the sequence over every mesh axis instead.
    SSM / conv / token-shift states: batch on data, channels on model.
    """
    ba = effective_batch_axes(mesh, global_batch)
    if seq_shard_kv:
        seq_ax = tuple(_axis_names(mesh))
        bax = None
    else:
        seq_ax = "model"
        bax = ba

    def leaf_spec(path, x):
        names = _path_names(path)
        nd = len(x.shape)
        if cfg.family == "ssm":
            # rwkv: S (L,B,H,hd,hd) | tm_x/cm_x (L,B,D)
            if nd == 5:
                return P(None, ba, "model", None, None)
            return P(None, ba, None)
        if "memory" in names:               # whisper encoder memory (B,F,D)
            return P(ba, None, None)
        if "mamba" in names or "ssm" in names or "conv" in names:
            # (L,B,H,hd,N) or (L,B,W-1,convch)
            if nd == 5:
                return P(None, ba, "model", None, None)
            return P(None, ba, None, "model")
        if cfg.mla is not None:
            if nd == 4:                      # (L,B,T,r)
                return P(None, bax, seq_ax, None)
            if nd == 3:                      # unstacked (B,T,r)
                return P(bax, seq_ax, None)
        if nd == 5:                          # (L,B,T,G,hd)
            return P(None, bax, seq_ax, None, None)
        if nd == 4:                          # unstacked (B,T,G,hd)
            return P(bax, seq_ax, None, None)
        return P(*(None,) * nd)

    return tree_map_with_path(leaf_spec, cache)


# ---------------------------------------------------------------------------
# DTensor placements
# ---------------------------------------------------------------------------


def to_named(mesh, spec_tree):
    """Each spec of `spec_tree` as its DTensor placements on `mesh`."""
    return tree_map_with_path(lambda _, s: placements(mesh, s), spec_tree)


def distribute(tree, mesh, spec_tree):
    """`tree` placed on `mesh` leaf by leaf with `distribute_tensor`, each
    leaf by its spec.  Every rank holds the whole leaf and keeps its own
    shard (`src_data_rank=None`: no communication)."""
    from torch.distributed.tensor import distribute_tensor
    return tree_map_with_path(
        lambda _, x, s: distribute_tensor(x, mesh, placements(mesh, s),
                                          src_data_rank=None),
        tree, spec_tree)
