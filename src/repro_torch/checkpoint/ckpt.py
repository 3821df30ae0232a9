"""Checkpointing in the JAX package's on-disk format.

Layout per step:  <dir>/step_<N>/
    manifest.json       tree structure, shapes, dtypes, step, metadata
    arrays.npz          flattened path -> ndarray
Writes go to a tmp dir + atomic rename (crash-safe); `AsyncCheckpointer`
overlaps serialization with the next training steps (one in flight).

Keys are the `/`-joined tree paths JAX writes for the same tree: dict keys
sorted, a NamedTuple field `f` as `.f` (the `str` of JAX's attribute key),
a sequence index as its number.  bf16 leaves are stored as JAX stores them:
their raw 2-byte words under the npy type `<V2`, with "bfloat16" in the
manifest, and are read back through the manifest's dtype (numpy has no
bfloat16 of its own).  The same tree gives the same `arrays.npz` bytes as
JAX's `ckpt.save` and the same manifest keys, shapes, dtypes and metadata
(the treedef string, which nothing reads, and the time apart).
`restore(..., mesh=, spec_tree=)` places each leaf on a `DeviceMesh` as a
DTensor by its spec (elastic: the mesh need not be the one used at save
time).
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
import zipfile
from pathlib import Path

import numpy as np
import torch

from repro_torch.placement import P, placements

# numpy's header type for JAX's bfloat16 (ml_dtypes), whose arrays numpy
# itself reads back as raw 2-byte void
_BF16_DESCR = "<V2"


def _items(tree, prefix=()):
    """(path, leaf) pairs in JAX's flattening order; a spec (`P`) is a
    leaf."""
    if isinstance(tree, P):
        yield "/".join(prefix), tree
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from _items(tree[k], prefix + (str(k),))
    elif hasattr(tree, "_fields"):
        for f in tree._fields:
            yield from _items(getattr(tree, f), prefix + (f".{f}",))
    elif isinstance(tree, (tuple, list)):
        for i, x in enumerate(tree):
            yield from _items(x, prefix + (str(i),))
    else:
        yield "/".join(prefix), tree


def _host(t) -> torch.Tensor:
    """A host copy of a tensor leaf, never a view of it."""
    return t.detach().to("cpu", copy=True)


def _numpy(t: torch.Tensor) -> tuple:
    """(ndarray, dtype name): bf16 as its raw int16 words."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy(), "bfloat16"
    a = t.numpy()
    return a, str(a.dtype)


def _write_npz(path: Path, flat: dict):
    """np.savez's bytes (stored, zip64 entries, the zip's default 1980
    time), with bf16 arrays under JAX's header type."""
    with zipfile.ZipFile(path, mode="w", compression=zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for key, (arr, dtype) in flat.items():
            with zf.open(key + ".npy", "w", force_zip64=True) as f:
                if dtype != "bfloat16":
                    np.lib.format.write_array(f, arr, allow_pickle=False)
                    continue
                np.lib.format.write_array_header_1_0(
                    f, {"descr": _BF16_DESCR, "fortran_order": False,
                        "shape": arr.shape})
                f.write(arr.tobytes("C"))


def save(directory: str, step: int, tree, metadata: dict = None) -> str:
    """Writes `tree` (tensors on any device, or host copies) as step
    `step`; returns the step's directory."""
    d = Path(directory)
    final = d / f"step_{step:08d}"
    tmp = d / f".tmp_step_{step:08d}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    flat = {k: _numpy(v) for k, v in _items(tree)}
    _write_npz(tmp / "arrays.npz", flat)
    manifest = {
        "step": step,
        # JAX writes str(treedef) here; nothing reads it back, so the
        # port writes the root's type
        "treedef": str(type(tree)),
        "keys": sorted(flat),
        "shapes": {k: list(a.shape) for k, (a, _) in flat.items()},
        "dtypes": {k: dt for k, (_, dt) in flat.items()},
        "metadata": metadata or {},
        "time": time.time(),
    }
    (tmp / "manifest.json").write_text(json.dumps(manifest))
    if final.exists():
        shutil.rmtree(final)
    os.replace(tmp, final)                      # atomic publish
    return str(final)


def latest_step(directory: str):
    d = Path(directory)
    if not d.exists():
        return None
    steps = sorted(int(p.name.split("_")[1]) for p in d.glob("step_*"))
    return steps[-1] if steps else None


def _rebuild(tree, leaves):
    """`tree`'s structure with its leaves taken in `_items` order."""
    if isinstance(tree, dict):
        out = {k: _rebuild(tree[k], leaves) for k in sorted(tree)}
        return {k: out[k] for k in tree}            # the template's order
    if hasattr(tree, "_fields"):
        return type(tree)._make(_rebuild(x, leaves) for x in tree)
    if isinstance(tree, (tuple, list)):
        return type(tree)(_rebuild(x, leaves) for x in tree)
    return next(leaves)


def restore(directory: str, step: int, template, *, mesh=None,
            spec_tree=None):
    """The tree saved at `step`, copied into `template` (a tree of tensors)
    in place, each leaf cast to its template's dtype on its device, so no
    second copy of the tree is allocated; returns `template`.

    With `mesh` (a `DeviceMesh`) and `spec_tree` (the template's tree of
    `repro_torch.placement.P`), each leaf is read as above and placed on the
    mesh's device type by its spec, each rank keeping its own shard of the
    whole leaf it read (no communication); returns a new tree of DTensors,
    `template` giving only shapes and dtypes (meta tensors will do)."""
    if (mesh is None) != (spec_tree is None):
        raise ValueError("restore: give both mesh and spec_tree, or neither")
    d = Path(directory) / f"step_{step:08d}"
    dtypes = json.loads((d / "manifest.json").read_text())["dtypes"]
    specs = dict(_items(spec_tree)) if mesh is not None else None
    placed = []
    with np.load(d / "arrays.npz") as data, torch.no_grad():
        for key, leaf in _items(template):
            arr = np.array(data[key])       # writable, owned by the tensor
            if tuple(arr.shape) != tuple(leaf.shape):
                raise ValueError(f"{key}: saved shape {arr.shape}, template "
                                 f"{tuple(leaf.shape)}")
            if dtypes[key] == "bfloat16":
                t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
            else:
                t = torch.from_numpy(arr)
            if mesh is None:
                leaf.copy_(t)
                continue
            from torch.distributed.tensor import distribute_tensor
            t = t.to(device=mesh.device_type, dtype=leaf.dtype)
            placed.append(distribute_tensor(
                t, mesh, placements(mesh, specs[key]), src_data_rank=None))
    return template if mesh is None else _rebuild(template, iter(placed))


def retain(directory: str, keep: int = 3):
    d = Path(directory)
    steps = sorted(d.glob("step_*"))
    for p in steps[:-keep]:
        shutil.rmtree(p)


class AsyncCheckpointer:
    """One save in flight; next save waits for the previous (bounded).

    The port's train step updates params and moments in place, so `save`
    copies the tree to host memory before it returns, as JAX's
    `device_get` does; the thread writes that copy."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self._thread: threading.Thread = None
        self._error: BaseException = None
        self.saved: list = []

    def save(self, step: int, tree, metadata: dict = None):
        self.wait()
        host_tree = _rebuild(tree, iter([_host(v) for _, v in _items(tree)]))

        def work():
            try:
                p = save(self.directory, step, host_tree, metadata)
                self.saved.append(p)
                retain(self.directory, self.keep)
            except BaseException as e:   # noqa: BLE001 - re-raised in wait
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self):
        """Waits for the save in flight; raises what it raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err
