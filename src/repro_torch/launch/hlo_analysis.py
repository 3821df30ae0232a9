"""Per-device flop/byte/collective accounting + roofline.

The JAX package parses the partitioned HLO that XLA compiles for one
device.  Eager PyTorch has no HLO: this module counts the ops themselves
as they are dispatched, beneath DTensor, so every count is per device.  A
`TorchDispatchMode` declines the DTensor-level calls; DTensor then runs
each op on the local shards, and those calls are counted:

  * flops: `torch.utils.flop_counter`'s formula registry (matmuls,
    convolutions, SDPA), plus each hand-written kernel's own count
    (`kernels/cost.py`), which its op records once per call while the
    aten ops of its plain version, on meta or on the CPU, are not counted
    (a kernel launched through ctypes never reaches the dispatcher);
  * hbm_bytes: the operands and outputs of every op that moves data.  View
    ops count nothing; an in-place write counts what it writes, so a write
    into a slice (a cache update) counts the slice, not the buffer (the
    reference's dynamic-update-slice rule);
  * collectives: the output bytes of each `_c10d_functional` op by kind
    (and of DTensor's own all-to-all, `_dtensor.shard_dim_alltoall`), and
    their total.

DTensor's sharding propagation runs each op once more on FakeTensors at
the global shapes; those calls are not counted.  The reference's
`total_bf16_corrected` undoes XLA's CPU lowering, which widens bf16
reduces to fp32; nothing widens them here, so it equals `total`.
`trip_counts` is empty: eager dispatch runs every layer of a loop, so
nothing needs correcting for loops counted once.
"""
from __future__ import annotations

import contextlib
import re
import sys
from collections import defaultdict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels import cost

_COLL_KIND = {
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all", "broadcast": "collective-permute",
    "broadcast_": "collective-permute",
    "shard_dim_alltoall": "all-to-all",        # the _dtensor namespace's
}

_aten = torch.ops.aten
# ops that allocate or move no data
_NO_BYTES = {_aten.empty.memory_format, _aten.empty_strided.default,
             _aten._unsafe_view.default,
             _aten.empty_like.default, _aten.new_empty.default,
             _aten.new_empty_strided.default, _aten.lift_fresh.default,
             _aten._local_scalar_dense.default, _aten.set_.source_Storage,
             _aten.resize_.default, _aten.sym_size.int,
             _aten.sym_stride.int, _aten.sym_numel.default}
# the functional collectives' autograd wrapper and their wait: identities
# on the tensor the collective wrote
_NO_BYTES_NAMES = {"_wrap_tensor_autograd", "wait_tensor"}
# gathers: they read the rows they take, not the table
_GATHERS = {"index", "index_select", "gather", "embedding"}
# in-place scatters into `self`: they write what their source holds, not
# the buffer (its name in the schema)
_SCATTER_SRC = {"index_put_": "values", "_index_put_impl_": "values",
                "index_add_": "source", "index_copy_": "source",
                "scatter_": "src", "scatter_add_": "src",
                "masked_scatter_": "source"}


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _is_fake(types) -> bool:
    from torch._subclasses.fake_tensor import FakeTensor
    return any(issubclass(t, FakeTensor) for t in types)


def _op_bytes(func, args, kwargs, out) -> int:
    """Operands and outputs of one op, an output that aliases an input
    (in place, `out=`) counted once, as the input; a gather counts the
    indices and its output twice (the rows read, then written); an
    in-place scatter its source and indices, read, and the source's bytes
    again, written."""
    name = func._schema.name.split("::")[-1]
    if func.is_view or func in _NO_BYTES or name in _NO_BYTES_NAMES:
        return 0
    if name in _GATHERS:
        idx = [t for t in tree_leaves((args[1:], kwargs))
               if isinstance(t, torch.Tensor)]
        if name == "embedding":              # (weight, indices, ...)
            idx = [args[1]]
        return 2 * _nbytes(out) + sum(_nbytes(t) for t in idx)
    if name in _SCATTER_SRC:
        schema_args = func._schema.arguments
        bound = dict(zip((a.name for a in schema_args), args))
        bound.update(kwargs)
        src = bound.get(_SCATTER_SRC[name])
        idx = [t for k, v in bound.items() if k not in ("self",
                                                       _SCATTER_SRC[name])
               for t in tree_leaves(v) if isinstance(t, torch.Tensor)]
        return 2 * _nbytes(src) + sum(_nbytes(t) for t in idx)
    n = sum(_nbytes(t) for t in tree_leaves((args, kwargs))
            if isinstance(t, torch.Tensor))
    aliased = [r.alias_info is not None for r in func._schema.returns]
    outs = out if isinstance(out, (tuple, list)) else (out,)
    for i, o in enumerate(outs):
        if i < len(aliased) and aliased[i]:
            continue
        n += sum(_nbytes(t) for t in tree_leaves(o)
                 if isinstance(t, torch.Tensor))
    return n


_MODEL_FRAME = re.compile(r'repro_torch/models/(\w+)\.py", line \d+, in (\w+)')


def _model_tag() -> str:
    """The innermost `repro_torch.models` function on the stack, as
    "module.function" (the reference's op_name metadata).  An op that the
    backward runs is tagged "bwd:" and the backward node's name, and, where
    anomaly mode recorded the forward's stack on the node, the innermost
    model function the forward ran it in.  Any other op is tagged with the
    innermost function of the port outside this module (the train step,
    the optimizer), or "-"."""
    f, outer = sys._getframe(2), None
    while f is not None:
        mod = f.f_globals.get("__name__", "")
        if mod.startswith("repro_torch.models"):
            return f"{mod.rsplit('.', 1)[-1]}.{f.f_code.co_name}"
        if outer is None and mod.startswith("repro_torch.") \
                and mod != __name__:
            outer = f"{mod.rsplit('.', 1)[-1]}.{f.f_code.co_name}"
        f = f.f_back
    node = torch._C._current_autograd_node()
    if node is None:
        return outer or "-"
    found = _MODEL_FRAME.findall("".join(node.metadata.get("traceback_", ())))
    where = f" {found[-1][0]}.{found[-1][1]}" if found else ""
    return f"bwd:{node.name()}{where}"


class Counter(TorchDispatchMode):
    """Counts the ops dispatched while it is active (see the module's
    docstring).  With `rows`, also keeps one row per (op, input shapes,
    model function): [times run, flops, bytes, collective bytes]."""

    def __init__(self, rows: bool = False):
        super().__init__()
        self.flops = 0.0
        self.hbm = 0.0
        self.coll = defaultdict(float)
        self.kernels: dict = {}
        self.rows = {} if rows else None
        self._suspended = 0
        self._prev = []            # the kernel ops' counters it replaced

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented        # DTensor runs the local ops
        if func._overloadpacket not in flop_registry and \
                torch._C._dispatch_has_kernel_for_dispatch_key(
                    func.name(), torch._C.DispatchKey.CompositeImplicitAutograd):
            # a composite op (matmul, to, einsum; they reach this mode
            # whole under inference_mode): count the ops it runs
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        if self._suspended or _is_fake(types):
            return out
        fl = 0.0
        packet = func._overloadpacket
        if packet in flop_registry:
            fl = float(flop_registry[packet](*args, **kwargs, out_val=out))
        nb = _op_bytes(func, args, kwargs, out)
        cb = 0.0
        ns = func.namespace
        if ns in ("_c10d_functional", "c10d_functional", "_dtensor"):
            kind = _COLL_KIND.get(func._schema.name.split("::")[-1])
            if kind is not None:
                cb = float(sum(_nbytes(t) for t in tree_leaves(out)
                               if isinstance(t, torch.Tensor)))
                self.coll[kind] += cb
        self.flops += fl
        self.hbm += nb
        if self.rows is not None:
            shapes = tuple(tuple(t.shape) for t in tree_leaves(args)
                           if isinstance(t, torch.Tensor))
            self._row((str(packet), shapes, _model_tag()), fl, nb, cb)
        return out

    def _row(self, key, fl, nb, cb):
        r = self.rows.setdefault(key, [0, 0.0, 0.0, 0.0])
        r[0] += 1
        r[1] += fl
        r[2] += nb
        r[3] += cb

    def record_kernel(self, name: str, c: "cost.Cost"):
        k = self.kernels.setdefault(name, {"calls": 0, "flops": 0.0,
                                           "bytes": 0.0})
        k["calls"] += 1
        k["flops"] += c.flops
        k["bytes"] += c.nbytes
        self.flops += c.flops
        self.hbm += c.nbytes
        if self.rows is not None:
            self._row((f"kernel:{name}", (), _model_tag()), c.flops,
                      c.nbytes, 0.0)

    @contextlib.contextmanager
    def suspended(self):
        """Within: ops run but are not counted (a kernel op's insides)."""
        self._suspended += 1
        try:
            yield
        finally:
            self._suspended -= 1

    def __enter__(self):
        self._prev.append(cost.set_active(self))
        return super().__enter__()

    def __exit__(self, *exc):
        cost.set_active(self._prev.pop())
        return super().__exit__(*exc)

    def report(self) -> dict:
        """The reference's keys: flops, hbm_bytes, collectives (by kind,
        with total and total_bf16_corrected), trip_counts; and the kernel
        ops' calls, flops and bytes."""
        coll = {k: int(v) for k, v in self.coll.items()}
        coll["total"] = sum(coll.values())
        coll["total_bf16_corrected"] = coll["total"]
        return {"flops": self.flops, "hbm_bytes": self.hbm,
                "collectives": coll, "trip_counts": {},
                "kernels": {k: dict(v) for k, v in self.kernels.items()}}


def analyze(fn, *args, **kw) -> dict:
    """Runs fn(*args, **kw) under a `Counter`; returns its `report()`."""
    with Counter() as c:
        fn(*args, **kw)
    return c.report()


def roofline_terms(flops: float, hbm_bytes: float, coll_bytes: float,
                   n_chips: int, *, peak_flops: float, hbm_bw: float,
                   ici_bw: float) -> dict:
    """Three roofline terms in seconds (all inputs per-device)."""
    compute_t = flops / peak_flops
    memory_t = hbm_bytes / hbm_bw
    coll_t = coll_bytes / ici_bw
    dom = max(("compute", compute_t), ("memory", memory_t),
              ("collective", coll_t), key=lambda kv: kv[1])
    return {"compute_s": compute_t, "memory_s": memory_t,
            "collective_s": coll_t, "bottleneck": dom[0]}
