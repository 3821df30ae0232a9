"""Production-mesh dry run: one (arch, shape) cell counted per device.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma2-2b \
        --shape decode_32k [--multi-pod]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--meshes pod]

It runs on the CPU and needs no card.  A fake process group of 256 ranks
(512 with --multi-pod) stands behind a `DeviceMesh` of the reference's
shape, (data=16, model=16) or (pod=2, data=16, model=16).  The params, the
optimizer state, the batch and the cache are made on the meta device (no
storage) and placed on that mesh as DTensors by the leaf-name rules of
`runtime.sharding`.  The train step, the prefill or the decode step then
runs once under `mesh_context` and `launch.hlo_analysis`'s counter, which
counts each device's FLOPs, HBM bytes and collective bytes from the ops
DTensor runs on the local shards; the roofline terms divide them by the
H100 constants of `launch.mesh`.  These are counts over data-sheet rates,
not times measured on a card.

Each cell's record goes to build/dryrun/<arch>__<shape>__<mesh>.json, with
the reference's keys; a cell that fails is written with "ok": false and
its error.  --all runs each cell in a subprocess, since a process group is
per process.  --reduced, --mesh-shape, --seq-len and --global-batch cut a
cell to a size the tests run.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import torch
import torch.distributed as dist

from repro_torch.configs import (ARCH_IDS, SHAPES, RunConfig, ShapeConfig,
                                 applicable_shapes, get_config, input_specs)
from repro_torch.launch.hlo_analysis import Counter, roofline_terms
from repro_torch.launch.mesh import (HBM_BW, ICI_BW, PEAK_FLOPS_BF16,
                                     make_production_mesh)
from repro_torch.models.common import (Options, mesh_context, param_count,
                                       tree_leaves, tree_map)
from repro_torch.models.model import build_model
from repro_torch.optim.adamw import OptState, init_opt
from repro_torch.runtime.sharding import (P, batch_specs, cache_specs,
                                          distribute, logical_rules,
                                          opt_state_specs, param_specs,
                                          param_specs_2d)
from repro_torch.runtime.serve_step import make_decode_step, make_prefill_step
from repro_torch.runtime.train_step import make_train_step

RESULTS_DIR = Path(__file__).resolve().parents[3] / "build" / "dryrun"


def model_flops(cfg, shape) -> float:
    """6·N_active·D (training) or 2·N_active·D (fwd-only) useful-FLOPs model."""
    model = build_model(cfg)
    n = param_count(model.init(torch.Generator(), "meta"))
    if cfg.moe is not None:
        m = cfg.moe
        expert_params = (cfg.n_layers - m.first_dense_layers) * m.n_experts \
            * 3 * cfg.d_model * m.d_expert
        active = n - expert_params + expert_params * m.top_k / m.n_experts
    else:
        active = n
    # embedding rows don't multiply
    active -= cfg.padded_vocab * cfg.d_model
    if shape.mode == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * active * tokens
    if shape.mode == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * active * tokens
    return 2.0 * active * shape.global_batch        # decode: one token/seq


def start_fake_group(world_size: int):
    """A process group of `world_size` ranks in this one process, this
    process rank 0, whose collectives move no data.  The "fake" backend
    lives in `torch.testing._internal`, PyTorch's own test package, not a
    public API; only this function imports it."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)


@contextlib.contextmanager
def _alltoall_as_on_a_card_mesh():
    """Within: DTensor moves a split from one dim to another with its
    all-to-all op, as it does on a mesh of cards.  On a CPU mesh it
    all-gathers instead and keeps its chunk (gloo has no all-to-all), which
    moves n times the bytes over n devices.  The fake group runs the op as
    it runs every collective, without moving data."""
    from torch.distributed.tensor import placement_types

    def alltoall(x, gather_dim, shard_dim, mesh, mesh_dim):
        return torch.ops._dtensor.shard_dim_alltoall(
            x, gather_dim, shard_dim, mesh.get_group(mesh_dim).group_name)

    # raises AttributeError where torch no longer routes the move through
    # this name, rather than patching a name nothing reads
    cpu_path = getattr(placement_types, "shard_dim_alltoall")
    placement_types.shard_dim_alltoall = alltoall
    try:
        yield
    finally:
        placement_types.shard_dim_alltoall = cpu_path


def _local_bytes(tree) -> int:
    """Bytes of the local shards of a tree's tensors (one device's)."""
    n = 0
    for x in tree_leaves(tree):
        if isinstance(x, torch.Tensor):
            loc = x.to_local() if hasattr(x, "to_local") else x
            n += loc.numel() * loc.element_size()
    return n


def _mesh_name(mesh) -> str:
    return "x".join(str(s) for s in mesh.shape)


def lower_cell(arch: str, shape_name: str, multi_pod: bool, rc: RunConfig,
               opts: Options, *, cfg=None, shape=None, mesh=None,
               counter: Counter = None) -> dict:
    """Counts one cell on the production mesh (or `mesh`, over a group the
    caller has started), for `get_config(arch)` at `SHAPES[shape_name]`
    (or `cfg` at `shape`), with `counter` (a fresh `Counter` unless
    given).  Returns the record."""
    from torch.distributed.tensor.experimental import implicit_replication
    cfg = cfg or get_config(arch)
    shape = shape or SHAPES[shape_name]
    mesh = mesh or make_production_mesh(multi_pod=multi_pod)
    n_chips = mesh.size()
    model = build_model(cfg, opts)
    rules = logical_rules(mesh, global_batch=shape.global_batch,
                          seq_shard_kv=rc.seq_shard_kv,
                          shard_params_2d=rc.shard_params_2d)

    t0 = time.time()
    params = model.init(torch.Generator(), "meta")
    if rc.param_dtype != "float32":
        pd = getattr(torch, rc.param_dtype)
        params = tree_map(lambda x: x.to(pd) if x.is_floating_point() else x,
                          params)
    pspecs = param_specs(params, cfg)
    if rc.shard_params_2d:
        pspecs = param_specs_2d(pspecs, params, mesh)
    batch = distribute(input_specs(cfg, shape), mesh,
                       batch_specs(cfg, shape, mesh))
    args = [distribute(params, mesh, pspecs)]
    if shape.mode == "train":
        opt = init_opt(params, rc)
        ospecs = opt_state_specs(pspecs, params, mesh, rc.zero1)
        args += [distribute(opt, mesh, OptState(P(), ospecs, ospecs)),
                 batch]
        step = make_train_step(model, rc)
    else:
        cache = None
        if shape.mode == "decode" or cfg.family != "ssm":
            # the port's prefill writes into a preallocated cache
            cache = model.init_cache(shape.global_batch, shape.seq_len,
                                     device="meta")
            cache = distribute(cache, mesh, cache_specs(
                cfg, cache, mesh, global_batch=shape.global_batch,
                seq_shard_kv=rc.seq_shard_kv))
        if shape.mode == "prefill":
            step = make_prefill_step(model)
            args += [batch, cache]
        else:
            step = make_decode_step(model)
            args += [batch["tokens"], batch["positions"], cache]
    t_lower = time.time() - t0

    t0 = time.time()
    counter = counter or Counter()
    with mesh_context(mesh, rules), implicit_replication(), \
            _alltoall_as_on_a_card_mesh(), counter:
        out = step(*args)
    t_run = time.time() - t0
    ana = counter.report()
    coll = ana["collectives"]
    flops = float(ana["flops"])
    hbm = float(ana["hbm_bytes"])
    terms = roofline_terms(flops, hbm, coll["total_bf16_corrected"],
                           n_chips, peak_flops=PEAK_FLOPS_BF16,
                           hbm_bw=HBM_BW, ici_bw=ICI_BW)
    terms["collective_uncorrected_s"] = coll["total"] / ICI_BW
    mf = model_flops(cfg, shape)
    return {
        "arch": arch, "shape": shape.name, "mesh": _mesh_name(mesh),
        "chips": int(n_chips), "mode": shape.mode, "ok": True,
        # lower_s: making and placing the meta DTensors; compile_s: the
        # counted run of the step (eager dispatch: nothing is compiled)
        "lower_s": round(t_lower, 1), "compile_s": round(t_run, 1),
        "hlo_flops_per_device": flops, "hlo_bytes_per_device": hbm,
        "hlo_flops": flops * n_chips, "hlo_bytes": hbm * n_chips,
        # no XLA cost analysis: eager dispatch counts every loop trip
        "xla_cost_flops_per_device_loops_once": None,
        "xla_cost_bytes_per_device_loops_once": None,
        "collective_bytes": coll,
        "kernels": ana["kernels"],
        "memory": {
            "argument_bytes_per_device": _local_bytes(args),
            "output_bytes_per_device": _local_bytes(out),
            # no compiler memory analysis
            "temp_bytes_per_device": None,
            "code_bytes": None,
        },
        "roofline": terms,
        "model_flops": mf,
        "useful_flops_ratio": (mf / (flops * n_chips)) if flops else None,
        "rc": {"remat": rc.remat, "microbatches": rc.microbatches,
               "zero1": rc.zero1, "param_dtype": rc.param_dtype,
               "seq_shard_kv": rc.seq_shard_kv,
               "grad_compress": rc.grad_compress},
        # the reference's two knobs, as the port always runs: the kernel
        # and its plain version skip the tiles outside the band, and there
        # is no fused cross-entropy
        "opts": {"q_block": opts.q_block, "kv_block": opts.kv_block,
                 "skip_masked_blocks": True, "fused_xent": False,
                 "mla_absorb": opts.mla_absorb, "moe_group": opts.moe_group,
                 "probs_bf16": opts.probs_bf16,
                 "shard_params_2d": rc.shard_params_2d},
    }


def cell_filename(arch, shape_name, mesh_name, tag="", out_dir=None):
    t = f"__{tag}" if tag else ""
    return Path(out_dir or RESULTS_DIR) / \
        f"{arch}__{shape_name}__{mesh_name}{t}.json"


def _mesh_shape(args) -> tuple:
    if args.mesh_shape:
        return tuple(int(s) for s in args.mesh_shape.split("x"))
    return (2, 16, 16) if args.multi_pod else (16, 16)


def lower_from_args(args, counter: Counter = None) -> dict:
    """Starts the fake group, counts the one cell the command line names
    (with `counter`, a fresh `Counter` unless given) and destroys the
    group; returns the record."""
    rc = RunConfig(remat=args.remat, microbatches=args.microbatches,
                   zero1=not args.no_zero1, param_dtype=args.param_dtype,
                   seq_shard_kv=args.seq_shard_kv,
                   grad_compress=args.grad_compress,
                   adam_state_dtype=args.adam_state_dtype,
                   shard_params_2d=args.shard_params_2d)
    opts = Options(q_block=args.q_block, kv_block=args.kv_block,
                   mla_absorb=args.mla_absorb, moe_group=args.moe_group,
                   remat=args.remat, probs_bf16=args.probs_bf16)
    dims = _mesh_shape(args)
    start_fake_group(math.prod(dims))
    try:
        cfg = get_config(args.arch)
        if args.reduced:
            cfg = cfg.reduced()
        sh = SHAPES[args.shape]
        if args.seq_len or args.global_batch:
            sh = ShapeConfig(sh.name, args.seq_len or sh.seq_len,
                             args.global_batch or sh.global_batch, sh.mode)
        mesh = None
        if args.mesh_shape:
            from torch.distributed.device_mesh import init_device_mesh
            names = (("pod", "data", "model") if len(dims) == 3
                     else ("data", "model"))
            mesh = init_device_mesh("cpu", dims, mesh_dim_names=names)
        return lower_cell(args.arch, args.shape, args.multi_pod, rc, opts,
                          cfg=cfg, shape=sh, mesh=mesh, counter=counter)
    finally:
        dist.destroy_process_group()


def run_one(args) -> int:
    """Counts the cell, writes its record (with "ok": false and the error
    if it fails)."""
    mesh_name = "x".join(map(str, _mesh_shape(args)))
    out = cell_filename(args.arch, args.shape, mesh_name, args.tag,
                        args.out_dir)
    out.parent.mkdir(parents=True, exist_ok=True)
    t0 = time.time()
    try:
        rec = lower_from_args(args)
    except Exception as e:  # noqa: BLE001 - recorded, not swallowed
        rec = {"arch": args.arch, "shape": args.shape, "mesh": mesh_name,
               "ok": False, "error": f"{type(e).__name__}: {e}",
               "seconds": round(time.time() - t0, 1)}
        out.write_text(json.dumps(rec, indent=1))
        print(json.dumps(rec, indent=1))
        return 1
    rec["seconds"] = round(time.time() - t0, 1)
    if args.reduced:
        rec["reduced"] = True
    out.write_text(json.dumps(rec, indent=1))
    print(json.dumps({k: rec[k] for k in
                      ("arch", "shape", "mesh", "ok", "compile_s", "seconds",
                       "hlo_flops", "roofline", "useful_flops_ratio")},
                     indent=1))
    return 0


def run_all(args) -> int:
    """Spawn one subprocess per cell (a process group is per process)."""
    fails = []
    meshes = [False, True] if args.meshes == "both" else [args.meshes == "multipod"]
    for arch in (args.archs.split(",") if args.archs else ARCH_IDS):
        cfg = get_config(arch)
        for shape_name, status in applicable_shapes(cfg).items():
            if args.shapes and shape_name not in args.shapes.split(","):
                continue
            for mp in meshes:
                out = cell_filename(arch, shape_name,
                                    "2x16x16" if mp else "16x16", args.tag,
                                    args.out_dir)
                if status != "run":
                    out.parent.mkdir(parents=True, exist_ok=True)
                    out.write_text(json.dumps({
                        "arch": arch, "shape": shape_name,
                        "mesh": "2x16x16" if mp else "16x16",
                        "ok": None, "skipped": status}, indent=1))
                    continue
                if out.exists() and not args.force:
                    rec = json.loads(out.read_text())
                    if rec.get("ok"):
                        continue
                mode = SHAPES[shape_name].mode
                # train defaults: full remat + 4 microbatches, as the
                # reference's; serving: none needed.
                remat = args.remat
                mb = args.microbatches
                if mode == "train" and remat == "none" and mb == 1:
                    remat, mb = "full", 4
                cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                       "--arch", arch, "--shape", shape_name,
                       "--remat", remat, "--microbatches", str(mb)]
                if mp:
                    cmd.append("--multi-pod")
                for flag in ("param_dtype", "grad_compress",
                             "adam_state_dtype", "tag", "out_dir"):
                    v = getattr(args, flag)
                    if v:
                        cmd += [f"--{flag.replace('_', '-')}", str(v)]
                for flag in ("q_block", "kv_block", "moe_group"):
                    cmd += [f"--{flag.replace('_', '-')}",
                            str(getattr(args, flag))]
                for flag in ("mla_absorb", "no_zero1", "probs_bf16",
                             "shard_params_2d"):
                    if getattr(args, flag):
                        cmd.append(f"--{flag.replace('_', '-')}")
                if args.seq_shard_kv or shape_name == "long_500k":
                    cmd.append("--seq-shard-kv")
                print("::", " ".join(cmd), flush=True)
                try:
                    r = subprocess.run(cmd, timeout=args.cell_timeout)
                    failed = r.returncode != 0
                except subprocess.TimeoutExpired:
                    out.write_text(json.dumps({
                        "arch": arch, "shape": shape_name,
                        "mesh": "2x16x16" if mp else "16x16", "ok": False,
                        "error": f"timeout after {args.cell_timeout} s",
                        "seconds": args.cell_timeout}, indent=1))
                    failed = True
                if failed:
                    fails.append((arch, shape_name, mp))
    if fails:
        print("FAILED CELLS:", fails)
    return 1 if fails else 0


def cell_parser(description: str) -> argparse.ArgumentParser:
    """The arguments that name one cell and its knobs."""
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("--arch")
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    # cut a cell to a test's size
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--mesh-shape", default="",
                    help="e.g. 2x2 (data x model): over a fake group of "
                         "that many ranks")
    ap.add_argument("--seq-len", type=int, default=0)
    ap.add_argument("--global-batch", type=int, default=0)
    # RunConfig / Options knobs (perf hillclimb levers)
    ap.add_argument("--remat", default="none", choices=["none", "dots", "full"])
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--no-zero1", action="store_true")
    ap.add_argument("--param-dtype", default="float32")
    ap.add_argument("--adam-state-dtype", default="float32")
    ap.add_argument("--grad-compress", default="none")
    ap.add_argument("--seq-shard-kv", action="store_true")
    ap.add_argument("--q-block", type=int, default=1024)
    ap.add_argument("--kv-block", type=int, default=1024)
    ap.add_argument("--moe-group", type=int, default=1024)
    ap.add_argument("--mla-absorb", action="store_true")
    ap.add_argument("--probs-bf16", action="store_true")
    ap.add_argument("--shard-params-2d", action="store_true")
    return ap


def parse_args(argv=None):
    ap = cell_parser("production-mesh dry run")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--archs", default="")
    ap.add_argument("--shapes", default="")
    ap.add_argument("--meshes", default="both",
                    choices=["both", "pod", "multipod"])
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--tag", default="")
    ap.add_argument("--out-dir", default="",
                    help=f"where records go (default {RESULTS_DIR})")
    ap.add_argument("--cell-timeout", type=int, default=3600)
    return ap, ap.parse_args(argv)


def main(argv=None):
    ap, args = parse_args(argv)
    if args.all:
        sys.exit(run_all(args))
    if not args.arch or not args.shape:
        ap.error("--arch and --shape required (or --all)")
    sys.exit(run_one(args))


if __name__ == "__main__":
    main()
