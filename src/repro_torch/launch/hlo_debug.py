"""Contributor dump: count one dry-run cell and print its top ops by
FLOPs, bytes or collective bytes, each with how many times the (op, input
shapes) pair ran and the innermost `repro_torch.models` function it ran in
(the reference tags its rows with XLA's op_name).  It runs on the CPU.

    PYTHONPATH=src python -m repro_torch.launch.hlo_debug --arch gemma2-2b \
        --shape decode_32k --kind collective --top 20
"""
from __future__ import annotations

import argparse

import torch.distributed as dist

from repro_torch.configs import RunConfig
from repro_torch.launch import dryrun as dr
from repro_torch.launch.hlo_analysis import Counter
from repro_torch.models.common import Options

_COL = {"flops": 1, "bytes": 2, "collective": 3}


def dump(counter: Counter, kind: str = "bytes", top: int = 20) -> list:
    """Prints the `top` rows of `counter` (a `Counter(rows=True)`) by
    `kind` and their total; returns the rows printed."""
    col = _COL[kind]
    rows = sorted(((v[col], v[0], op, shapes, tag)
                   for (op, shapes, tag), v in counter.rows.items()
                   if v[col]), reverse=True)
    unit = {"bytes": 1e9, "collective": 1e9, "flops": 1e12}[kind]
    suf = {"bytes": "GB", "collective": "GB", "flops": "TF"}[kind]
    for r in rows[:top]:
        shapes = " ".join("x".join(map(str, s)) for s in r[3])[:40]
        print(f"{r[0]/unit:10.4f}{suf} x{r[1]:6d} {r[2][:30]:30s} "
              f"{shapes:40s} {r[4]}")
    print(f"total: {sum(r[0] for r in rows)/unit:.4f}{suf}")
    return rows[:top]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--kind", default="bytes",
                    choices=["bytes", "flops", "collective"])
    ap.add_argument("--top", type=int, default=20)
    # pass-through knobs
    ap.add_argument("--remat", default="none")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--probs-bf16", action="store_true")
    ap.add_argument("--shard-params-2d", action="store_true")
    ap.add_argument("--param-dtype", default="float32")
    ap.add_argument("--seq-shard-kv", action="store_true")
    ap.add_argument("--grad-compress", default="none")
    args = ap.parse_args(argv)

    rc = RunConfig(remat=args.remat, microbatches=args.microbatches,
                   param_dtype=args.param_dtype,
                   grad_compress=args.grad_compress,
                   seq_shard_kv=args.seq_shard_kv,
                   shard_params_2d=args.shard_params_2d)
    opts = Options(remat=args.remat, probs_bf16=args.probs_bf16)
    counter = Counter(rows=True)
    dr.start_fake_group(256)
    try:
        dr.lower_cell(args.arch, args.shape, False, rc, opts,
                      counter=counter)
    finally:
        dist.destroy_process_group()
    dump(counter, args.kind, args.top)


if __name__ == "__main__":
    main()
