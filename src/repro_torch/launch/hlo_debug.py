"""Contributor dump: count one dry-run cell and print its top ops by
FLOPs, bytes or collective bytes, each with how many times the (op, input
shapes) pair ran and the innermost `repro_torch.models` function it ran in
(the reference tags its rows with XLA's op_name).  It runs on the CPU.

    PYTHONPATH=src python -m repro_torch.launch.hlo_debug --arch gemma2-2b \
        --shape decode_32k --kind collective --top 20

It takes `launch.dryrun`'s arguments for one cell, so a test-sized cell
too: `--reduced --mesh-shape 2x2 --seq-len 32 --global-batch 4`.
"""
from __future__ import annotations

import torch

from repro_torch.launch import dryrun as dr
from repro_torch.launch.hlo_analysis import Counter

_COL = {"flops": 1, "bytes": 2, "collective": 3}


def dump(counter: Counter, kind: str = "bytes", top: int = 20) -> list:
    """Prints the `top` rows of `counter` (a `Counter(rows=True)`) by
    `kind` and their total; returns the rows printed."""
    col = _COL[kind]
    rows = sorted(((v[col], v[0], op, shapes, tag)
                   for (op, shapes, tag), v in counter.rows.items()
                   if v[col]), reverse=True)
    suf = "FLOP" if kind == "flops" else "B"
    for r in rows[:top]:
        shapes = " ".join("x".join(map(str, s)) for s in r[3])[:40]
        print(f"{r[0]:11.4e}{suf} x{r[1]:6d} {r[2][:30]:30s} "
              f"{shapes:40s} {r[4]}")
    print(f"total: {sum(r[0] for r in rows):.4e}{suf}")
    return rows[:top]


def main(argv=None):
    ap = dr.cell_parser("top ops of one dry-run cell")
    ap.add_argument("--kind", default="bytes",
                    choices=["bytes", "flops", "collective"])
    ap.add_argument("--top", type=int, default=20)
    args = ap.parse_args(argv)
    if not args.arch or not args.shape:
        ap.error("--arch and --shape required")
    counter = Counter(rows=True)
    # anomaly mode keeps each backward node's forward stack, which tags
    # the backward's rows; check_nan off: it would add ops
    with torch.autograd.set_detect_anomaly(True, check_nan=False):
        dr.lower_from_args(args, counter)
    dump(counter, args.kind, args.top)


if __name__ == "__main__":
    main()
