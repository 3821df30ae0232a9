"""Readings that set a serving cell's limit, a JSON line a seed.

On each seed, the widest logit gap of the program's served tokens
and of the tokens that the control (the fp32 reference with every linear
layer's operands rounded to float8 e4m3) puts first at the same positions,
both against the fp32 reference.  One process serves every seed at the
cell's own load for a short window, the kernels built and the front door
set up once.  The lower reading is the program's largest gap, the upper
the control's smallest.

    python3 bench/control.py --workload <name> --seeds 1,2,3 --seconds 15
"""
import argparse
import json
import sys
import time
from pathlib import Path

T_START = time.perf_counter()
ROOT = Path(__file__).resolve().parents[1]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=15.0)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from bench.harness import serve, spec
    from bench.run import cache_dirs
    cache_dirs(ROOT)
    cell = spec.load(args.workload, ROOT)
    seeds = [int(s) for s in args.seeds.split(",")]
    sess = serve.Session(cell, seeds[0], "cuda")
    rows = []
    for seed in seeds:
        if seed != sess.seed:
            sess.reseed(seed)
        win = sess.run_window(args.seconds)
        done = serve.finished(win)
        picked = serve.sample(done, seed, cell.traffic["check_requests"])
        sess.drop_program()
        g = serve.gaps(sess, picked, control=True)
        row = {"seed": seed, "answered": len(done), **g}
        rows.append(row)
        print(json.dumps(row), flush=True)
    sess.close()
    lower = max(r["max_logit_gap"] for r in rows)
    upper = min(r["control_max_logit_gap"] for r in rows)
    print(json.dumps({"workload": args.workload, "seeds": len(rows),
                      "lower": lower, "upper": upper,
                      "limit": cell.limits["max_logit_gap"],
                      "seconds": time.perf_counter() - T_START}), flush=True)


if __name__ == "__main__":
    main()
