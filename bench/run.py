"""Run one cell of the benchmark once and print its result line.

    python3 bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cell's configuration, traffic mix,
limits and per-layer metrics are files under bench/, found by the names in
BENCHMARK.json.  Set-up (kernel builds from the checkout's cache, the
weights drawn on the card from the seed, warm-up of the cell's shapes)
counts as `setup_s`; then the window measures for --seconds; then the
served tokens of a sample of the requests are judged against the plain fp32
reference.  --trace 1 profiles the window and reports the per-layer
metrics instead of the end-to-end ones.  The last stdout line is the
result as JSON; the numbers compared, each beside its limit, are the last
lines of stderr and the result's last key."""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def cache_dirs(root: Path):
    """Every build and kernel cache inside the checkout, at fixed paths:
    the program's nvcc builds go to build/kernels/ by themselves."""
    os.environ["TORCH_EXTENSIONS_DIR"] = str(root / "build" / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(root / "build" / "triton")
    os.environ["USE_FLAX"] = "0"


def loaded_forbidden() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & FORBIDDEN)


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e!r})"


def result_line(cell, fields, record, numbers, traced, device_name,
                count) -> dict:
    from bench.harness import spec
    limits = cell.limits
    checks = {k: {"value": v, "limit": limits[k]} for k, v in numbers.items()}
    correct = (fields["failed"] == 0
               and all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                       for c in checks.values()))
    metrics = {}
    if traced:
        from types import SimpleNamespace
        run = SimpleNamespace(**record)
        for m in cell.per_layer:
            v = spec.reader(m["name"])(run)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": fields["e2e"][m["name"]],
                                  "unit": m["unit"]}
    device = {"platform": "gpu", "kind": device_name, "count": count,
              "memory_peak_bytes": fields["memory_peak_bytes"]}
    out = {"correct": correct, "attempted": fields["attempted"],
           "failed": fields["failed"], "metrics": metrics, "device": device}
    tr = record.get("trace")
    if traced and tr is not None:
        device["busy_s"] = tr.busy_s()
        device["window_s"] = record["span_s"]
        out["breakdown"] = {"device_ops": tr.top_ops(),
                            "idle_gaps": tr.idle_gaps()}
    out["checks"] = checks
    return finite(out)


def finite(x):
    """`x` with every number that is not finite (a gap with nothing to
    compare) written as null, so that the line stays JSON."""
    if isinstance(x, dict):
        return {k: finite(v) for k, v in x.items()}
    if isinstance(x, list):
        return [finite(v) for v in x]
    if isinstance(x, float) and not math.isfinite(x):
        return None
    return x


def main(argv=None) -> int:
    args = parse_args(argv)
    cache_dirs(ROOT)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    from bench.harness import spec
    cell = spec.load(args.workload, ROOT)
    chips = cell.workload["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"[bench] needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    name = torch.cuda.get_device_name(0)
    print(f"[setup] interpreter, torch and the card: "
          f"{time.perf_counter() - T_START:.3f} s", file=sys.stderr)
    print(f"[bench] {args.workload} seed {args.seed} on {name}; "
          f"{power_limit()}; peaks bf16 989 TFLOP/s, HBM 3.35 TB/s "
          f"(data sheet, 700 W)", file=sys.stderr, flush=True)
    from bench.harness import serve
    fields, record, numbers = serve.run(cell, args.seed, args.seconds,
                                        bool(args.trace), "cuda", T_START)
    bad = loaded_forbidden()
    if bad:
        print(f"[bench] loaded in this process: {bad}; the benchmark runs "
              f"the PyTorch port alone", file=sys.stderr)
        return 3
    out = result_line(cell, fields, record, numbers, bool(args.trace), name,
                      chips)
    for k, c in out["checks"].items():
        print(f"[check] {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
