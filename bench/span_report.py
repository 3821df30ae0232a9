"""The card's time by the program's own spans, for one serving cell.

    python3 bench/span_report.py --workload <name> --seed <n> --seconds <s>

from the root of a checkout, on a card.  Sets the cell up as bench/run.py
does, then serves it for --seconds under a profiler that records every
thread: the engine's worker thread launches the model, and the profiler of
`bench/run.py --trace 1` records only the thread that starts it, so none of
the program's spans reach that trace.  Prints one JSON line: the device
seconds under each program span (by the innermost, and by serving phase and
innermost), the share of the device time launched inside a named span, the
decode step's attention and FFN against `serve_step.decode_ms`, the device
operations under decode's attention, the front door's queue wait and the
engine's turnaround from the engine's SPAN events, the idle gaps inside
`serve.execute` named after the program span open at their middle, and the
fit of the program's clock to the trace's."""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
GAP_S = 1e-3          # the idle gaps named: those longer than this
PHASES = ("serve_step.cache_init", "serve_step.prefill", "serve_step.decode")


def start():
    """A running profiler of the device and of the program's ranges on
    every thread.  On the host it records user ranges alone
    (`RecordScope.USER_SCOPE`, which `torch.profiler` does not offer, so
    its call to `_enable_profiler` is given the scope while it starts):
    recording every operator of the worker thread too slows the decode
    step by a quarter."""
    import torch.autograd.profiler as ap
    from torch._C._profiler import RecordScope, _ExperimentalConfig
    from torch.profiler import ProfilerActivity, profile
    enable = ap._enable_profiler

    def user_scope(config, activities, scopes=None):
        return enable(config, activities, {RecordScope.USER_SCOPE})

    ap._enable_profiler = user_scope
    try:
        prof = profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA],
                       experimental_config=_ExperimentalConfig(
                           profile_all_threads=True))
        prof.start()
    finally:
        ap._enable_profiler = enable
    return prof


def by_phase(st) -> dict:
    """Device seconds by serving phase and innermost span."""
    out = {}
    for p, s in st.by_path.items():
        phase = next((n for n in p if n in PHASES), "")
        key = f"{phase}/{p[-1] if p else ''}"
        out[key] = out.get(key, 0.0) + s
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def execute_gaps(trace, ranges: list) -> list:
    """The device's idle gaps longer than GAP_S whose middle lies inside a
    `serve.execute` range, each with the path of the program ranges ((t0,
    t1, name)) open at its middle, longest first."""
    from bench.harness import spans
    iv = trace.intervals()
    gaps = sorted(((b[0] - a[1], (a[1] + b[0]) // 2)
                   for a, b in zip(iv, iv[1:])
                   if (b[0] - a[1]) * 1e-9 > GAP_S), key=lambda g: g[1])
    named = spans.paths(ranges, [mid for _, mid in gaps])
    out = [[list(p), length * 1e-9] for (length, _), p in zip(gaps, named)
           if "serve.execute" in p]
    return sorted(out, key=lambda g: -g[1])


def report(events, trace, span_events, formed, batches) -> dict:
    """The line's numbers from a stopped profiler's raw events, its Trace,
    and the engine's SPAN events, BATCH_FORMED times and the serving
    step's timings of the same window."""
    from bench.harness import spans
    st = spans.from_events(events)
    steps = st.counts.get("serve_step.decode", 0)
    decode_s = sum(b["decode_s"] for b in batches)
    n_steps = sum(b["steps"] for b in batches)
    ranges = [(e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
              for e in events if spans.kind(e) == "user_annotation"
              and spans.is_program(e.name())]
    _, dist = spans.fit_clock(
        [e for e in span_events if e.extra["name"].startswith("serve.")],
        [r for r in ranges if r[2].startswith("serve.")])
    per_step = (lambda *names: st.under("serve_step.decode", *names)
                / steps * 1e3 if steps else None)
    return {
        "device_s": st.total_s, "named_share": st.named_share(),
        "by_innermost": st.innermost(), "by_phase": by_phase(st),
        "counts": st.counts, "decode_steps": steps,
        "serve_step.decode_ms": decode_s / n_steps * 1e3 if n_steps else None,
        "decode_device_ms": per_step(),
        "serve_step.decode_attention_ms": per_step("attention.core"),
        "serve_step.decode_ffn_ms": per_step("block.ffn"),
        "decode_attention_ops": st.top_ops("serve_step.decode",
                                           "attention.core"),
        "frontend.queue_wait_ms": spans.queue_wait_ms(span_events),
        "engine.turnaround_ms": spans.turnaround_ms(span_events, formed),
        "clock_fit_us": {"median": dist[len(dist) // 2] * 1e6,
                         "p95": dist[int(0.95 * (len(dist) - 1))] * 1e6,
                         "max": dist[-1] * 1e6},
        "execute_gaps": execute_gaps(trace, ranges),
        "idle_gaps": trace.idle_gaps(), "busy_s": trace.busy_s(),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from bench import run as bench_run
    bench_run.cache_dirs(ROOT)
    import torch

    from bench.harness import serve, spec
    from bench.harness import trace as tracing
    from repro_torch.core.engine.model import BATCH_FORMED, SPAN
    if not torch.cuda.is_available():
        print("[span_report] needs a CUDA device", file=sys.stderr)
        return 2
    cell = spec.load(args.workload, ROOT)
    print(f"[span_report] {args.workload} seed {args.seed} on "
          f"{torch.cuda.get_device_name(0)}; {bench_run.power_limit()}",
          file=sys.stderr, flush=True)
    sess = serve.Session(cell, args.seed, "cuda")
    tracer = sess.client.engine.tracer
    prof, opened = [], []
    sess.run_window(args.seconds, on_open=lambda: (
        opened.append(time.perf_counter()), prof.append(start())))
    torch.cuda.synchronize()
    closed = time.perf_counter()
    prof[0].stop()
    events = list(prof[0].profiler.kineto_results.events())
    trace = tracing.collect(prof[0])
    t0 = opened[0]
    span_events = [e for e in tracer.of(SPAN)
                   if e.extra["t0"] >= t0 and e.t <= closed]
    formed = [e.t for e in tracer.of(BATCH_FORMED) if t0 <= e.t <= closed]
    batches = list(sess.batches)
    sess.close()
    out = report(events, trace, span_events, formed, batches)
    out["window_s"] = closed - t0
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
