"""`python -m repro_torch.core.obs.explain <trace>` — explain a recorded run
(the port's copy of the JAX package's `repro.core.obs.explain`).

Loads a trace saved with `TraceRecorder.save()` (the JSONL format
`examples/obs_demo.py --trace-log` and `Client.report().trace.save()`
produce), runs the critical-path analyzer, and prints the explanation:
the makespan decomposition, concurrency vs the METG-law ideal, idle
gaps, stragglers, and the per-stage table for every task on the path.

    python -m repro_torch.core.obs.explain run.jsonl
    python -m repro_torch.core.obs.explain run.jsonl --json       # raw summary
    python -m repro_torch.core.obs.explain run.jsonl --chrome out.trace.json

`render()` is importable: the same text view for any
`CriticalPathReport`, whatever built it.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Optional

from repro_torch.core.engine.tracing import TraceRecorder
from repro_torch.core.obs.critical_path import CriticalPathReport


def _ms(s: float) -> str:
    return f"{s * 1e3:.3f}ms"


def render(rep: CriticalPathReport, *, max_tasks: int = 20) -> str:
    """Human-readable explanation of a `CriticalPathReport`."""
    if not rep.path:
        return ("no completed tasks in the trace — nothing to explain "
                f"(events emitted: {rep.n_emitted}, dropped: {rep.dropped})")
    mk = rep.makespan_s
    pct = (lambda x: f"{100.0 * x / mk:.1f}%") if mk > 0 else (lambda x: "—")
    lines = [
        f"critical path: {len(rep.path)} of {rep.n_tasks} tasks gate the "
        f"{_ms(mk)} makespan (trace span {_ms(rep.wall_s)})",
        f"  compute   {_ms(rep.compute_s):>12}  {pct(rep.compute_s):>7}"
        "   (critical-path run time)",
        f"  scheduler {_ms(rep.sched_s):>12}  {pct(rep.sched_s):>7}"
        f"   dep-wait {_ms(rep.dep_wait_s)}"
        f" | queue {_ms(rep.queue_s)}"
        f" | dispatch {_ms(rep.dispatch_s)}"
        f" | notify {_ms(rep.notify_s)}",
    ]
    if rep.wasted_s > 0:
        lines.append(f"  wasted    {_ms(rep.wasted_s):>12}"
                     "           (requeued/retried episodes on the path)")
    ideal = rep.metg_ideal_workers
    conc = (f"  concurrency: mean {rep.concurrency_mean:.2f}, "
            f"peak {rep.concurrency_peak}, pool {rep.workers}")
    if ideal is not None:
        conc += f", METG-law ideal ~{ideal:.1f}"
    if rep.parallel_efficiency is not None:
        conc += f"  ->  parallel efficiency {rep.parallel_efficiency:.0%}"
    lines.append(conc)
    if rep.idle_s > 0:
        gaps = ", ".join(f"{_ms(d)} @ t={t:.3f}s"
                         for t, d in rep.idle_gaps[:3])
        lines.append(f"  idle gaps: {_ms(rep.idle_s)} total ({pct(rep.idle_s)}"
                     f" of makespan) — longest: {gaps}")
    if rep.n_rpc:
        lines.append(f"  rpc: {rep.n_rpc} round-trips, "
                     f"{_ms(rep.rpc_s)} total, "
                     f"mean rtt {rep.rtt_mean_s * 1e6:.1f}us")
        tops = sorted(rep.rpc_by_op.items(), key=lambda kv: -kv[1][1])[:4]
        lines.append("       by op: " + "  ".join(
            f"{op} x{cnt} {_ms(tot)}" for op, (cnt, tot) in tops))
    if rep.n_xfer:
        by = "  ".join(f"{p} x{n} {b / 1024:.0f}KiB {_ms(t)}"
                       for p, (n, b, t) in rep.xfer_by_path.items())
        lines.append(f"  data motion: {rep.n_xfer} fetches, "
                     f"{rep.xfer_bytes / 1024:.0f}KiB, "
                     f"{_ms(rep.xfer_s)} total "
                     f"({_ms(rep.path_xfer_s)} on the path) — {by}")
        lines.append(f"       verdict: the run was {rep.xfer_verdict} "
                     + ("(moving bytes gated the path more than "
                        "scheduling did)" if rep.xfer_verdict
                        == "transfer-bound" else
                        "(scheduling gated the path more than moving "
                        "bytes did)"))
    for s in rep.stragglers:
        mark = "  << ON THE CRITICAL PATH" if s["on_path"] else ""
        lines.append(f"  straggler: {s['task']} ran {_ms(s['run_s'])} "
                     f"({s['ratio']}x the median) on {s['worker']}{mark}")
    lines.append("")
    lines.append(f"  {'#':>3} {'task':<28}{'worker':<8}"
                 f"{'dep-wait':>10}{'queue':>10}{'dispatch':>10}"
                 f"{'run':>10}{'notify':>10}{'xfer':>10}  notes")
    segs = rep.segments
    skipped = 0
    if len(segs) > max_tasks:
        skipped = len(segs) - max_tasks
        segs = segs[-max_tasks:]
    base = skipped
    if skipped:
        lines.append(f"  ... {skipped} earlier path tasks elided ...")
    for i, row in enumerate(segs):
        notes = []
        if row["n_runs"] > 1:
            notes.append(f"{row['n_runs']} runs "
                         f"(wasted {_ms(row.get('wasted_s', 0.0))})")
        if row["retries"]:
            notes.append(f"{row['retries']} retries")
        if row.get("xfer_bytes"):
            notes.append(f"{row['xfer_bytes'] / 1024:.0f}KiB fetched")
        xfer = _ms(row["xfer_s"]) if "xfer_s" in row else "—"
        lines.append(
            f"  {base + i + 1:>3} {str(row['task'])[:27]:<28}"
            f"{str(row['worker'] or '—')[:7]:<8}"
            f"{_ms(row['dep_wait_s']):>10}{_ms(row['queue_s']):>10}"
            f"{_ms(row['dispatch_s']):>10}{_ms(row['run_s']):>10}"
            f"{_ms(row['notify_s']):>10}{xfer:>10}  {', '.join(notes)}")
    return "\n".join(lines)


def main(argv: Optional[list] = None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.core.obs.explain",
        description="critical-path explanation of a saved engine trace")
    p.add_argument("trace", help="JSONL trace file (TraceRecorder.save)")
    p.add_argument("--workers", type=int, default=1,
                   help="pool size the run used (default %(default)s)")
    p.add_argument("--scheduler", default="dwork",
                   choices=("dwork", "pmake", "mpi-list"),
                   help="METG law for the ideal-parallelism comparison")
    p.add_argument("--steal-n", type=int, default=1)
    p.add_argument("--shards", type=int, default=1)
    p.add_argument("--json", action="store_true",
                   help="print the raw summary() JSON instead of text")
    p.add_argument("--max-tasks", type=int, default=20,
                   help="path rows to print (default %(default)s)")
    p.add_argument("--chrome", metavar="PATH",
                   help="also export a Chrome trace with the critical "
                        "path highlighted (flow arrows + lane)")
    args = p.parse_args(argv)
    trace = TraceRecorder.load(args.trace)
    rep = CriticalPathReport.from_trace(
        trace, workers=args.workers, scheduler=args.scheduler,
        steal_n=args.steal_n, shards=args.shards)
    if args.chrome:
        trace.to_chrome_trace(args.chrome, critical_path=rep.path)
    if args.json:
        print(json.dumps(rep.summary(max_tasks=args.max_tasks), indent=2))
    else:
        print(render(rep, max_tasks=args.max_tasks))
    return 0


if __name__ == "__main__":
    sys.exit(main())
