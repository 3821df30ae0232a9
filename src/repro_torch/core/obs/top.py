"""`python -m repro_torch.core.obs.top` — a curses-free text dashboard that
polls a `StatsServer`'s `/stats` endpoint and redraws in place (the port's
copy of the JAX package's `repro.core.obs.top`).

    python -m repro_torch.core.obs.top --url http://127.0.0.1:8787
    python -m repro_torch.core.obs.top --url ... --once      # single snapshot

Pure stdlib (urllib + ANSI clear), so it runs anywhere the repo does;
`render()` is importable for tests and for embedding the same view in
other tools.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
import urllib.request
from typing import Optional


def fetch(url: str, timeout: float = 5.0) -> dict:
    """GET <url>/stats and decode the JSON payload."""
    with urllib.request.urlopen(url.rstrip("/") + "/stats",
                                timeout=timeout) as resp:
        return json.loads(resp.read().decode())


def render(stats: dict) -> str:
    """One screenful of dashboard text for a `/stats` payload."""
    eng = stats.get("engine") or {}
    rates = stats.get("rates") or {}
    trace = eng.get("trace") or {}
    rate = rates.get("tasks_per_s")
    window = rates.get("window_s")
    lines = [
        "repro engine — live stats",
        (f"  tasks/s {rate if rate is not None else '—':>10}"
         f"   window {window if window is not None else '—'}s"
         f"   done {eng.get('tasks_done', 0)}"
         f"   failed {eng.get('tasks_failed', 0)}"
         f"   workers {eng.get('live_workers', 0)}"
         f" (deaths {eng.get('worker_deaths', 0)})"),
        (f"  ready depth {eng.get('ready_depth', 0)}"
         f"   per-shard {eng.get('shard_ready_depth', [])}"
         f"   retried {eng.get('tasks_retried', 0)}"
         f"   journal {eng.get('journal_bytes', 0)}B"
         f"   trace emitted {trace.get('n_emitted', 0)}"
         f" dropped {trace.get('dropped', 0)}"),
        "",
    ]
    workers = stats.get("workers") or {}
    # pid/rss columns only when the rows carry them (transport="proc")
    with_pids = any(row.get("pid") for row in workers.values())
    header = f"  {'WORKER':<12}{'DONE':>10}{'BUSY_S':>12}{'BUSY%':>8}"
    if with_pids:
        header += f"{'PID':>8}{'RSS_MB':>9}"
    lines.append(header + "  STATE")
    for w, row in workers.items():
        frac = row.get("busy_frac")
        busy_pct = f"{frac * 100:7.1f}%" if frac is not None else "      —"
        line = (f"  {w:<12}{row.get('done', 0):>10}"
                f"{row.get('busy_s', 0.0):>12.3f}{busy_pct}")
        if with_pids:
            pid = row.get("pid")
            rss = row.get("rss_bytes")
            line += f"{pid if pid else '—':>8}"
            line += (f"{rss / 1e6:>9.1f}" if rss else f"{'—':>9}")
        lines.append(line + "  "
                     + ("live" if row.get("alive", True) else "DEAD"))
    cp = stats.get("critical_path") or {}
    if cp.get("skipped"):
        lines.append("")
        lines.append(f"  critical path: {cp['skipped']}")
    elif cp.get("path"):
        bd = cp.get("breakdown_s") or {}
        conc = cp.get("concurrency") or {}
        ideal = conc.get("ideal_metg")
        eff = conc.get("efficiency")
        lines.append("")
        lines.append(
            f"  critical path: {cp.get('n_tasks_on_path', 0)} of"
            f" {cp.get('n_tasks', 0)} tasks gate"
            f" {cp.get('makespan_s', 0.0):.3f}s"
            f"  sched {cp.get('sched_frac', 0.0) * 100:.1f}%"
            f" (dep-wait {bd.get('dep_wait', 0)}s"
            f" queue {bd.get('queue', 0)}s"
            f" dispatch {bd.get('dispatch', 0)}s"
            f" notify {bd.get('notify', 0)}s)")
        lines.append(
            f"   concurrency mean {conc.get('mean', 0)}"
            f" peak {conc.get('peak', 0)}"
            f" of {cp.get('workers', 0)} workers"
            + (f"  METG ideal ~{ideal}" if ideal is not None else "")
            + (f"  efficiency {eff * 100:.0f}%" if eff is not None else "")
            + f"  idle {cp.get('idle_s', 0)}s")
        ends = " -> ".join(str(t) for t in cp["path"][-3:])
        lines.append(f"   tail: {ends}")
        for s in cp.get("stragglers") or []:
            mark = "  << ON PATH" if s.get("on_path") else ""
            lines.append(f"   straggler {s['task']}"
                         f" {s['run_s']}s x{s['ratio']}"
                         f" on {s['worker']}{mark}")
    for i, rep in enumerate(stats.get("serving") or []):
        lat = rep.get("latency_ms") or {}
        lines.append("")
        lines.append(
            f"  serving[{i}]: {rep.get('n_requests', 0)} req"
            f"  p50 {lat.get('p50', 0)}ms p95 {lat.get('p95', 0)}ms"
            f" p99 {lat.get('p99', 0)}ms"
            f"  rejected {rep.get('n_rejected', 0)}"
            f"  mean batch {rep.get('mean_batch', 0)}"
            f"  queue depth {rep.get('queue_depth_mean', 0)}")
        for tenant, trep in sorted((rep.get("tenants") or {}).items()):
            tlat = trep.get("latency_ms") or {}
            lines.append(
                f"    tenant {tenant}: {trep.get('n_requests', 0)} req"
                f"  p50 {tlat.get('p50', 0)}ms"
                f" p95 {tlat.get('p95', 0)}ms"
                f" p99 {tlat.get('p99', 0)}ms"
                f"  failed {trep.get('n_failed', 0)}"
                f"  rejected {trep.get('n_rejected', 0)}")
    return "\n".join(lines)


def main(argv: Optional[list] = None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.core.obs.top",
        description="text dashboard over a repro StatsServer")
    p.add_argument("--url", default="http://127.0.0.1:8787",
                   help="stats server base URL (default %(default)s)")
    p.add_argument("--interval", type=float, default=2.0,
                   help="refresh period in seconds (default %(default)s)")
    p.add_argument("--once", action="store_true",
                   help="print one snapshot and exit")
    args = p.parse_args(argv)
    while True:
        try:
            stats = fetch(args.url)
        except OSError as e:
            print(f"fetch {args.url}/stats failed: {e}", file=sys.stderr)
            return 1
        out = render(stats)
        if args.once:
            print(out)
            return 0
        # ANSI clear + home: redraw in place without curses
        print("\x1b[2J\x1b[H" + out, flush=True)
        time.sleep(args.interval)


if __name__ == "__main__":
    sys.exit(main())
