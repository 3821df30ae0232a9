"""Critical-path analysis: explain *why* a run missed maximum parallelism
(the port's copy of the JAX package's `repro.core.obs.critical_path`).

`OverheadReport` answers the paper's aggregate question (was per-task
scheduling overhead below the METG?); this module answers the per-run
one: which chain of tasks gated the makespan, and how much of that
chain was scheduler time vs compute?  It reconstructs the causal span
graph from the `TraceRecorder` lifecycle events plus the engine's
dependency table, decomposing each task's span into the Fig.-2 protocol
stages:

    dep-wait -> ready-queue -> steal/dispatch -> run -> complete-notify

with earlier run episodes (requeues after a worker death, `RetryPolicy`
re-executions) reported as wasted sub-spans.  The longest weighted path
through the completed DAG — chosen backward from the last terminal task
via each task's latest-finishing dependency — is the critical path: the
one chain whose stage times telescope *exactly* to the measured
makespan, so the decomposition is an attribution, not an estimate.

Beyond the path itself the report carries the run-shape diagnostics
that explain a parallelism gap:

  * a concurrency-vs-time profile (how many tasks were actually running)
    with mean/peak, compared against the pool size and the ideal
    parallelism implied by the METG laws in `repro_torch.core.metg` at the
    observed mean task duration and scheduler RTT;
  * idle gaps — spans inside the makespan window where *nothing* ran;
  * straggler detection — tasks whose run time dwarfs the median, and
    whether they sit on the critical path;
  * the per-op rpc cost fold from the same events `rpc_by_op` uses.

Everything here is strictly post-hoc: the analyzer only ever reads a
snapshot of the event log, never touching the dispatch loop
(`benchmarks/engine_overhead.py --check` holds that budget).  Entry
points: `CriticalPathReport.from_trace` / `.from_engine`,
`OverheadReport.explain()`, the `/stats` `critical_path` section, and
the `python -m repro_torch.core.obs.explain <trace>` CLI.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Optional

from repro_torch.core.engine.model import (COMPLETED, CREATED, FAILED,
                                           READY, RETRIED, RPC, RUN_END,
                                           RUN_START, STOLEN, XFER)
from repro_torch.core.metg import METGModel

# the Fig.-2 stage names, in causal order; every per-task decomposition
# and every report total uses these keys
SEGMENTS = ("dep_wait", "queue", "dispatch", "run", "notify")


class _Span:
    """Per-task stamp accumulator for one pass over the event log."""

    __slots__ = ("created", "ready", "steals", "runs", "open_run",
                 "terminal", "ok", "worker", "deps", "retries",
                 "xfer_s", "n_xfer", "xfer_bytes")

    def __init__(self):
        self.created = None       # first CREATED t
        self.ready = None         # first READY t
        self.steals = []          # every STOLEN t (requeues repeat)
        self.runs = []            # (t0, t1, worker) per execution episode
        self.open_run = None      # sequential RUN_START/RUN_END pairing
        self.terminal = None      # LAST COMPLETED/FAILED t
        self.ok = True
        self.worker = None
        self.deps = None          # from the CREATED event, if stamped
        self.retries = 0
        self.xfer_s = 0.0         # data-plane fetch time of THIS task's
        self.n_xfer = 0           #   value (attributed to the producer)
        self.xfer_bytes = 0


def _collect(events) -> tuple[dict, dict, dict, float]:
    """One pass: task -> _Span, rpc per-op fold, xfer per-path fold,
    trace epoch."""
    spans: dict[str, _Span] = {}
    rpc_by_op: dict = {}
    xfer_by_path: dict = {}           # path -> [n, bytes, seconds]
    t_first = None

    def span(name) -> _Span:
        s = spans.get(name)
        if s is None:
            s = spans[name] = _Span()
        return s

    for e in events:
        if t_first is None:
            t_first = e.t
        ev = e.event
        if ev == RUN_START:
            span(e.task).open_run = e.t
        elif ev == RUN_END:
            s = span(e.task)
            if s.open_run is not None:
                s.runs.append((s.open_run, e.t, e.worker))
                s.open_run = None
        elif ev == STOLEN:
            span(e.task).steals.append(e.t)
        elif ev == CREATED:
            s = span(e.task)
            if s.created is None:
                s.created = e.t
                deps = e.extra.get("deps")
                if deps:
                    s.deps = tuple(deps)
        elif ev == READY:
            s = span(e.task)
            if s.ready is None:
                s.ready = e.t
        elif ev in (COMPLETED, FAILED):
            s = span(e.task)
            s.terminal = e.t              # last wins: resurrected stubs
            s.ok = ev == COMPLETED
            if e.worker is not None:
                s.worker = e.worker
        elif ev == RETRIED:
            span(e.task).retries += 1
        elif ev == RPC:
            op = e.extra.get("op", "?")
            dt = e.extra.get("dt", 0.0)
            cnt, tot = rpc_by_op.get(op, (0, 0.0))
            rpc_by_op[op] = (cnt + 1, tot + dt)
        elif ev == XFER:
            # data-plane fetch of e.task's value (peer or hub path) —
            # folded onto the PRODUCER's span and the per-path totals
            n = e.extra.get("n", 0)
            dt = e.extra.get("dt", 0.0)
            s = span(e.task)
            s.n_xfer += 1
            s.xfer_bytes += n
            s.xfer_s += dt
            ent = xfer_by_path.get(e.extra.get("path", "?"))
            if ent is None:
                ent = xfer_by_path[e.extra.get("path", "?")] = [0, 0, 0.0]
            ent[0] += 1
            ent[1] += n
            ent[2] += dt
    return spans, rpc_by_op, xfer_by_path, (t_first or 0.0)


def _arrive_t(s: _Span) -> Optional[float]:
    """Earliest stamp a task's causal span can anchor on (CREATED is
    absent for pre-created server universes and ring-evicted heads)."""
    for t in (s.created, s.ready,
              s.steals[0] if s.steals else None,
              s.runs[0][0] if s.runs else None):
        if t is not None:
            return t
    return s.terminal


def _segments_of(s: _Span, t_arrive: float) -> dict:
    """Decompose [t_arrive, terminal] into the five protocol stages using
    the FINAL execution episode (earlier episodes are wasted work).  The
    checkpoints are prefix-max clamped, so the stage durations are
    non-negative and telescope exactly to `terminal - t_arrive`."""
    run = s.runs[-1] if s.runs else None
    if run is not None:
        t0, t1 = run[0], run[1]
        steal = None
        for t in reversed(s.steals):
            if t <= t0:
                steal = t
                break
        if steal is None and s.steals:
            steal = s.steals[-1]
        raw = (s.ready, steal, t0, t1, s.terminal)
    else:
        # never ran: poisoned / cancelled / fail-fast — the whole span is
        # dep-wait (it waited on a producer that failed it)
        raw = (s.terminal, s.terminal, s.terminal, s.terminal, s.terminal)
    cps = [t_arrive]
    for t in raw:
        prev = cps[-1]
        cps.append(prev if t is None else max(t, prev))
    return {name: cps[i + 1] - cps[i] for i, name in enumerate(SEGMENTS)}


@dataclass
class CriticalPathReport:
    """The causal explanation of one run's makespan.  Build it with
    `from_trace` / `from_engine` (or `OverheadReport.explain()`); read
    it with `summary()`, render it with `repro_torch.core.obs.explain.render`,
    overlay it on a timeline with
    `trace.to_chrome_trace(path, critical_path=report.path)`."""
    path: list = field(default_factory=list)        # task names, in order
    segments: list = field(default_factory=list)    # per path task dicts
    makespan_s: float = 0.0          # path-start arrive -> last terminal
    wall_s: float = 0.0              # full trace span (>= makespan_s)
    t_start: float = 0.0             # path start, relative to trace epoch
    n_tasks: int = 0                 # tasks that reached terminal
    workers: int = 1                 # pool size the run was configured for
    # makespan decomposition over the path (sums to makespan_s):
    dep_wait_s: float = 0.0
    queue_s: float = 0.0
    dispatch_s: float = 0.0
    run_s: float = 0.0               # compute-attributable
    notify_s: float = 0.0
    wasted_s: float = 0.0            # earlier run episodes on the path
    # concurrency-vs-time:
    concurrency_mean: float = 0.0
    concurrency_peak: int = 0
    profile: list = field(default_factory=list)     # (t_rel, n_running)
    idle_s: float = 0.0              # makespan time with nothing running
    idle_gaps: list = field(default_factory=list)   # longest (t_rel, dur)
    # stragglers:
    stragglers: list = field(default_factory=list)
    straggler_factor: float = 4.0
    run_median_s: float = 0.0
    # METG-law comparison:
    scheduler: Optional[str] = None
    metg_ideal_workers: Optional[float] = None
    parallel_efficiency: Optional[float] = None
    # rpc fold (same exclusion rules as OverheadReport):
    rpc_s: float = 0.0
    n_rpc: int = 0
    rtt_mean_s: float = 0.0
    rpc_by_op: dict = field(default_factory=dict)
    # data motion (peer-to-peer data plane, transport="proc"):
    xfer_s: float = 0.0              # total fetch time, all tasks
    n_xfer: int = 0
    xfer_bytes: int = 0
    xfer_by_path: dict = field(default_factory=dict)  # path -> (n, B, s)
    path_xfer_s: float = 0.0         # fetch time of critical-path values
    # truncation honesty:
    n_emitted: int = 0
    dropped: int = 0

    # ------------------------------------------------------------ derived
    @property
    def compute_s(self) -> float:
        """Compute-attributable share of the makespan (path run time)."""
        return self.run_s

    @property
    def sched_s(self) -> float:
        """Scheduler-attributable share of the makespan: everything on
        the path that is not the final run episodes."""
        return (self.dep_wait_s + self.queue_s + self.dispatch_s
                + self.notify_s)

    @property
    def sched_frac(self) -> float:
        return self.sched_s / self.makespan_s if self.makespan_s > 0 else 0.0

    @property
    def xfer_verdict(self) -> Optional[str]:
        """Was the run gated by moving bytes or by scheduling them?
        None when the data plane never fetched anything (inline-only
        runs, in-process transports).  "transfer-bound" when the fetch
        time of critical-path values exceeds the path's scheduler share
        (dispatch + queue + notify) — shrinking rpc latency then cannot
        help as much as moving fewer bytes (bigger inline threshold,
        better placement); "dispatch-bound" otherwise."""
        if self.n_xfer == 0:
            return None
        sched_non_wait = self.queue_s + self.dispatch_s + self.notify_s
        return ("transfer-bound" if self.path_xfer_s > sched_non_wait
                else "dispatch-bound")

    # --------------------------------------------------------- construction
    @classmethod
    def from_trace(cls, trace, *, deps: Optional[dict] = None,
                   workers: int = 1, scheduler: Optional[str] = None,
                   steal_n: int = 1, shards: int = 1,
                   model: Optional[METGModel] = None,
                   straggler_factor: float = 4.0,
                   profile_points: int = 240) -> "CriticalPathReport":
        """Analyze a `TraceRecorder`.  `deps` maps task -> iterable of
        dependency names (e.g. `engine.dep_table()`); without it the
        analyzer uses the `deps` stamped on CREATED events — identical
        for any trace the engine produced.  `scheduler` ("dwork" /
        "pmake" / "mpi-list", default dwork) selects the METG law for
        the ideal-parallelism comparison."""
        with trace._lock:
            events = list(trace.events)
        rep = cls.from_events(
            events, deps=deps, workers=workers, scheduler=scheduler,
            steal_n=steal_n, shards=shards, model=model,
            straggler_factor=straggler_factor,
            profile_points=profile_points)
        rep.n_emitted = trace.n_emitted
        rep.dropped = trace.dropped
        # sampled tracing: scale recorded round-trips up to the true count
        if trace.rpc_seen > rep.n_rpc > 0:
            rep.rpc_s *= trace.rpc_seen / rep.n_rpc
            rep.n_rpc = trace.rpc_seen
        return rep

    @classmethod
    def from_engine(cls, engine, **kw) -> "CriticalPathReport":
        """Analyze a live (or finished) engine: its tracer joined with
        its dependency table and pool shape.  Monitoring-grade reads
        only — never blocks the dispatch loop."""
        kw.setdefault("deps", engine.dep_table())
        kw.setdefault("workers", max(engine.live_workers(), 1))
        kw.setdefault("steal_n", getattr(engine, "steal_n", 1))
        kw.setdefault("shards", getattr(engine, "shards", 1))
        return cls.from_trace(engine.tracer, **kw)

    @classmethod
    def from_events(cls, events: list, *, deps: Optional[dict] = None,
                    workers: int = 1, scheduler: Optional[str] = None,
                    steal_n: int = 1, shards: int = 1,
                    model: Optional[METGModel] = None,
                    straggler_factor: float = 4.0,
                    profile_points: int = 240) -> "CriticalPathReport":
        spans, rpc_by_op, xfer_by_path, t_epoch = _collect(events)
        term = {n: s for n, s in spans.items() if s.terminal is not None}
        rep = cls(workers=max(int(workers), 1), scheduler=scheduler,
                  straggler_factor=straggler_factor, n_tasks=len(term))
        # rpc fold (hop:* stays in the breakdown, out of the totals)
        rep.rpc_by_op = {op: (cnt, tot)
                         for op, (cnt, tot) in sorted(rpc_by_op.items())}
        for op, (cnt, tot) in rpc_by_op.items():
            if not op.startswith("hop:"):
                rep.rpc_s += tot
                rep.n_rpc += cnt
        rep.rtt_mean_s = rep.rpc_s / rep.n_rpc if rep.n_rpc else 0.0
        # data-motion fold (unsampled: every fetch emits exactly one XFER)
        rep.xfer_by_path = {p: (n, b, round(t, 6))
                            for p, (n, b, t) in sorted(xfer_by_path.items())}
        for n, b, t in xfer_by_path.values():
            rep.n_xfer += n
            rep.xfer_bytes += b
            rep.xfer_s += t
        if events:
            ts = [e.t for e in events]
            rep.wall_s = max(ts) - min(ts)
        if not term:
            return rep

        def dep_names(name: str):
            if deps is not None:
                return deps.get(name) or ()
            s = spans.get(name)
            return s.deps or () if s is not None else ()

        # ---- longest path: walk back from the last terminal task via the
        # latest-finishing dependency, extending only while the chosen
        # edge was binding (the dep finished after this task existed —
        # a dep that completed before the dependent was even created
        # gated nothing)
        end = max(term, key=lambda n: term[n].terminal)
        path = [end]
        seen = {end}
        cur = end
        while True:
            cands = [d for d in dep_names(cur)
                     if d in term and d not in seen]
            if not cands:
                break
            best = max(cands, key=lambda d: term[d].terminal)
            t_cur = _arrive_t(spans[cur])
            if t_cur is not None and term[best].terminal < t_cur:
                break
            path.append(best)
            seen.add(best)
            cur = best
        path.reverse()
        rep.path = path

        # ---- stage decomposition: each path task's span starts where the
        # previous one finished (the chain is causal and the engine stamps
        # READY after the producer's COMPLETED, so checkpoints are
        # monotone) — the sum telescopes exactly to the makespan
        t_start = _arrive_t(spans[path[0]])
        t_end = term[end].terminal
        rep.t_start = t_start - t_epoch
        rep.makespan_s = max(t_end - t_start, 0.0)
        prev_t = t_start
        for name in path:
            s = spans[name]
            seg = _segments_of(s, prev_t)
            wasted = sum(t1 - t0 for t0, t1, _ in s.runs[:-1])
            row = {"task": name, "worker": s.worker,
                   "t_s": round(prev_t - t_epoch, 6),
                   "n_runs": len(s.runs), "retries": s.retries,
                   **{f"{k}_s": round(v, 6) for k, v in seg.items()}}
            if s.n_xfer:
                # data motion: time dependents spent fetching THIS value
                row["xfer_s"] = round(s.xfer_s, 6)
                row["xfer_bytes"] = s.xfer_bytes
                rep.path_xfer_s += s.xfer_s
            if wasted:
                row["wasted_s"] = round(wasted, 6)
                row["episodes"] = [
                    {"t_s": round(t0 - t_epoch, 6),
                     "run_s": round(t1 - t0, 6), "worker": w}
                    for t0, t1, w in s.runs[:-1]]
            rep.segments.append(row)
            rep.dep_wait_s += seg["dep_wait"]
            rep.queue_s += seg["queue"]
            rep.dispatch_s += seg["dispatch"]
            rep.run_s += seg["run"]
            rep.notify_s += seg["notify"]
            rep.wasted_s += wasted
            prev_t = s.terminal

        # ---- concurrency-vs-time over EVERY run episode (wasted work
        # occupied a worker too), swept inside the makespan window
        marks = []
        total_run = 0.0
        finals = []
        for name, s in term.items():
            for t0, t1, _w in s.runs:
                a, b = max(t0, t_start), min(t1, t_end)
                if b > a:
                    marks.append((a, 1))
                    marks.append((b, -1))
                    total_run += b - a
            if s.runs:
                finals.append((name, s.runs[-1]))
        marks.sort()
        profile = []                    # (t, level) changepoints
        level = 0
        idle_gaps = []                  # (t_gap_start, dur)
        t_idle_from = t_start
        for t, d in marks:
            if level == 0 and d > 0 and t > t_idle_from:
                idle_gaps.append((t_idle_from, t - t_idle_from))
            level += d
            if d < 0 and level == 0:
                t_idle_from = t
            if profile and profile[-1][0] == t:
                profile[-1] = (t, level)
            else:
                profile.append((t, level))
        if level == 0 and t_end > t_idle_from:
            idle_gaps.append((t_idle_from, t_end - t_idle_from))
        rep.idle_s = sum(d for _, d in idle_gaps)
        idle_gaps.sort(key=lambda g: -g[1])
        rep.idle_gaps = [(round(t - t_epoch, 6), round(d, 6))
                         for t, d in idle_gaps[:5]]
        rep.concurrency_peak = max((lv for _, lv in profile), default=0)
        if rep.makespan_s > 0:
            rep.concurrency_mean = total_run / rep.makespan_s
        if len(profile) > profile_points:
            step = len(profile) / profile_points
            profile = [profile[int(i * step)]
                       for i in range(profile_points)]
        rep.profile = [(round(t - t_epoch, 6), lv) for t, lv in profile]

        # ---- stragglers: final-episode run times vs the median
        durs = sorted(t1 - t0 for _, (t0, t1, _w) in finals)
        if durs:
            rep.run_median_s = durs[len(durs) // 2]
        med = rep.run_median_s
        on_path = set(path)
        if med > 0:
            out = [(name, t1 - t0, w) for name, (t0, t1, w) in finals
                   if (t1 - t0) >= straggler_factor * med]
            out.sort(key=lambda r: -r[1])
            rep.stragglers = [
                {"task": name, "worker": w, "run_s": round(d, 6),
                 "ratio": round(d / med, 2), "on_path": name in on_path}
                for name, d, w in out[:5]]

        # ---- METG-law ideal parallelism at the observed task granularity
        mean_task_s = (sum(durs) / len(durs)) if durs else 0.0
        rep.metg_ideal_workers = _ideal_workers(
            scheduler or "dwork", mean_task_s, rep.rtt_mean_s,
            steal_n=steal_n, shards=shards, model=model)
        cap = rep.workers
        if rep.metg_ideal_workers is not None:
            cap = min(cap, rep.metg_ideal_workers)
        if cap and cap > 0:
            rep.parallel_efficiency = min(
                rep.concurrency_mean / cap, 1.0)
        return rep

    # ------------------------------------------------------------- output
    def summary(self, max_tasks: Optional[int] = None) -> dict:
        """JSON-able digest (the `/stats` `critical_path` section).  With
        `max_tasks`, the per-task segment rows are capped to the LAST
        `max_tasks` path entries (the end of the path is where the run
        finished — usually the interesting part)."""
        segs = self.segments
        path = self.path
        truncated = False
        if max_tasks is not None and len(segs) > max_tasks:
            segs = segs[-max_tasks:]
            path = path[-max_tasks:]
            truncated = True
        out = {
            "n_tasks": self.n_tasks,
            "n_tasks_on_path": len(self.path),
            "makespan_s": round(self.makespan_s, 6),
            "wall_s": round(self.wall_s, 6),
            "workers": self.workers,
            "compute_s": round(self.compute_s, 6),
            "sched_s": round(self.sched_s, 6),
            "sched_frac": round(self.sched_frac, 4),
            "breakdown_s": {
                "dep_wait": round(self.dep_wait_s, 6),
                "queue": round(self.queue_s, 6),
                "dispatch": round(self.dispatch_s, 6),
                "run": round(self.run_s, 6),
                "notify": round(self.notify_s, 6),
            },
            "wasted_s": round(self.wasted_s, 6),
            "concurrency": {
                "mean": round(self.concurrency_mean, 3),
                "peak": self.concurrency_peak,
                "ideal_metg": (round(self.metg_ideal_workers, 1)
                               if self.metg_ideal_workers is not None
                               else None),
                "efficiency": (round(self.parallel_efficiency, 4)
                               if self.parallel_efficiency is not None
                               else None),
            },
            "idle_s": round(self.idle_s, 6),
            "idle_gaps": self.idle_gaps,
            "stragglers": self.stragglers,
            "rpc": {"n": self.n_rpc, "total_s": round(self.rpc_s, 6),
                    "rtt_mean_us": round(self.rtt_mean_s * 1e6, 2)},
            "data_motion": {
                "n_xfer": self.n_xfer,
                "bytes": self.xfer_bytes,
                "total_s": round(self.xfer_s, 6),
                "path_s": round(self.path_xfer_s, 6),
                "by_path": {p: {"n": n, "bytes": b, "total_s": t}
                            for p, (n, b, t) in self.xfer_by_path.items()},
                "verdict": self.xfer_verdict,
            },
            "path": path,
            "segments": segs,
        }
        if truncated:
            out["path_truncated"] = True
        if self.dropped:
            out["n_emitted"] = self.n_emitted
            out["dropped"] = self.dropped
        return out


def _ideal_workers(scheduler: str, task_s: float, rtt_s: float, *,
                   steal_n: int = 1, shards: int = 1,
                   model: Optional[METGModel] = None) -> Optional[float]:
    """Invert the METG law: the parallelism P at which per-task
    scheduling overhead would equal the observed mean task duration
    (50% efficiency) — running wider than this cannot help, so it is the
    ceiling the concurrency profile should be compared against.  None
    when the law cannot be inverted from what was measured."""
    if task_s <= 0.0:
        return None
    m = model
    if scheduler == "dwork":
        # METG(P) = rtt * P / (steal_n * shards)  =>  P*
        rtt = rtt_s if rtt_s > 0 else (m.dwork_rtt if m is not None
                                       else None)
        if not rtt:
            return None
        return task_s * max(steal_n, 1) * max(shards, 1) / rtt
    if m is None:
        m = METGModel.from_paper()
    if scheduler == "pmake":
        # METG(P) = a + b ln P + alloc  =>  P* = exp((t - alloc - a) / b)
        if m.jsrun_b <= 0:
            return None
        x = (task_s - m.alloc - m.jsrun_a) / m.jsrun_b
        return math.exp(min(x, 50.0)) if x > 0 else 1.0
    if scheduler in ("mpi-list", "mpi_list"):
        # sync gap a + b ln P (ms) = t  =>  P* on the fitted curve
        if m.sync_b <= 0:
            return None
        x = (task_s * 1e3 - m.sync_a) / m.sync_b
        return math.exp(min(x, 50.0)) if x > 0 else 1.0
    return None
