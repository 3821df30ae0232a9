"""Trace recorder + empirical overhead / METG / latency analysis, the
port's copy of the JAX package's `repro.core.engine.tracing`.  The
Chrome-trace export and the critical-path report live in
`repro_torch.core.obs`.

The recorder is a thread-safe log of `TraceEvent`s stamped by an
injectable clock — append-only by default, or a bounded ring buffer
(`TraceRecorder(max_events=N)`) for long-lived resident sessions that
must not grow without bound.  Analysis turns an event stream into the paper's
quantities *measured from the running system* rather than modelled:

  * per-task overhead   — wall time not spent computing, per completed task
                          (the paper's "well-understood per-task overhead")
  * rpc_per_task_s      — scheduler round-trip time per task (dwork's 23 us
                          RTT analog, measured at the server boundary)
  * tasks_per_s         — dispatch throughput
  * empirical METG      — task duration at which measured overhead equals
                          compute (§3: eff = t / (t + overhead) = 50%)
  * request latency     — serving mode (`core.serving`): per-request
                          enqueue -> complete latency with p50/p95/p99
                          percentiles plus admission queue-depth stats,
                          computed from the REQ_* / BATCH_FORMED events
                          (`LatencyReport`, attached to `OverheadReport`)

`crosscheck()` compares an empirical value against the analytic scaling
laws in `repro_torch.core.metg` and reports whether they agree to within an
order of magnitude — the engine's validation loop for the models.

`span(name, tracer)` names a stretch of the program: on a recorder's
clock as one SPAN event, and, while a torch profiler records, as a
profiler range, so that the device operations launched inside it carry
the program's layer names in the device trace.
"""
from __future__ import annotations

import contextlib
import json
import sys
import threading
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Optional

from repro_torch.core.engine.model import (BATCH_FORMED, COMPLETED, FAILED,
                                           REQ_DONE, REQ_ENQUEUED,
                                           REQ_REJECTED, REQUEUED, RETRIED,
                                           RPC, RUN_END, RUN_START, SPAN,
                                           XFER, TraceEvent, real_clock)
from repro_torch.core.metg import same_order

_NO_SPAN = contextlib.nullcontext()
_open = threading.local()          # .names: this thread's open SPANs


def _profiling() -> bool:
    """Whether a torch profiler records, on any thread (none can where
    torch was never imported).  A profiler records the ranges of the
    thread that started it, and of every other thread only where it was
    started with `profile_all_threads`."""
    torch = sys.modules.get("torch")
    return torch is not None and torch.autograd.profiler._is_profiler_enabled


def _autograd():
    return sys.modules["torch"]._C._autograd


class _Range:
    """The user range that `torch.profiler.record_function(name)` opens,
    by its C entry points: a third of the cost."""
    __slots__ = ("name", "handle")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.handle = _autograd()._record_function_with_args_enter(self.name)
        return self

    def __exit__(self, *exc):
        _autograd()._record_function_with_args_exit(self.handle)
        return False


class _Span:
    """A span with a tracer: one SPAN event at its exit, and a profiler
    range around it while a profiler records."""
    __slots__ = ("name", "tracer", "extra", "range", "t0", "parent")

    def __init__(self, name: str, tracer, profiling: bool, extra: dict):
        self.name, self.tracer, self.extra = name, tracer, extra
        self.range = _Range(name) if profiling else None

    def __enter__(self):
        names = _open.__dict__.setdefault("names", [])
        self.parent = names[-1] if names else None
        names.append(self.name)
        self.t0 = self.tracer.clock()
        if self.range is not None:
            self.range.__enter__()
        return self

    def __exit__(self, *exc):
        if self.range is not None:
            self.range.__exit__()
        _open.names.pop()
        self.tracer.emit_at(self.tracer.clock(), SPAN, name=self.name,
                            t0=self.t0, parent=self.parent, **self.extra)
        return False


def span(name: str, tracer: Optional["TraceRecorder"] = None, **extra):
    """A context manager naming a stretch of the program.  With `tracer`,
    it records one SPAN event on the tracer's clock at its exit (extra:
    `name`, `t0` its start, `parent` the name of the enclosing span with a
    tracer on this thread, and `extra`, which the body may add to through
    the entered span's `.extra`).  While a torch profiler records, it also
    opens the user range that `torch.profiler.record_function(name)`
    would.  With neither, it returns one shared null context: no
    allocation, nothing recorded."""
    profiling = _profiling()
    if tracer is not None:
        return _Span(name, tracer, profiling, extra)
    return _Range(name) if profiling else _NO_SPAN


def percentile(sorted_vals: list, q: float) -> float:
    """Linear-interpolated percentile of an ascending-sorted list
    (q in [0, 1]); 0.0 on empty input."""
    if not sorted_vals:
        return 0.0
    if len(sorted_vals) == 1:
        return float(sorted_vals[0])
    pos = q * (len(sorted_vals) - 1)
    lo = int(pos)
    hi = min(lo + 1, len(sorted_vals) - 1)
    frac = pos - lo
    return float(sorted_vals[lo] * (1.0 - frac) + sorted_vals[hi] * frac)


class TraceRecorder:
    def __init__(self, clock: Optional[Callable[[], float]] = None,
                 rpc_sample: int = 1, max_events: Optional[int] = None):
        self.clock = clock or real_clock
        # opt-in bounded memory for long-lived resident sessions: with
        # `max_events` the event log is a ring buffer — the newest
        # `max_events` events are kept and `self.dropped` counts the
        # evictions.  Analysis over a ring covers the retained window
        # only (events whose lifecycle partner was evicted pair as
        # incomplete and are skipped by the report pairing).
        self.max_events = max_events
        if max_events is not None:
            self.events: deque[TraceEvent] = deque(maxlen=max(max_events, 1))
        else:
            self.events: list[TraceEvent] = []
        self.n_emitted = 0
        self._lock = threading.Lock()
        # rpc sampling: record every k-th round-trip instead of all of
        # them.  Backends call `sample_rpc()` BEFORE timing a call; a
        # False return means "skip the perf_counter pair and the event
        # allocation entirely" — the unsampled calls are still counted
        # (`rpc_seen`) so `OverheadReport` can scale the totals back up.
        self.rpc_sample = max(int(rpc_sample), 1)
        self.rpc_seen = 0

    @property
    def dropped(self) -> int:
        """Events evicted by the ring buffer (0 when unbounded)."""
        return max(0, self.n_emitted - len(self.events))

    def sample_rpc(self) -> bool:
        """Should the next backend round-trip be timed + recorded?"""
        self.rpc_seen += 1
        return self.rpc_sample == 1 or self.rpc_seen % self.rpc_sample == 0

    def emit(self, event: str, task: Optional[str] = None,
             worker: Optional[str] = None, **extra):
        ev = TraceEvent(self.clock(), event, task, worker, extra)
        if self.max_events is None:
            # list.append is atomic under the GIL — no lock on the hot
            # path; readers still lock to snapshot a consistent view
            self.n_emitted += 1
            self.events.append(ev)
        else:
            # ring mode must lock: a bounded deque append also EVICTS, and
            # eviction during a reader's iteration raises.  Bounded mode
            # is opt-in, so the unbounded hot path stays lock-free.
            with self._lock:
                self.n_emitted += 1
                self.events.append(ev)
        return ev

    def emit_at(self, t: float, event: str, task: Optional[str] = None,
                worker: Optional[str] = None, **extra):
        """Emit with an explicit timestamp instead of stamping the clock:
        the proc transport reconstructs RUN_START/RUN_END spans
        engine-side from worker-reported durations, so the stamps must
        reflect when the task ran in the worker process, not when the
        record drained.  Events still append in call order (the report
        pairing walks list order, not timestamps)."""
        ev = TraceEvent(t, event, task, worker, extra)
        if self.max_events is None:
            self.n_emitted += 1
            self.events.append(ev)
        else:
            with self._lock:
                self.n_emitted += 1
                self.events.append(ev)
        return ev

    def emit4(self, event: str, task: str, worker: str):
        """No-extra fast emit for the 3-4 per-task lifecycle events on the
        dispatch hot path (skips kwargs packing)."""
        ev = TraceEvent(self.clock(), event, task, worker)
        if self.max_events is None:
            self.n_emitted += 1
            self.events.append(ev)
        else:
            with self._lock:
                self.n_emitted += 1
                self.events.append(ev)
        return ev

    # ------------------------------------------------------------ queries
    def of(self, event: str) -> list[TraceEvent]:
        with self._lock:
            return [e for e in self.events if e.event == event]

    def count(self, event: str) -> int:
        return len(self.of(event))

    def span_s(self) -> float:
        with self._lock:
            if not self.events:
                return 0.0
            ts = [e.t for e in self.events]
            return max(ts) - min(ts)

    def report(self, workers: int = 1) -> "OverheadReport":
        return OverheadReport.from_trace(self, workers=workers)

    def latency_report(self) -> "LatencyReport":
        return LatencyReport.from_trace(self)

    def to_chrome_trace(self, path: Optional[str] = None, *,
                        critical_path: Optional[list] = None) -> dict:
        """Export the event log as a Chrome Trace Event Format document
        (Perfetto / `chrome://tracing` loadable): one lane per worker
        with task spans, rpc and `hop:*` lanes, serving requests as
        async spans.  `critical_path` (a list of task names, e.g.
        `CriticalPathReport.path`) adds a dedicated lane plus flow
        arrows linking the path's executions.  Returns the document;
        with `path`, also writes it as JSON (conventional suffix
        `.trace.json`).  See `repro_torch.core.obs.chrome_trace`."""
        from repro_torch.core.obs.chrome_trace import to_chrome_trace
        return to_chrome_trace(self, path, critical_path=critical_path)

    # -------------------------------------------------------- persistence
    def save(self, path: str) -> int:
        """Write the event log as JSON Lines: one header object (recorder
        counters), then one `[t, event, task, worker, extra]` array per
        event.  The format round-trips through `TraceRecorder.load`, so a
        trace captured in one process can be analyzed offline
        (`python -m repro_torch.core.obs.explain <path>`, or the JAX
        package's `python -m repro.core.obs.explain <path>`).  Returns the
        number
        of events written."""
        with self._lock:
            events = list(self.events)
        with open(path, "w") as f:
            json.dump({"format": "repro-trace", "version": 1,
                       "n_emitted": self.n_emitted,
                       "dropped": max(0, self.n_emitted - len(events)),
                       "rpc_seen": self.rpc_seen,
                       "rpc_sample": self.rpc_sample}, f)
            f.write("\n")
            for e in events:
                json.dump([e.t, e.event, e.task, e.worker,
                           e.extra if e.extra else None], f)
                f.write("\n")
        return len(events)

    @classmethod
    def load(cls, path: str) -> "TraceRecorder":
        """Rebuild a recorder from a `save()`d JSONL file (unbounded —
        the ring, if any, was applied at capture time; eviction counts
        are restored so reports stay honest about truncation)."""
        tr = cls()
        with open(path) as f:
            header = json.loads(f.readline())
            if header.get("format") != "repro-trace":
                raise ValueError(f"{path}: not a repro trace "
                                 "(missing JSONL header)")
            for line in f:
                if not line.strip():
                    continue
                t, event, task, worker, extra = json.loads(line)
                tr.events.append(TraceEvent(t, event, task, worker, extra))
        tr.n_emitted = int(header.get("n_emitted", len(tr.events)))
        tr.rpc_seen = int(header.get("rpc_seen", 0))
        tr.rpc_sample = max(int(header.get("rpc_sample", 1)), 1)
        return tr


@dataclass
class LatencyReport:
    """Per-request latency accounting for the serving layer, computed from
    the REQ_* / BATCH_FORMED event stream: enqueue -> complete latency
    percentiles (tail latency is the serving SLO, so p95/p99 matter more
    than the mean) plus admission queue-depth stats."""
    n_requests: int = 0              # requests that got a response
    n_incomplete: int = 0            # REQ_DONE with no usable latency
    n_failed: int = 0                # responses delivered with ok=False
    n_rejected: int = 0              # bounced by admission backpressure
    n_batches: int = 0               # engine tasks the requests rode on
    mean_batch: float = 0.0
    mean_s: float = 0.0
    p50_s: float = 0.0
    p95_s: float = 0.0
    p99_s: float = 0.0
    max_s: float = 0.0
    queue_depth_mean: float = 0.0    # sampled at every enqueue + dispatch
    queue_depth_max: int = 0
    batch_wait_mean_s: float = 0.0   # oldest request's age at coalesce time
    # windowed snapshots (Frontend.snapshot) stamp their window here;
    # whole-trace reports leave both at 0
    t_s: float = 0.0                 # snapshot time on the trace clock
    window_s: float = 0.0            # span the snapshot covers
    # per-tenant slices: tenant label -> LatencyReport (latency fields
    # only), present when any request carried a tenant= label
    by_tenant: Optional[dict] = None

    @classmethod
    def _tenant_slice(cls, lats: list, n_failed: int = 0,
                      n_rejected: int = 0) -> "LatencyReport":
        """A latency-only sub-report for one tenant's sorted latencies."""
        return cls(
            n_requests=len(lats),
            n_failed=n_failed,
            n_rejected=n_rejected,
            mean_s=(sum(lats) / len(lats)) if lats else 0.0,
            p50_s=percentile(lats, 0.50),
            p95_s=percentile(lats, 0.95),
            p99_s=percentile(lats, 0.99),
            max_s=lats[-1] if lats else 0.0,
        )

    @classmethod
    def from_trace(cls, trace: "TraceRecorder") -> "LatencyReport":
        lats: list[float] = []
        depths: list[int] = []
        n_failed = n_rejected = n_batches = n_incomplete = 0
        batched = 0
        wait_s = 0.0
        tenant_lats: dict = {}       # tenant -> [lats, n_failed, n_rejected]
        with trace._lock:
            events = list(trace.events)
        for e in events:
            ev = e.event
            if ev == REQ_DONE:
                lat = e.extra.get("latency_s")
                if lat is None:
                    # an unstamped completion (its lifecycle partner was
                    # evicted from the ring, or a foreign emitter): skip
                    # it — folding a 0.0 default into the population
                    # would drag p50/mean toward zero
                    n_incomplete += 1
                    continue
                lats.append(lat)
                ok = e.extra.get("ok", True)
                if not ok:
                    n_failed += 1
                tenant = e.extra.get("tenant")
                if tenant is not None:
                    row = tenant_lats.setdefault(tenant, [[], 0, 0])
                    row[0].append(lat)
                    if not ok:
                        row[1] += 1
            elif ev == REQ_ENQUEUED:
                depths.append(e.extra.get("depth", 0))
            elif ev == BATCH_FORMED:
                n_batches += 1
                batched += e.extra.get("size", 0)
                wait_s += e.extra.get("wait_s", 0.0)
                depths.append(e.extra.get("depth", 0))
            elif ev == REQ_REJECTED:
                n_rejected += 1
                tenant = e.extra.get("tenant")
                if tenant is not None:
                    tenant_lats.setdefault(tenant, [[], 0, 0])[2] += 1
        lats.sort()
        by_tenant = None
        if tenant_lats:
            by_tenant = {}
            for tenant, (tl, tf, tr) in sorted(tenant_lats.items()):
                tl.sort()
                by_tenant[tenant] = cls._tenant_slice(tl, tf, tr)
        return cls(
            by_tenant=by_tenant,
            n_requests=len(lats),
            n_incomplete=n_incomplete,
            n_failed=n_failed,
            n_rejected=n_rejected,
            n_batches=n_batches,
            mean_batch=(batched / n_batches) if n_batches else 0.0,
            mean_s=(sum(lats) / len(lats)) if lats else 0.0,
            p50_s=percentile(lats, 0.50),
            p95_s=percentile(lats, 0.95),
            p99_s=percentile(lats, 0.99),
            max_s=lats[-1] if lats else 0.0,
            queue_depth_mean=(sum(depths) / len(depths)) if depths else 0.0,
            queue_depth_max=max(depths, default=0),
            batch_wait_mean_s=(wait_s / n_batches) if n_batches else 0.0,
        )

    def summary(self) -> dict:
        return {
            "n_requests": self.n_requests, "n_failed": self.n_failed,
            "n_incomplete": self.n_incomplete,
            "n_rejected": self.n_rejected, "n_batches": self.n_batches,
            "mean_batch": round(self.mean_batch, 2),
            "latency_ms": {
                "mean": round(self.mean_s * 1e3, 3),
                "p50": round(self.p50_s * 1e3, 3),
                "p95": round(self.p95_s * 1e3, 3),
                "p99": round(self.p99_s * 1e3, 3),
                "max": round(self.max_s * 1e3, 3),
            },
            "queue_depth_mean": round(self.queue_depth_mean, 2),
            "queue_depth_max": self.queue_depth_max,
            "batch_wait_mean_ms": round(self.batch_wait_mean_s * 1e3, 3),
            **({"t_s": round(self.t_s, 3),
                "window_s": round(self.window_s, 3)}
               if self.window_s else {}),
            **({"tenants": {
                tenant: {
                    "n_requests": rep.n_requests,
                    "n_failed": rep.n_failed,
                    "n_rejected": rep.n_rejected,
                    "latency_ms": {
                        "mean": round(rep.mean_s * 1e3, 3),
                        "p50": round(rep.p50_s * 1e3, 3),
                        "p95": round(rep.p95_s * 1e3, 3),
                        "p99": round(rep.p99_s * 1e3, 3),
                        "max": round(rep.max_s * 1e3, 3),
                    },
                } for tenant, rep in self.by_tenant.items()}}
               if self.by_tenant else {}),
        }


@dataclass
class OverheadReport:
    """Empirical per-task overhead computed from an event stream."""
    n_tasks: int = 0                 # tasks that reached a terminal event
    n_failed: int = 0
    n_requeued: int = 0
    n_retried: int = 0               # transient failures re-enqueued
    workers: int = 1
    wall_s: float = 0.0
    compute_s: float = 0.0           # sum of real run durations
    virtual_s: float = 0.0           # injected straggler time (not walled)
    rpc_s: float = 0.0               # total scheduler round-trip time
    n_rpc: int = 0
    rpc_by_op: dict = field(default_factory=dict)  # op -> (count, total_s)
    # data plane (transport="proc"): dependency-value fetch accounting,
    # unsampled — every fetch emits exactly one XFER, no scale-up needed
    xfer_s: float = 0.0              # total fetch time, all paths
    n_xfer: int = 0
    xfer_bytes: int = 0
    xfer_by_path: dict = field(default_factory=dict)  # path -> (n, B, s)
    requests: Optional[LatencyReport] = None  # serving mode, else None
    # ring-buffer truncation accounting: a bounded TraceRecorder evicts
    # its oldest events, so a report over it covers the retained window
    # only — dropped > 0 says every count above under-reports
    n_emitted: int = 0               # events the recorder ever emitted
    dropped: int = 0                 # events evicted before this report
    # the source recorder, kept so `explain()` can run the post-hoc
    # critical-path analysis without re-plumbing; None for hand-built
    # reports (excluded from summary())
    trace: Optional[TraceRecorder] = None

    @classmethod
    def from_trace(cls, trace: TraceRecorder, workers: int = 1
                   ) -> "OverheadReport":
        # pair lifecycle events sequentially per task: a requeued task
        # re-executes and emits a second run_start/run_end pair, so
        # last-write-wins dicts would pair across executions and produce
        # negative durations
        compute = virtual = 0.0
        open_start: dict = {}
        with trace._lock:
            events = list(trace.events)
        for e in events:
            if e.event == RUN_START:
                open_start[e.task] = e.t
            elif e.event == RUN_END:
                t_start = open_start.pop(e.task, None)
                if t_start is not None:
                    compute += e.t - t_start
                virtual += e.extra.get("virtual_s", 0.0)
        # rpc accounting: forwarding-tree hop events (op="hop:L<k>") are
        # nested inside the worker's end-to-end round-trip measurement, so
        # they go in the per-op breakdown (latency attribution) but NOT in
        # the rpc_s/n_rpc totals (that would double-count the tree)
        by_op: dict = {}
        rpc_s = 0.0
        n_rpc = 0
        for e in trace.of(RPC):
            op = e.extra.get("op", "?")
            dt = e.extra.get("dt", 0.0)
            cnt, tot = by_op.get(op, (0, 0.0))
            by_op[op] = (cnt + 1, tot + dt)
            if not op.startswith("hop:"):
                rpc_s += dt
                n_rpc += 1
        # sampled tracing: scale the recorded round-trips back up to the
        # true call count (rpc_seen counts every call, sampled or not)
        if trace.rpc_seen > n_rpc > 0:
            rpc_s *= trace.rpc_seen / n_rpc
            n_rpc = trace.rpc_seen
        # data-motion fold: per-path fetch totals (peer vs hub)
        xfer_by_path: dict = {}
        xfer_s = 0.0
        n_xfer = xfer_bytes = 0
        for e in trace.of(XFER):
            path = e.extra.get("path", "?")
            n = e.extra.get("n", 0)
            dt = e.extra.get("dt", 0.0)
            cnt, tb, ts = xfer_by_path.get(path, (0, 0, 0.0))
            xfer_by_path[path] = (cnt + 1, tb + n, ts + dt)
            n_xfer += 1
            xfer_bytes += n
            xfer_s += dt
        requeued = sum(e.extra.get("n", 1) for e in trace.of(REQUEUED))
        lat = LatencyReport.from_trace(trace)
        if lat.n_requests == 0 and lat.n_rejected == 0:
            lat = None                    # batch mode: no request stream
        return cls(
            trace=trace,
            requests=lat,
            n_tasks=trace.count(COMPLETED) + trace.count(FAILED),
            n_failed=trace.count(FAILED),
            n_requeued=requeued,
            n_retried=trace.count(RETRIED),
            workers=max(workers, 1),
            wall_s=trace.span_s(),
            compute_s=compute,
            virtual_s=virtual,
            rpc_s=rpc_s,
            n_rpc=n_rpc,
            rpc_by_op=by_op,
            xfer_s=xfer_s,
            n_xfer=n_xfer,
            xfer_bytes=xfer_bytes,
            xfer_by_path=xfer_by_path,
            n_emitted=trace.n_emitted,
            dropped=trace.dropped,
        )

    # ------------------------------------------------------------ derived
    @property
    def tasks_per_s(self) -> float:
        return self.n_tasks / self.wall_s if self.wall_s > 0 else 0.0

    @property
    def per_task_overhead_s(self) -> float:
        """Worker-seconds not spent computing, per terminal task.  With the
        serial in-proc transport (workers=1) this is exactly
        (wall - compute) / n: the scheduler's cost per task."""
        if self.n_tasks == 0:
            return 0.0
        idle = self.wall_s * self.workers - self.compute_s
        return max(idle, 0.0) / self.n_tasks

    @property
    def rpc_per_task_s(self) -> float:
        """Server-side handling time per terminal task (dwork RTT analog)."""
        return self.rpc_s / self.n_tasks if self.n_tasks else 0.0

    def empirical_metg(self) -> float:
        """Task duration at which measured overhead = compute (50% eff)."""
        return self.per_task_overhead_s

    def explain(self, **kw) -> "object":
        """Post-hoc critical-path analysis over the source trace: *why*
        did this run take `wall_s` — which chain of tasks gated the
        makespan, and how much of it was scheduler time (dep-wait +
        queue + dispatch + notify) vs compute?  Returns a
        `repro_torch.core.obs.critical_path.CriticalPathReport`; keyword
        arguments (`deps=`, `scheduler=`, `steal_n=`, ...) are forwarded
        to `CriticalPathReport.from_trace`.  Strictly an analysis pass —
        nothing here runs on the dispatch hot path."""
        if self.trace is None:
            raise ValueError("explain() needs the source trace; this "
                             "report was built without one")
        from repro_torch.core.obs.critical_path import CriticalPathReport
        kw.setdefault("workers", self.workers)
        return CriticalPathReport.from_trace(self.trace, **kw)

    def summary(self) -> dict:
        out = {
            "n_tasks": self.n_tasks, "n_failed": self.n_failed,
            "n_requeued": self.n_requeued, "n_retried": self.n_retried,
            "workers": self.workers,
            "wall_s": round(self.wall_s, 6),
            "tasks_per_s": round(self.tasks_per_s, 1),
            "per_task_overhead_us": round(self.per_task_overhead_s * 1e6, 2),
            "rpc_per_task_us": round(self.rpc_per_task_s * 1e6, 2),
            "empirical_metg_s": self.empirical_metg(),
            "n_emitted": self.n_emitted,
            "dropped": self.dropped,
        }
        if self.n_xfer:
            out["xfer"] = {
                "n": self.n_xfer,
                "bytes": self.xfer_bytes,
                "total_s": round(self.xfer_s, 6),
                "by_path": {p: {"n": n, "bytes": b,
                                "total_s": round(t, 6)}
                            for p, (n, b, t)
                            in sorted(self.xfer_by_path.items())},
            }
        if self.requests is not None:
            out["requests"] = self.requests.summary()
        return out


def crosscheck(scheduler: str, empirical_s: float, analytic_s: float,
               factor: float = 10.0) -> dict:
    """Cross-check an empirical overhead/METG against the analytic law
    value from `core.metg`.  `same_order` is True when the two agree
    to within `factor` (default: one order of magnitude)."""
    ratio = (empirical_s / analytic_s) if analytic_s > 0 else float("inf")
    return {
        "scheduler": scheduler,
        "empirical_s": empirical_s,
        "analytic_s": analytic_s,
        "ratio": ratio,
        "same_order": same_order(empirical_s, analytic_s, factor=factor),
    }
