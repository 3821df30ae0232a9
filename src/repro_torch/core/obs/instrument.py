"""Wiring: attach a `MetricsRegistry` to a live engine / client /
frontend; the port's copy of the JAX package's `repro.core.obs.instrument`.

Two attachment styles, matched to the hot-path budget:

  * **Callback instruments** (the default): counters and gauges built
    with `fn=` read values the engine and frontend maintain anyway —
    per-worker done/busy tables, ready depth, live workers, requeue and
    crash counts, admission counters.  Attaching them adds literally
    nothing to the dispatch loop; the cost is paid at scrape time.
  * **Push histograms** for the two latency streams that have no
    always-on accumulator: scheduler rpc round-trips (observed at the
    backend's already-sampled timing sites, so `rpc_sample=` thins the
    metric exactly like the trace) and per-request serving latency
    (observed in `Frontend._resolve`).

`instrument(registry, engine=... | client=... | frontend=...)` is
idempotent per target and returns the registry, so it chains:

    reg = instrument(MetricsRegistry(), client=client)

`Client.stats_server()` calls this for you and serves the result over
HTTP (`repro_torch.core.obs.server`).
"""
from __future__ import annotations

import os
from typing import Optional

from repro_torch.core.obs.metrics import (LATENCY_BUCKETS,
                                          MetricsRegistry)

# rpc round-trips live in the µs..ms decades; the tail of the default
# ladder would waste half the buckets on impossible multi-second rpcs
RPC_BUCKETS = tuple(b for b in LATENCY_BUCKETS if b <= 0.25)

_PAGE_SIZE = 4096
try:
    _PAGE_SIZE = os.sysconf("SC_PAGE_SIZE")
except (ValueError, OSError, AttributeError):  # pragma: no cover
    pass


def _pid_rss(pid: int) -> int:
    """Resident set size of `pid` in bytes via /proc/<pid>/statm (Linux;
    0 when the pid is gone or the platform has no procfs) — monitoring
    never fails the scrape."""
    if not pid:
        return 0
    try:
        with open(f"/proc/{pid}/statm", "rb") as f:
            return int(f.read().split()[1]) * _PAGE_SIZE
    except (OSError, IndexError, ValueError):
        return 0


def instrument_worker_rss(reg: MetricsRegistry, engine) -> None:
    """Per-process memory gauges for `transport="proc"`: one
    `repro_worker_rss_bytes{worker=}` callback gauge per handshaken
    worker process.  Idempotent (get-or-create) and pid-chasing: the
    callback re-reads the worker's CURRENT pid at scrape time, so a
    respawned worker reports its new process.  No-op for in-process
    transports (no pids to read)."""
    for w in engine.worker_pids():
        reg.gauge(
            "repro_worker_rss_bytes",
            "Worker process resident set size (transport=proc)",
            labels={"worker": w},
            fn=lambda e=engine, w=w: _pid_rss(e.worker_pids().get(w, 0)))


class RpcMetrics:
    """Per-op rpc latency histograms, cached so the backend's sampled
    timing site pays one dict hit + one observe per recorded call."""

    __slots__ = ("_registry", "_by_op")

    def __init__(self, registry: MetricsRegistry):
        self._registry = registry
        self._by_op: dict = {}

    def observe(self, op: str, dt: float):
        # the cache maps op -> BOUND Histogram.observe: the hot call is
        # one dict hit + one call, no attribute chase
        ob = self._by_op.get(op)
        if ob is None:
            h = self._registry.histogram(
                "repro_rpc_latency_seconds",
                "Scheduler round-trip latency per protocol verb "
                "(worker-side end-to-end, sampled like the trace)",
                labels={"op": op}, buckets=RPC_BUCKETS)
            ob = self._by_op[op] = h.observe
        ob(dt)


class XferMetrics:
    """Data-plane transfer metrics (transport="proc"): per-path latency
    histograms plus byte/count totals, fed by the engine's unsampled
    xfer attribution (`Engine._record_xfer`).  Bound observers are
    cached per path — there are only two ("peer"/"hub"), so the hot
    call is one dict hit."""

    __slots__ = ("_registry", "_by_path")

    def __init__(self, registry: MetricsRegistry):
        self._registry = registry
        self._by_path: dict = {}

    def observe(self, path: str, nbytes: int, dt: float):
        ent = self._by_path.get(path)
        if ent is None:
            lbl = {"path": path}
            h = self._registry.histogram(
                "repro_xfer_latency_seconds",
                "Dependency-value transfer latency per path "
                "(peer = producer's data listener, hub = front door)",
                labels=lbl, buckets=RPC_BUCKETS)
            b = self._registry.counter(
                "repro_xfer_bytes_total",
                "Serialized bytes moved per transfer path", labels=lbl)
            c = self._registry.counter(
                "repro_xfer_total",
                "Dependency-value transfers per path", labels=lbl)
            ent = self._by_path[path] = (h.observe, b.inc, c.inc)
        ent[0](dt)
        ent[1](nbytes)
        ent[2]()


class ServingMetrics:
    """Push-side serving metrics: the per-request latency histogram
    observed at response delivery (everything else about the frontend is
    readable from its own counters via callbacks).  Requests submitted
    with `tenant=` additionally land in a tenant-labelled histogram,
    cached per tenant so the delivery path pays one dict hit extra."""

    __slots__ = ("latency", "_failed", "_registry", "_index", "_by_tenant")

    def __init__(self, registry: MetricsRegistry, index: int = 0):
        lbl = {"frontend": str(index)}
        self._registry = registry
        self._index = index
        self._by_tenant: dict = {}     # tenant -> bound Histogram.observe
        self.latency = registry.histogram(
            "repro_request_latency_seconds",
            "Serving enqueue -> response latency", labels=lbl)
        self._failed = registry.counter(
            "repro_requests_failed_total",
            "Responses delivered with ok=False", labels=lbl)

    def observe_request(self, latency_s: float, ok: bool,
                        tenant: Optional[str] = None):
        self.latency.observe(latency_s)
        if not ok:
            self._failed.inc()
        if tenant is None:
            return
        ob = self._by_tenant.get(tenant)
        if ob is None:
            h = self._registry.histogram(
                "repro_request_latency_seconds",
                "Serving enqueue -> response latency",
                labels={"frontend": str(self._index), "tenant": tenant})
            ob = self._by_tenant[tenant] = h.observe
        ob(latency_s)


def _instrument_engine(reg: MetricsRegistry, engine) -> None:
    backend = engine.backend
    if getattr(backend, "metrics", None) is None:
        backend.metrics = RpcMetrics(reg)
    if getattr(engine, "xfer_metrics", None) is None:
        # data-plane attribution sink (populated only under
        # transport="proc"; zero-cost otherwise — nothing observes)
        engine.xfer_metrics = XferMetrics(reg)
    reg.gauge("repro_live_workers", "Workers currently alive",
              fn=engine.live_workers)
    reg.counter("repro_worker_deaths_total",
                "Workers killed (crash, injected fault, or lose_worker)",
                fn=lambda: engine.worker_deaths)
    reg.counter("repro_tasks_completed_total",
                "Tasks that finished ok on a worker",
                fn=lambda: engine.tasks_done_total() - engine.exec_failed)
    reg.counter("repro_tasks_failed_total",
                "Task executions that raised / returned not-ok",
                fn=lambda: engine.exec_failed)
    reg.counter("repro_requeued_total",
                "Tasks recycled by Exit or lease expiry",
                fn=backend._requeued_total)
    reg.counter("repro_task_retries_total",
                "Transient task failures re-enqueued by RetryPolicy",
                fn=lambda: engine.retries_total)
    reg.counter("repro_journal_bytes_total",
                "Bytes appended to the write-ahead journal",
                fn=lambda: (engine.journal.bytes_written
                            if engine.journal is not None else 0))
    reg.gauge("repro_ready_depth", "Tasks ready to steal, all shards",
              fn=backend.ready_depth)
    for i in range(getattr(backend, "n_shards", 1)):
        reg.gauge("repro_shard_ready_depth",
                  "Tasks ready to steal on one shard",
                  labels={"shard": str(i)},
                  fn=lambda b=backend, i=i: b.ready_depths()[i])
    tracer = engine.tracer
    reg.counter("repro_trace_events_total", "Trace events emitted",
                fn=lambda: tracer.n_emitted)
    reg.counter("repro_trace_dropped_total",
                "Trace events evicted by the ring buffer",
                fn=lambda: tracer.dropped)
    # proc transport: per-worker-process RSS (workers that join later are
    # folded in by the StatsServer at scrape time via the same call)
    instrument_worker_rss(reg, engine)


def _instrument_frontend(reg: MetricsRegistry, fe, index: int = 0) -> None:
    if getattr(fe, "metrics", None) is None:
        fe.metrics = ServingMetrics(reg, index=index)
    lbl = {"frontend": str(index)}
    reg.counter("repro_requests_accepted_total",
                "Requests admitted to the serving queue", labels=lbl,
                fn=lambda: fe.accepted)
    reg.counter("repro_requests_rejected_total",
                "Requests bounced by admission backpressure", labels=lbl,
                fn=lambda: fe.rejected)
    reg.counter("repro_requests_timeout_total",
                "Requests withdrawn after queueing past their deadline",
                labels=lbl, fn=lambda: fe.timeouts)
    reg.counter("repro_batches_total",
                "Engine tasks the requests were coalesced into",
                labels=lbl, fn=lambda: fe.batches)
    reg.gauge("repro_serving_queue_depth", "Requests waiting to batch",
              labels=lbl, fn=lambda: len(fe._queue))
    reg.gauge("repro_serving_target_batch", "Current METG batch target",
              labels=lbl, fn=fe.target_batch)


def _instrument_client(reg: MetricsRegistry, client) -> None:
    client._metrics = reg            # Client.serve() instruments later fes
    _instrument_engine(reg, client.engine)
    for i, fe in enumerate(client._frontends):
        _instrument_frontend(reg, fe, index=i)
    reg.counter("repro_futures_submitted_total", "Futures submitted",
                fn=lambda: client._submitted)
    reg.counter("repro_futures_resolved_total",
                "Futures that reached a terminal state",
                fn=lambda: client._futures_resolved)
    reg.gauge("repro_futures_pending", "Futures awaiting resolution",
              fn=lambda: len(client._futures))


def instrument(registry: Optional[MetricsRegistry] = None, *,
               engine=None, client=None, frontend=None,
               frontend_index: int = 0) -> MetricsRegistry:
    """Attach live metrics to the given target(s); builds a fresh
    registry when none is passed.  Safe to call more than once — the
    registry's get-or-create semantics make re-instrumentation a no-op."""
    reg = registry if registry is not None else MetricsRegistry()
    if client is not None:
        _instrument_client(reg, client)
    if engine is not None:
        _instrument_engine(reg, engine)
    if frontend is not None:
        _instrument_frontend(reg, frontend, index=frontend_index)
    return reg
