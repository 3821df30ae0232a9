"""Admission control + METG-aware dynamic batching for the resident engine;
the port's copy of the JAX package's `repro.core.serving.frontend`.

`Frontend` owns the request side of the serving subsystem: a bounded
admission queue with backpressure, a coalescer that packs requests into
engine tasks sized by the METG granularity laws (adapting to the live
worker count and observed per-request time), and a max-wait deadline so
tail latency is bounded even when traffic trickles.  See the package
docstring for the tuning guidance.

Monitoring (`snapshot()` / `start_snapshots(interval_s)`): the frontend
keeps a small windowed accumulator of per-request latencies and queue
depths, independent of the engine trace, so a long-lived resident
service can emit periodic `LatencyReport`s (p50/p95/p99 for the window
since the previous snapshot) with bounded state — no trace scan, no
trace retention requirement.  Snapshots land in the bounded
`Frontend.snapshots` deque and optionally a callback.
"""
from __future__ import annotations

import threading
from collections import deque
from typing import Callable, Optional

from repro_torch.core.engine.model import (BATCH_FORMED, REQ_DONE,
                                           REQ_ENQUEUED, REQ_REJECTED,
                                           REQ_TIMEOUT, WorkerCrash, next_seq)
from repro_torch.core.engine.tracing import LatencyReport, percentile, span
from repro_torch.core.metg import METGModel, pick_batch_size


class AdmissionFull(RuntimeError):
    """The admission queue is full (reject policy) or stayed full past the
    submit timeout (block policy) — the client should back off."""


class ServeRequest:
    """One in-flight request: resolved exactly once (re-executions after a
    worker death hit the already-set guard), waitable from any thread."""

    __slots__ = ("name", "payload", "meta", "tenant", "t_enqueue", "t_done",
                 "value", "ok", "error", "deadline", "timed_out", "_event")

    def __init__(self, name: str, payload, meta: Optional[dict],
                 t_enqueue: float, deadline: Optional[float] = None,
                 tenant: Optional[str] = None):
        self.name = name
        self.payload = payload
        self.meta = meta or {}
        self.tenant = tenant
        self.t_enqueue = t_enqueue
        self.t_done = 0.0
        self.value = None
        self.ok = False
        self.error: Optional[str] = None
        self.deadline = deadline       # absolute trace-clock dispatch cutoff
        self.timed_out = False         # expired in the queue, never ran
        self._event = threading.Event()

    def wait(self, timeout: Optional[float] = None) -> bool:
        """True once a response is delivered; False on timeout."""
        return self._event.wait(timeout)

    @property
    def done(self) -> bool:
        return self._event.is_set()

    @property
    def latency_s(self) -> float:
        """Enqueue -> response latency on the engine's trace clock."""
        return (self.t_done - self.t_enqueue) if self.done else 0.0

    def __repr__(self):
        state = ("ok" if self.ok else f"err={self.error!r}") if self.done \
            else "pending"
        return f"ServeRequest({self.name}, {state})"


class Frontend:
    """Enqueue requests, coalesce them into METG-sized engine tasks.

    `execute_batch(payloads)` runs on an engine worker and returns a list
    of per-request values (same order/length), a single value broadcast to
    the batch, or None.  Raising marks every request in the batch failed;
    raising `WorkerCrash` instead kills the worker and the batch is
    requeued, not failed (fault drills).

    A batch is dispatched when the queue reaches the current METG target
    (`pick_batch_size` at the live worker count and the observed
    per-request EWMA) or when the oldest queued request has waited
    `max_wait_s`, whichever comes first.
    """

    def __init__(self, engine, execute_batch: Callable, *,
                 max_queue: int = 256, max_batch: int = 64,
                 max_wait_s: float = 0.005, target_eff: float = 0.9,
                 per_request_s0: float = 1e-3, scheduler: str = "dwork",
                 model: Optional[METGModel] = None, policy: str = "block",
                 snapshot_interval_s: Optional[float] = None,
                 snapshot_keep: int = 120,
                 on_snapshot: Optional[Callable] = None):
        if policy not in ("block", "reject"):
            raise ValueError(f"unknown backpressure policy {policy!r}")
        if not engine.resident:
            raise ValueError("Frontend requires Engine(resident=True)")
        self.engine = engine
        self.execute_batch = execute_batch
        self.max_queue = max(int(max_queue), 1)
        self.max_batch = max(int(max_batch), 1)
        self.max_wait_s = max_wait_s
        self.target_eff = target_eff
        self.scheduler = scheduler
        self.model = model or METGModel.from_paper()
        self.policy = policy
        self._per_req_s = max(per_request_s0, 1e-9)  # observed-time EWMA
        self._ewma_alpha = 0.2
        self._queue: deque[ServeRequest] = deque()
        self._cond = threading.Condition()
        self._closing = False
        self._force_flush = False
        self.accepted = 0
        self.rejected = 0
        self.timeouts = 0              # queued past their deadline
        self._n_deadlines = 0          # queued requests carrying a deadline
        self.batches = 0
        # optional serving-metrics sink
        # (repro_torch.core.obs.ServingMetrics):
        # observed at response delivery, beside the REQ_DONE emit
        self.metrics = None
        self._thread: Optional[threading.Thread] = None
        # ---------------------------------------- monitoring snapshots
        # windowed accumulator, reset on every snapshot(): bounded by the
        # traffic of one window, never by service lifetime.  Accumulation
        # only runs while monitoring is ARMED (ctor interval,
        # start_snapshots(), or a priming snapshot() call) — a frontend
        # nobody ever snapshots must not grow these lists forever.
        self._monitoring = snapshot_interval_s is not None
        self.snapshot_interval_s = snapshot_interval_s
        self.on_snapshot = on_snapshot
        self.snapshots: deque[LatencyReport] = deque(
            maxlen=max(int(snapshot_keep), 1))
        self._snap_lock = threading.Lock()
        self._snap_t0 = engine.tracer.clock()
        self._w_lats: list[float] = []
        self._w_failed = 0
        self._w_rejected = 0
        # tenant -> [lats, n_failed, n_rejected]: the per-tenant slice of
        # the same window, populated only for requests that carry tenant=
        self._w_tenants: dict = {}
        self._w_batches = 0
        self._w_batched = 0
        self._w_wait_s = 0.0
        self._w_depths: list[int] = []
        self._snap_stop = threading.Event()
        self._snap_thread: Optional[threading.Thread] = None

    # ----------------------------------------------------------- lifecycle
    def start(self) -> "Frontend":
        """Start the coalescer (and the engine's resident loop if the
        caller hasn't already)."""
        if self._thread is not None:
            raise RuntimeError("frontend already started")
        if not self.engine.started:
            self.engine.start()
        self._closing = False
        self._thread = threading.Thread(target=self._coalesce_loop,
                                        name="serving-frontend", daemon=True)
        self._thread.start()
        if self.snapshot_interval_s is not None:
            self.start_snapshots(self.snapshot_interval_s)
        return self

    def close(self, *, drain: bool = True,
              timeout: Optional[float] = None) -> bool:
        """Stop admitting, flush the queue as final batches, and (with
        `drain=True`) wait for every dispatched batch to finish.  Does NOT
        shut the engine down — that is the engine owner's call."""
        monitoring = self._monitoring
        self.stop_snapshots(final=False)
        with self._cond:
            self._closing = True
            self._cond.notify_all()
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        ok = self.engine.drain(timeout) if drain else True
        if monitoring:
            # the tail window: requests that resolved during the flush +
            # drain above must reach the monitor too, so the final
            # snapshot is taken AFTER the drain, not before it
            self.snapshot()
        return ok

    # ------------------------------------------------------------- client
    def submit(self, payload, *, meta: Optional[dict] = None,
               timeout: Optional[float] = None,
               tenant: Optional[str] = None) -> ServeRequest:
        """Admit one request.  With a full queue: `policy="reject"` raises
        `AdmissionFull` immediately; `policy="block"` waits for space up
        to `timeout` seconds (None = forever) and then raises.

        `timeout` is also the request's QUEUE DEADLINE: once admitted, a
        request still undispatched `timeout` seconds after its enqueue is
        withdrawn and resolved with `ok=False`, `timed_out=True`, and a
        `TimeoutError` repr in `error` (plus a `REQ_TIMEOUT` trace
        event) — overload sheds the oldest deadline work instead of
        serving unboundedly stale responses.  A dispatched request always
        runs to completion; the deadline only covers queue wait.

        `tenant` labels the request for per-tenant observability: the
        label rides the REQ_* trace events, the windowed snapshots
        (`LatencyReport.by_tenant`, visible in `/stats`), and the
        `repro_request_latency_seconds{tenant=...}` histogram when a
        metrics registry is attached.  Purely observational — admission
        and batching never look at it."""
        tracer = self.engine.tracer
        with self._cond:
            if self._closing:
                raise RuntimeError("frontend is closed")
            if len(self._queue) >= self.max_queue:
                blocked = (self.policy == "block"
                           and (timeout is None or timeout > 0)
                           and self._cond.wait_for(
                               lambda: (len(self._queue) < self.max_queue
                                        or self._closing), timeout))
                if not blocked or self._closing:
                    self.rejected += 1
                    if tenant is None:
                        tracer.emit(REQ_REJECTED, depth=len(self._queue),
                                    policy=self.policy)
                    else:
                        tracer.emit(REQ_REJECTED, depth=len(self._queue),
                                    policy=self.policy, tenant=tenant)
                    if self._monitoring:
                        with self._snap_lock:
                            self._w_rejected += 1
                            if tenant is not None:
                                self._w_tenant(tenant)[2] += 1
                    raise AdmissionFull(
                        f"admission queue full ({self.max_queue})")
            # next_seq(): engine task names are single-use forever, so
            # request/batch names must be unique across every frontend
            # that ever shares an engine (or a task server)
            t_enq = tracer.clock()
            req = ServeRequest(
                f"__req{next_seq()}", payload, meta, t_enqueue=t_enq,
                deadline=(t_enq + timeout) if timeout is not None else None,
                tenant=tenant)
            self._queue.append(req)
            if req.deadline is not None:
                self._n_deadlines += 1
            self.accepted += 1
            depth = len(self._queue)
            if tenant is None:
                tracer.emit(REQ_ENQUEUED, task=req.name, depth=depth)
            else:
                tracer.emit(REQ_ENQUEUED, task=req.name, depth=depth,
                            tenant=tenant)
            self._cond.notify_all()
        if self._monitoring:
            with self._snap_lock:
                self._w_depths.append(depth)
        return req

    def flush(self):
        """Dispatch whatever is queued right now without waiting for the
        batch target or deadline (deterministic tests, graceful drains)."""
        with self._cond:
            self._force_flush = True
            self._cond.notify_all()

    # ------------------------------------------------------------ batching
    def target_batch(self) -> int:
        """Current METG-aware batch target: the granularity at which
        scheduling overhead stays under (1 - target_eff) of compute, for
        the LIVE worker count, the observed per-request time, and the
        engine's shard count (a sharded hub — alone or behind the tree —
        divides the dispatch bound, so batches can shrink)."""
        live = max(self.engine.live_workers(), 1)
        n = pick_batch_size(self.scheduler, live, self._per_req_s,
                            target_eff=self.target_eff, model=self.model,
                            shards=getattr(self.engine, "shards", 1))
        return max(1, min(n, self.max_batch))

    def _coalesce_loop(self):
        clock = self.engine.tracer.clock
        while True:
            with self._cond:
                while True:
                    if self._n_deadlines:
                        self._expire_overdue(clock())
                    if self._closing:
                        break
                    n = len(self._queue)
                    target = self.target_batch()
                    if n >= target:
                        break
                    if n and self._force_flush:
                        break
                    wait = None
                    if n:
                        age = clock() - self._queue[0].t_enqueue
                        if age >= self.max_wait_s:
                            break
                        # under a ManualClock `age` may never advance;
                        # the floor keeps the wait finite either way
                        wait = max(self.max_wait_s - age, 1e-4)
                    if self._n_deadlines:
                        # wake at the earliest queue deadline too, so an
                        # expiry is detected promptly even when the batch
                        # deadline is far off
                        earliest = min(r.deadline for r in self._queue
                                       if r.deadline is not None)
                        dl = max(earliest - clock(), 1e-4)
                        wait = dl if wait is None else min(wait, dl)
                    self._cond.wait(wait)
                self._force_flush = False
                if not self._queue:
                    if self._closing:
                        return
                    continue
                take = min(len(self._queue), max(self.target_batch(), 1))
                batch = [self._queue.popleft() for _ in range(take)]
                if self._n_deadlines:
                    self._n_deadlines -= sum(1 for r in batch
                                             if r.deadline is not None)
                depth_after = len(self._queue)
                self._cond.notify_all()      # space freed: wake submitters
            try:
                self._dispatch(batch, depth_after)
            except Exception as e:            # noqa: BLE001
                # a dispatch failure (engine shut down under us, backend
                # error) must never strand waiters — fail the batch loudly
                err = repr(e)
                for r in batch:
                    self._resolve(r, ok=False, error=err)

    def _expire_overdue(self, now: float):
        """Withdraw every queued request past its deadline and resolve it
        as timed out (caller holds `self._cond`)."""
        expired = [r for r in self._queue
                   if r.deadline is not None and now >= r.deadline]
        if not expired:
            return
        dead = set(map(id, expired))
        self._queue = deque(r for r in self._queue if id(r) not in dead)
        self._n_deadlines -= len(expired)
        self.timeouts += len(expired)
        tracer = self.engine.tracer
        for r in expired:
            r.timed_out = True
            tracer.emit(REQ_TIMEOUT, task=r.name,
                        waited_s=now - r.t_enqueue)
            self._resolve(r, ok=False, error=repr(TimeoutError(
                f"{r.name}: queued past its deadline")))
        self._cond.notify_all()          # space freed: wake submitters

    def _dispatch(self, batch: list, depth_after: int):
        tracer = self.engine.tracer
        self.batches += 1
        name = f"__batch{next_seq()}"
        now = tracer.clock()
        wait_s = now - batch[0].t_enqueue
        tracer.emit(BATCH_FORMED, task=name, size=len(batch),
                    wait_s=wait_s, target=self.target_batch(),
                    depth=depth_after)
        if self._monitoring:
            with self._snap_lock:
                self._w_batches += 1
                self._w_batched += len(batch)
                self._w_wait_s += wait_s
                self._w_depths.append(depth_after)
        reqs = tuple(batch)
        self.engine.submit(name, fn=lambda: self._run_batch(reqs))

    def _run_batch(self, reqs: tuple):
        """One batch on an engine worker, in three spans on the engine's
        tracer: `serve.batch` (extra: `size`, and `wait_sum_s`, the sum of
        the requests' waits from enqueue to the batch's start) around
        `serve.execute` (the model's call) and `serve.resolve` (the
        replies)."""
        tracer = self.engine.tracer
        with span("serve.batch", tracer, size=len(reqs)) as batch:
            batch.extra["wait_sum_s"] = sum(batch.t0 - r.t_enqueue
                                            for r in reqs)
            try:
                with span("serve.execute", tracer):
                    t0 = tracer.clock()
                    values = self.execute_batch([r.payload for r in reqs])
                    dt = tracer.clock() - t0
            except WorkerCrash:
                raise          # worker dies; the engine requeues the batch
            except Exception as e:                        # noqa: BLE001
                err = repr(e)
                for r in reqs:
                    self._resolve(r, ok=False, error=err)
                raise      # the batch task is marked failed, consistently
            a = self._ewma_alpha
            self._per_req_s = ((1 - a) * self._per_req_s
                               + a * max(dt / len(reqs), 1e-9))
            with span("serve.resolve", tracer):
                if (isinstance(values, (list, tuple))
                        and len(values) == len(reqs)):
                    for r, v in zip(reqs, values):
                        self._resolve(r, ok=True, value=v)
                else:
                    for r in reqs:
                        self._resolve(r, ok=True, value=values)
        return True

    def _resolve(self, req: ServeRequest, *, ok: bool, value=None,
                 error: Optional[str] = None):
        if req._event.is_set():
            return             # re-execution after a requeue: deliver once
        tracer = self.engine.tracer
        req.value = value
        req.ok = ok
        req.error = error
        req.t_done = tracer.clock()
        latency_s = req.t_done - req.t_enqueue
        if req.tenant is None:
            tracer.emit(REQ_DONE, task=req.name, worker=None,
                        latency_s=latency_s, ok=ok)
        else:
            tracer.emit(REQ_DONE, task=req.name, worker=None,
                        latency_s=latency_s, ok=ok, tenant=req.tenant)
        m = self.metrics
        if m is not None:
            m.observe_request(latency_s, ok, tenant=req.tenant)
        if self._monitoring:
            with self._snap_lock:
                self._w_lats.append(latency_s)
                if not ok:
                    self._w_failed += 1
                if req.tenant is not None:
                    slot = self._w_tenant(req.tenant)
                    slot[0].append(latency_s)
                    if not ok:
                        slot[1] += 1
        req._event.set()

    def _w_tenant(self, tenant: str) -> list:
        """The window accumulator slot for one tenant: [lats, failed,
        rejected] (caller holds `self._snap_lock`)."""
        slot = self._w_tenants.get(tenant)
        if slot is None:
            slot = self._w_tenants[tenant] = [[], 0, 0]
        return slot

    # ---------------------------------------------------------- snapshots
    def snapshot(self) -> LatencyReport:
        """One windowed `LatencyReport` covering the requests resolved
        since the previous snapshot (or since monitoring was armed),
        appended to the bounded `self.snapshots` deque.  State is bounded
        by one window's traffic, not service lifetime — monitoring for
        long-lived resident services that run with `max_trace_events=`
        ring buffers (or no trace retention at all).

        Monitoring arms on the ctor's `snapshot_interval_s`, on
        `start_snapshots()`, or on the FIRST call here — that priming
        call returns an empty window (nothing was accumulating before),
        and every later window is complete."""
        clock = self.engine.tracer.clock
        self._monitoring = True
        with self._snap_lock:
            lats = self._w_lats
            depths = self._w_depths
            n_failed, self._w_failed = self._w_failed, 0
            n_rejected, self._w_rejected = self._w_rejected, 0
            n_batches, self._w_batches = self._w_batches, 0
            batched, self._w_batched = self._w_batched, 0
            wait_s, self._w_wait_s = self._w_wait_s, 0.0
            tenants, self._w_tenants = self._w_tenants, {}
            self._w_lats = []
            self._w_depths = []
            t1 = clock()
            t0, self._snap_t0 = self._snap_t0, t1
        lats.sort()
        by_tenant = None
        if tenants:
            by_tenant = {}
            for tenant, (tlats, tfailed, trejected) in sorted(
                    tenants.items()):
                tlats.sort()
                by_tenant[tenant] = LatencyReport._tenant_slice(
                    tlats, n_failed=tfailed, n_rejected=trejected)
        rep = LatencyReport(
            n_requests=len(lats),
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
            t_s=t1,
            window_s=max(t1 - t0, 0.0),
            by_tenant=by_tenant,
        )
        self.snapshots.append(rep)
        if self.on_snapshot is not None:
            try:
                self.on_snapshot(rep)
            except Exception:    # noqa: BLE001 — monitoring must never
                pass             # take the serving path down
        return rep

    def start_snapshots(self, interval_s: float) -> "Frontend":
        """Spawn the periodic monitor: every `interval_s` a windowed
        snapshot() lands in `self.snapshots` (and `on_snapshot`, if
        set).  Idempotent; stopped by `stop_snapshots()` / `close()`."""
        if self._snap_thread is not None:
            return self
        self._monitoring = True
        self.snapshot_interval_s = interval_s
        self._snap_stop.clear()

        def _loop():
            while not self._snap_stop.wait(self.snapshot_interval_s):
                self.snapshot()

        self._snap_thread = threading.Thread(
            target=_loop, name="serving-snapshots", daemon=True)
        self._snap_thread.start()
        return self

    def stop_snapshots(self, *, final: bool = True):
        """Stop the periodic monitor; with `final=True` (default) take
        one last snapshot so the tail window is not lost."""
        th, self._snap_thread = self._snap_thread, None
        if th is None:
            return
        self._snap_stop.set()
        th.join()
        if final:
            self.snapshot()

    # ---------------------------------------------------------------- obs
    def stats(self) -> dict:
        with self._cond:
            depth = len(self._queue)
        return {
            "accepted": self.accepted, "rejected": self.rejected,
            "timeouts": self.timeouts,
            "batches": self.batches, "queue_depth": depth,
            "target_batch": self.target_batch(),
            "per_request_ewma_s": self._per_req_s,
            "live_workers": self.engine.live_workers(),
            "engine_ready_depth": self.engine.backend.ready_depth(),
        }
