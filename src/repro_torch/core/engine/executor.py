"""The unified worker pool: one execution substrate for all three schedulers,
the port's copy of the JAX package's `repro.core.engine.executor`.

A single dispatch loop drives virtual workers against a scheduler backend
(`ServerBackend` / `ShardedBackend` / `TreeBackend`), generalizing the
paper's three execution loops:

  * dwork  (§2.2) — workers Steal-n batches and Complete tasks; the loop
    IS the paper's Fig. 2 CLIENT-LOOP, with per-worker fault injection.
  * pmake  (§2.1) — tasks carry `slots` (nodes) and `priority` (EFT);
    the launch step is pmake's "greedy highest-priority-first onto free
    nodes", with `capacity` total slots.
  * mpi-list (§2.3) — each bulk step submits one task per rank; per-rank
    times (plus injected straggler jitter) feed the Gumbel sync-gap model.

Transports:
  * "inproc" — tasks run inline in the dispatch loop; fully deterministic
    (round-robin steal order, no threads, injectable clock) — the default
    for tests, fault injection, and pure-overhead measurement.
  * "thread" — a slot-bounded thread pool; real concurrency for workloads
    that block (pmake's popen'd scripts).
  * "tree"   — like inproc, but every worker RPC crosses a real TCP
    message-forwarding tree (paper §4): `tree_fanout` workers per leaf
    `Forwarder`, `tree_levels` relay layers, pipelined shared upstream
    links, per-hop `rpc` trace events.

Modes:
  * batch (default) — `run()` drains a pre-submitted task universe and
    returns when every task reaches a terminal state (or the pool stalls).
  * resident (`Engine(resident=True)`) — `start()` runs the same dispatch
    loop open-ended in a background thread; `submit()` keeps accepting
    work while workers are live (thread-safe), `drain()` blocks until the
    submitted universe is terminal, `shutdown()` stops the loop and
    returns the `EngineReport`.  `add_worker()` / `lose_worker()` change
    pool membership on the fly, and `self.steal_n` is re-read every round
    so batch size can track the live worker count.  Faults, heartbeat
    leases, and lifecycle tracing behave exactly as in batch mode; a
    server-side "all done" is treated as "idle" rather than termination
    until `shutdown()` is requested.  While idle, steals back off to one
    probe per `IDLE_PROBE_ROUNDS` rounds (a new `submit()` wakes the pool
    immediately via a submission epoch) so an idle service doesn't flood
    the trace with empty round-trips.  `repro_torch.core.serving.Frontend`
    layers admission control and dynamic request batching on top.

Hot path: completions are buffered per worker and piggybacked onto that
worker's next steal as ONE `CompleteSteal` round-trip (the Fig. 2
batch-then-drain rhythm — `steal_n` amortizes both protocol directions),
the pending set is a priority heap with incrementally-maintained
per-worker outstanding counts (no per-round rescans/sorts), and every
lifecycle transition is emitted to the `TraceRecorder`, from which
`tracing.OverheadReport` computes empirical per-task overhead and METG.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from heapq import heapify, heappop, heappush
from pathlib import Path
from typing import Callable, Optional

from repro_torch.core.dwork.api import Fetch, ValueMsg
from repro_torch.core.engine.backends import DONE, EMPTY
from repro_torch.core.engine.comm import core as comm_core
from repro_torch.core.engine.comm.serialize import (RemoteValue, dumps_call,
                                                    loads)
from repro_torch.core.engine.faults import FaultPlan
from repro_torch.core.engine.journal import Journal
from repro_torch.core.engine.model import (CANCELLED, COMPLETED, CREATED,
                                           FAILED, READY, REQUEUED, RETRIED,
                                           RUN_END, RUN_START, STOLEN,
                                           WORKER_DEAD, XFER, EngineTask,
                                           RetryPolicy, TaskResult,
                                           WorkerCrash)
from repro_torch.core.engine.tracing import OverheadReport, TraceRecorder

# transport families live in the comm registry (repro_torch.core.engine.comm);
# this tuple stays as the public "what can I pass" surface
TRANSPORTS = comm_core.transport_names()

# resident idle backoff: with no pending submissions, each worker probes
# the server once per this many rounds (lease reaping still happens on
# probes); a submit() bumps the epoch and re-enables steals immediately
IDLE_PROBE_ROUNDS = 16


@dataclass
class EngineReport:
    results: dict                      # task -> TaskResult (last execution)
    trace: TraceRecorder
    workers: int                       # effective parallelism (overhead math)
    wall_s: float
    pool_workers: int = 1              # configured pool size (reporting)
    errors: set = field(default_factory=set)
    stalled: bool = False
    backend_stats: dict = field(default_factory=dict)

    @property
    def completed(self) -> set:
        return {n for n, r in self.results.items() if r.ok}

    def overhead(self) -> OverheadReport:
        return self.trace.report(workers=self.workers)


class Engine:
    def __init__(self, *, workers: int = 1, capacity: Optional[int] = None,
                 transport: str = "inproc", steal_n: int = 1, shards: int = 1,
                 backend=None, tracer: Optional[TraceRecorder] = None,
                 faults: Optional[FaultPlan] = None, clock=None,
                 lease_timeout: Optional[float] = None, poll: float = 0.001,
                 max_idle_rounds: Optional[int] = None, tree_fanout: int = 4,
                 tree_levels: int = 1, resident: bool = False,
                 keep_results: bool = True,
                 on_result: Optional[Callable] = None,
                 retry: Optional[RetryPolicy] = None,
                 journal=None, proc_host: str = "127.0.0.1",
                 proc_port: int = 0, heartbeat_s: float = 0.5,
                 inline_bytes: int = 65536,
                 spill_bytes: int = 64 * 1024 * 1024):
        fam = comm_core.family(transport)   # raises on an unknown name
        self.workers = max(int(workers), 0)
        self.capacity = capacity if capacity is not None else max(workers, 1)
        self.transport = transport
        self.steal_n = max(int(steal_n), 1)
        self.faults = faults
        # engine-wide transient-failure policy (per-task `retry=` on
        # submit overrides it); None = a failure poisons immediately
        self.retry = retry
        # durable control plane: a write-ahead `Journal` (or a directory
        # path, which constructs and OWNS one — closed when the dispatch
        # loop exits).  Off by default: journaling is opt-in so the
        # fault-free hot path pays only a None check.
        self._owns_journal = isinstance(journal, (str, Path))
        self.journal = Journal(journal) if self._owns_journal else journal
        self.poll = poll
        self.lease_timeout = lease_timeout
        self.heartbeat_s = max(float(heartbeat_s), 0.05)
        # peer-to-peer data plane knobs (transport="proc"): results above
        # `inline_bytes` serialized payload stay in the producing worker's
        # local store (the hub tracks the LOCATION); `spill_bytes` is each
        # worker's LRU byte budget before owned values spill to the hub
        self.inline_bytes = max(int(inline_bytes), 0)
        self.spill_bytes = max(int(spill_bytes), 0)
        self.resident = bool(resident)
        # result plumbing for the futures client: `on_result(name, ok,
        # res, error)` fires exactly once per task name, at its FIRST
        # terminal transition (requeued re-executions never re-fire),
        # always outside the engine lock so the handler may call back in.
        # `res` is the TaskResult when the task executed here, None for
        # poisoned/cancelled/fail-fast tasks.  The handler must not raise
        # (a raise would kill the dispatch loop); the client guards its
        # user-visible callbacks itself.
        self.on_result = on_result
        # called (once, from the dying loop thread) if the resident
        # dispatch loop exits with an error, so a client can fail its
        # pending futures instead of leaving waiters hanging until
        # shutdown() re-raises
        self.on_loop_error: Optional[Callable] = None
        # resident services that hold results elsewhere (futures) can opt
        # out of the EngineReport.results history table (bounded state)
        self.keep_results = bool(keep_results)
        self.tracer = tracer or TraceRecorder(clock=clock)
        self._owns_backend = backend is None
        if backend is None:
            # the comm registry owns the backend recipe per transport
            # family (shards > 1 composes inside each builder: a
            # ShardedHub behind the tree, or sharded under proc)
            backend = fam.make_backend(
                workers=self.workers, shards=shards,
                lease_timeout=lease_timeout, clock=clock,
                tracer=self.tracer, tree_fanout=tree_fanout,
                tree_levels=tree_levels, steal_n=self.steal_n,
                resident=self.resident, proc_host=proc_host,
                proc_port=proc_port, heartbeat_s=self.heartbeat_s,
                inline_bytes=self.inline_bytes,
                spill_bytes=self.spill_bytes)
        else:
            if getattr(backend, "tracer", None) is None:
                backend.tracer = self.tracer
            if transport == "proc":
                from repro_torch.core.engine.comm.proc import ProcBackend

                if not isinstance(backend, ProcBackend):
                    # a caller-supplied TaskServer/hub adaptation (the
                    # run_pool shim): front it with the process door.
                    # The wrapper's listener/processes are ours to close
                    # even though the inner backend is not.
                    backend = ProcBackend(
                        backend, host=proc_host, port=proc_port,
                        steal_n=self.steal_n, resident=self.resident,
                        heartbeat_s=self.heartbeat_s, owns_inner=False,
                        inline_bytes=self.inline_bytes,
                        spill_bytes=self.spill_bytes)
                    self._owns_backend = True
        self.backend = backend
        if self.journal is not None:
            # backends journal the requeue records their verbs observe
            # (Exit recycling, lease expiry) — the engine journals
            # create/terminal itself
            backend.journal = self.journal
        # the dispatch-rate multiplier the METG retunes see (serving
        # batch targets, elastic steal_n): authoritative from the
        # backend, so a caller-supplied hub/backend is counted too
        self.shards = getattr(backend, "n_shards", max(int(shards), 1))
        # long enough for a heartbeat lease to expire while idling
        if max_idle_rounds is None:
            max_idle_rounds = 500
            if lease_timeout:
                max_idle_rounds = max(500, int(2 * lease_timeout / poll))
        self.max_idle_rounds = max_idle_rounds
        # engine-local task registry (fn/priority/slots + ready tracking)
        self.tasks: dict[str, EngineTask] = {}
        self._waiting: dict[str, set] = {}
        self._succs: dict[str, list] = {}
        self._pass_worker = False
        # ---------------------------------------------- resident-mode state
        # _cond guards the registry + counters that submit() (any thread)
        # and the dispatch loop both touch; batch mode never takes it.
        # Built over a plain Lock: the re-entrancy of the default RLock is
        # never needed, and both threads take this once per task/batch, so
        # acquisition cost is on the submit hot path.
        self._cond = threading.Condition(threading.Lock())
        self._inflight = 0              # submitted, not yet terminal
        self._terminal: set[str] = set()
        self._failed: set[str] = set()
        self._epoch = 0                 # bumped on submit/requeue: wakes idle
        # resident submissions go through a mailbox: submit() appends
        # under a SHORT _cond hold (atomic w.r.t. cancel and the prune
        # keep-set) and the dispatch loop ingests in batches on its own
        # thread — the single-writer rule that keeps client threads off
        # the server lock on every task.  `_unsent` tracks names still
        # in the mailbox so cancel() can withdraw them engine-side.
        self._mailbox: deque = deque()
        self._unsent: set[str] = set()
        self._commands: deque = deque()  # ("add"|"lose", worker) membership
        self._live = self.workers       # live (not dead) worker count
        self._next_wid = self.workers   # auto worker naming for add_worker()
        self._stop = False              # drain-then-exit requested
        self._abort = False             # exit now, abandon pending work
        self._thread: Optional[threading.Thread] = None
        self._report: Optional[EngineReport] = None
        self._loop_error: Optional[BaseException] = None
        # -------------------------------------------------- observability
        # plain tables the dispatch loop maintains unconditionally (one
        # list-slot hit per completion); `repro_torch.core.obs` reads them via
        # zero-cost callback instruments, and worker_stats()/
        # tasks_done_total() are the monitoring probes over them
        self.worker_deaths = 0
        self.exec_failed = 0                  # executions raised / not-ok
        self.retries_total = 0                # re-enqueues by RetryPolicy
        self._attempts: dict[str, int] = {}   # failed executions per task
        self._wstats: dict[str, list] = {}    # worker -> [done_n, busy_s]
        self._dead_workers: set = set()
        # ---------------------------------------------- data plane (proc)
        # transfer attribution: per-path [count, bytes, seconds] totals
        # (every fetch is counted — xfer events are not sampled), plus an
        # optional obs sink (repro_torch.core.obs wires XferMetrics here)
        self.xfer_totals = {"peer": [0, 0, 0.0], "hub": [0, 0, 0.0]}
        self.xfer_metrics = None
        self.xfer_lost_total = 0              # lost-value recomputes issued
        self._xfer_lock = threading.Lock()    # totals vs. Future.result()
        self._xfer_conns: dict = {}           # data_addr -> Comm (engine)
        self._xfer_attempts: dict = {}        # lost name -> recompute count
        self._xfer_pending: dict = {}         # lost name -> recompute alias
        self._xfer_wanted: set = set()        # reader-requested recomputes
        self._loop_live = False               # dispatch loop can recompute
        # names whose payloads must survive prune_terminal: a done future
        # holding a RemoteValue that was lifted into a later submit's
        # arguments (the dependent has no dep edge the keep-set would see)
        self._pinned: set = set()

    # ------------------------------------------------------------- submit
    def submit(self, name: str, fn: Optional[Callable] = None, *,
               deps=(), meta: Optional[dict] = None, priority: float = 0.0,
               slots: int = 1,
               retry: Optional[RetryPolicy] = None) -> EngineTask:
        """Register a task.  Submit producers before dependents: the task
        server forward-declares an unknown dep as a READY stub and treats
        a later Create of the same name as a no-op (dwork §2.2 semantics),
        so a dependent submitted first would run before its producer.
        In resident mode this is thread-safe and may be called while the
        dispatch loop is running.  `retry` overrides the engine-wide
        `RetryPolicy` for this task."""
        if self.transport == "proc" and fn is not None:
            meta = dict(meta or {})
            if "__call__" not in meta:
                # pack the callable for the worker process NOW: an
                # unpicklable fn raises SerializationError at submit
                # time, naming the task — never opaquely in a worker
                meta["__call__"] = dumps_call(fn, task=name)
        task = EngineTask(name=name, fn=fn, deps=tuple(deps),
                          meta=dict(meta or {}), slots=max(int(slots), 1),
                          priority=priority, retry=retry)
        if not self.resident:
            self.tasks[name] = task
            self.backend.create(name, deps=task.deps, meta=task.meta)
            if self.journal is not None:
                self.journal.append_create(name, task.deps, task.meta)
            if task.deps:
                # deps ride the CREATED event so a saved/exported trace is
                # self-describing for critical-path analysis; dep-less
                # tasks (the dispatch hot path) keep the bare emit
                self.tracer.emit(CREATED, task=name, deps=list(task.deps))
                self._waiting[name] = set(task.deps)
                for d in task.deps:
                    self._succs.setdefault(d, []).append(name)
            else:
                self.tracer.emit(CREATED, task=name)
                self.tracer.emit(READY, task=name)
            return task
        # resident: mailbox enqueue.  The dispatch loop ingests creates in
        # batches at the top of its round (graph registration, failed-dep
        # fail-fast, server Create, _inflight accounting — all on the
        # loop thread), so a submitting client thread never crosses the
        # SERVER lock per task — the cross-thread lock+GIL ping-pong that
        # used to dominate per-future overhead.  The short _cond hold
        # here is cheap (the loop takes _cond per round/batch, not per
        # task) and makes submission atomic w.r.t. prune_terminal's
        # keep-set snapshot.  The task server keys history by name
        # forever, so a duplicate Create is a server-side no-op —
        # accepting one here would count an _inflight slot that never
        # drains and wedge drain()/shutdown(): names are single-use.
        with self._cond:
            if name in self.tasks:
                raise ValueError(f"task name {name!r} already submitted "
                                 "(resident task names are single-use)")
            self.tasks[name] = task
            self._unsent.add(name)
            self._mailbox.append(task)
            self._epoch += 1   # wakes an idle-probing loop immediately
        return task

    def _ingest_mailbox(self):
        """Dispatch-thread ingestion of mailboxed submissions: register
        the engine-side graph, fail-fast tasks whose producer already
        failed, count `_inflight`, then Create server-side — the
        single-writer half of the mailboxed resident submit()."""
        notify = self.on_result
        pending: list = []
        creates: list = []
        emit = self.tracer.emit
        with self._cond:
            while self._mailbox:
                task = self._mailbox.popleft()
                name = task.name
                self._unsent.discard(name)
                if name in self._terminal:
                    continue                      # cancelled before ingest
                live = None
                if task.deps:
                    failed_dep = next((d for d in task.deps
                                       if d in self._failed), None)
                    if failed_dep is not None:
                        # the producer already failed: creating this
                        # server-side would dangle forever (the server
                        # poisons successors at failure time, not at
                        # create time) — fail it engine-side
                        self._terminal.add(name)
                        self._failed.add(name)
                        why = f"dependency {failed_dep} failed"
                        emit(CREATED, task=name, deps=list(task.deps))
                        emit(FAILED, task=name, error=why)
                        j = self.journal
                        if j is not None:
                            j.append_create(name, task.deps, task.meta)
                            j.append_terminal(name, False, why)
                        if notify is not None:
                            pending.append((name, False, None, why))
                        continue
                    live = [d for d in task.deps
                            if d not in self._terminal]
                    if live:
                        self._waiting[name] = set(live)
                        for d in live:
                            self._succs.setdefault(d, []).append(name)
                self._inflight += 1
                creates.append((task, not live))
            if self._inflight <= 0:
                self._cond.notify_all()   # every ingested task failed fast
        if creates:
            self.backend.create_many(
                [(t.name, t.deps, t.meta) for t, _ in creates])
            # CREATED/READY stamped here, on the loop thread, so a
            # submitting client thread adds no events (and no span) of
            # its own — the dispatch window stays the measured quantity,
            # exactly as on the batch path where creation precedes run()
            j = self.journal
            for task, ready in creates:
                if j is not None:
                    j.append_create(task.name, task.deps, task.meta)
                if task.deps:
                    emit(CREATED, task=task.name, deps=list(task.deps))
                else:
                    emit(CREATED, task=task.name)
                if ready:
                    emit(READY, task=task.name)
        for note in pending:
            notify(*note)

    def _on_terminal(self, name: str):
        if self.resident:
            with self._cond:
                self._on_terminal_unlocked(name)
        else:
            self._on_terminal_unlocked(name)

    def _on_terminal_unlocked(self, name: str):
        if name not in self._succs:
            return
        for succ in self._succs.pop(name):
            w = self._waiting.get(succ)
            if w is None:
                continue
            w.discard(name)
            if not w:
                del self._waiting[succ]
                self.tracer.emit(READY, task=succ)

    def _note_terminal(self, name: str, ok: bool, res=None,
                       error: Optional[str] = None):
        """Terminal bookkeeping: count a task's FIRST terminal state so
        `drain()` can wait on the submitted universe, and deliver it to
        `on_result` exactly once.  A failure walks the engine-side
        successor graph the way the server poisons its own, so
        transitively-doomed tasks count as terminal too.  Notifications
        fire after the lock is released (the handler may call back into
        the engine)."""
        notify = self.on_result
        pending: list = []
        with self._cond:
            n = self._note_locked(name, ok, res, error,
                                  pending, notify is not None)
            self._inflight -= n
            if self._inflight <= 0:
                self._cond.notify_all()
        for note in pending:
            notify(*note)

    def _note_terminal_many(self, batch: list):
        """Batched `_note_terminal` + successor readying: ONE lock hold
        for a whole completion batch.  The dispatch loop calls this once
        per drained steal batch, so the lock ping-pong with a submitting
        client thread amortizes over `steal_n` tasks instead of hitting
        every task (measurably so: per-future client overhead)."""
        notify = self.on_result
        want = notify is not None
        pending: list = []
        with self._cond:
            n = 0
            for name, ok, res in batch:
                if ok:
                    self._on_terminal_unlocked(name)
                n += self._note_locked(name, ok, res, None, pending, want)
            self._inflight -= n
            if self._inflight <= 0:
                self._cond.notify_all()
        for note in pending:
            notify(*note)

    def _note_locked(self, name: str, ok: bool, res, error,
                     pending: list, want: bool) -> int:
        """Shared terminal-transition body (caller holds `_cond`): returns
        how many tasks reached terminal (1 + poisoned successors), and
        appends `on_result` notifications to `pending` when `want`.  A
        name absent from the task registry is a resurrected server stub
        (a pruned name re-declared as a dependency): it is remembered as
        terminal so it can't loop, but contributes no inflight count and
        no notification — it was never a submitted task."""
        if name in self._terminal:
            return 0
        self._terminal.add(name)
        self._attempts.pop(name, None)      # bounded retry state
        known = name in self.tasks
        if error is None and res is not None:
            error = res.error
        if want and known:
            pending.append((name, ok, res, error))
        j = self.journal
        if j is not None:
            if ok:
                j.append_terminal(name, True)
            elif error == "cancelled" and res is None:
                j.append_cancel(name)
            else:
                j.append_terminal(name, False, error)
        n = 1 if known else 0
        if not ok:
            self._failed.add(name)
            stack = [name]
            while stack:
                for succ in self._succs.pop(stack.pop(), []):
                    self._waiting.pop(succ, None)
                    if succ in self._terminal:
                        continue
                    self._terminal.add(succ)
                    self._failed.add(succ)
                    self._attempts.pop(succ, None)
                    why = f"poisoned by {name}"
                    self.tracer.emit(FAILED, task=succ, error=why)
                    if j is not None:
                        j.append_terminal(succ, False, why)
                    if want:
                        pending.append((succ, False, None, why))
                    n += 1
                    stack.append(succ)
        return n

    # ---------------------------------------------------- resident control
    def start(self, execute: Optional[Callable] = None, *,
              pass_worker: bool = False) -> "Engine":
        """Launch the dispatch loop in a background thread (resident mode
        only).  `execute(name, meta)` as in `run()`; with
        `pass_worker=True` the callback receives `(name, meta, worker)` so
        per-worker behavior (runtime.elastic) needs no engine surgery."""
        if not self.resident:
            raise RuntimeError("start() requires Engine(resident=True); "
                               "use run() for batch mode")
        if self._thread is not None:
            raise RuntimeError("engine already started")
        self._stop = self._abort = False
        self._report = None
        self._loop_error = None
        self._thread = threading.Thread(
            target=self._serve, args=(execute, pass_worker),
            name="engine-resident", daemon=True)
        self._thread.start()
        return self

    def _serve(self, execute, pass_worker):
        try:
            self._report = self.run(execute, pass_worker=pass_worker)
        except BaseException as e:  # noqa: BLE001 — surfaced by shutdown()
            self._loop_error = e
        finally:
            with self._cond:
                self._cond.notify_all()   # unblock drain() on a loop crash
            if self._loop_error is not None \
                    and self.on_loop_error is not None:
                try:
                    self.on_loop_error(self._loop_error)
                except Exception:    # noqa: BLE001 — the loop is already
                    pass             # dead; shutdown() reports the cause

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Block until every submitted task is terminal (True) or the
        timeout expires (False).  Does not stop the loop.  With a
        journal attached, a successful drain syncs it — "drained" then
        also means "durable"."""
        with self._cond:
            ok = self._cond.wait_for(
                lambda: (self._inflight <= 0 and not self._mailbox)
                or self._loop_error is not None,
                timeout)
        if ok and self.journal is not None:
            self.journal.sync()
        return ok

    def shutdown(self, *, drain: bool = True,
                 timeout: Optional[float] = None) -> Optional[EngineReport]:
        """Stop the resident loop and return its EngineReport.  With
        `drain=True` (default) outstanding work finishes first; with
        `drain=False` pending work is abandoned (the server keeps it).
        Idempotent: shutting down a resident engine that was never
        started is a no-op returning None, and a second shutdown() is a
        no-op returning the first call's report — `Client.__exit__` and
        finalizers can call it unconditionally."""
        if not self.resident:
            raise RuntimeError("shutdown() requires Engine(resident=True); "
                               "batch mode returns its report from run()")
        if self._thread is None:
            return self._report
        if drain:
            self.drain(timeout)
        else:
            self._abort = True
        self._stop = True
        self._thread.join(timeout)
        if self._thread.is_alive():      # wedged mid-drain: force exit
            self._abort = True
            self._thread.join(timeout)
            if self._thread.is_alive():
                # execute() is blocked and cannot observe the abort flag;
                # keep the handle so a later shutdown() can retry, and
                # report the bounded stop honestly instead of hanging
                raise RuntimeError(
                    "resident loop did not stop within timeout "
                    "(execute blocked?)")
        self._thread = None
        if self._loop_error is not None:
            raise self._loop_error
        return self._report

    @property
    def started(self) -> bool:
        """True while the resident dispatch loop is running."""
        return self._thread is not None

    def live_workers(self) -> int:
        """Workers currently alive (pool size minus deaths) — the P that
        METG-aware batching should adapt to."""
        return max(self._live, 0)

    def tasks_done_total(self) -> int:
        """Task executions that reached COMPLETED/FAILED on a worker.
        Requeued re-executions count each time: this is the throughput
        counter the windowed tasks/s rate diffs, not the terminal-name
        count (`OverheadReport.n_tasks`)."""
        return sum(st[0] for st in list(self._wstats.values()))

    def dep_table(self) -> dict:
        """Monitoring snapshot of the dependency graph: task name ->
        tuple of dependency names, for every registered task that has
        dependencies.  Read under the GIL (approximate while the loop
        runs, like `worker_stats`); the critical-path analyzer
        (`repro_torch.core.obs.critical_path`) joins it against the trace —
        exported traces carry the same edges on their CREATED events."""
        return {n: t.deps for n, t in list(self.tasks.items()) if t.deps}

    def worker_stats(self) -> dict:
        """Monitoring snapshot: worker -> {done, busy_s, alive}.  Read
        under the GIL from the loop's own tables — approximate while the
        loop runs, never blocking it.  `busy_s` sums real execution time
        (TaskResult t_start..t_end), so diffing two snapshots gives a
        per-worker busy fraction over the window."""
        dead = self._dead_workers
        return {w: {"done": st[0], "busy_s": st[1], "alive": w not in dead}
                for w, st in list(self._wstats.items())}

    def add_worker(self, name: Optional[str] = None) -> str:
        """Grow the live pool (resident mode): the worker joins the steal
        rotation at the top of the next dispatch round."""
        if not self.resident:
            raise RuntimeError("membership changes require "
                               "Engine(resident=True)")
        if name is None:
            name = f"w{self._next_wid}"
        self._next_wid += 1
        with self._cond:
            self._commands.append(("add", name))
            self._epoch += 1
        return name

    def lose_worker(self, name: str):
        """Driver-side failure detection (paper: Exit may be called by the
        user to recover from a node failure): mark the worker dead and
        recycle everything it still holds."""
        if not self.resident:
            raise RuntimeError("membership changes require "
                               "Engine(resident=True)")
        with self._cond:
            self._commands.append(("lose", name))
            self._epoch += 1

    def cancel(self, name: str) -> bool:
        """Withdraw a submitted task that no worker has stolen yet.  True
        means the task will never run: the server poisons it (and its
        transitive successors) under its own lock, so a concurrent Steal
        can never hand it out afterwards.  False means the cancel lost
        the race — the task is already stolen, terminal, or unknown.
        Cancellation counts as a failure terminal state: dependents are
        poisoned, drain() unblocks, and on_result fires with
        error=\"cancelled\"."""
        notify = self.on_result
        pending: list = []
        withdrawn = False
        with self._cond:
            if name not in self.tasks or name in self._terminal:
                return False
            if name in self._unsent:
                # still in the mailbox: withdraw it engine-side before the
                # loop ever ingests it (ingest skips terminal names).  The
                # withdrawn task itself was never counted in _inflight
                # (counting happens at ingest), but poisoned successors in
                # the walk WERE ingested — a dependent that forward-
                # declared this name as a string dep — so n-1 of the walk
                # must be decremented.  Unsent successors are not in
                # _succs and fail fast at their own ingest via _failed.
                self._unsent.discard(name)
                self.tracer.emit(CANCELLED, task=name)
                n = self._note_locked(name, False, None, "cancelled",
                                      pending, notify is not None)
                self._inflight -= (n - 1)
                if self._inflight <= 0:
                    self._cond.notify_all()
                withdrawn = True
        if withdrawn:
            for note in pending:
                notify(*note)
            return True
        if not self.backend.cancel(name):
            return False
        self.tracer.emit(CANCELLED, task=name)
        self._note_terminal(name, False, error="cancelled")
        return True

    def prune_terminal(self, *, backend: bool = True) -> int:
        """Bounded-state hook: drop terminal tasks from the engine-side
        history tables (tasks/_terminal/_failed) and, with `backend=True`,
        from the server's tables too.  Names still referenced as
        dependencies by a not-yet-ingested (mailboxed) submission are
        kept, so auto-pruning (`Client(prune_every=)`) cannot race a
        concurrent submit into resurrecting a pruned dep as a READY
        stub.  Beyond that, the contract matches
        `TaskServer.prune_terminal`: only prune names that no FUTURE
        submit will reference as a dependency (single-use names — the
        futures client and serving frontend satisfy this).  Returns the
        number of entries dropped across both layers."""
        with self._cond:
            keep: set = set(self._pinned)
            for task in self._mailbox:
                keep.update(task.deps)
            if self.transport == "proc":
                # a worker may still Fetch a dependency VALUE for any
                # in-flight dependent — keep those payloads fetchable
                for n, t in self.tasks.items():
                    if t.deps and n not in self._terminal:
                        keep.update(t.deps)
            prunable = [n for n in self._terminal
                        if n not in self._succs and n not in keep]
            for n in prunable:
                self._terminal.discard(n)
                self._failed.discard(n)
                self.tasks.pop(n, None)
            # the backend half runs under the same hold: submit() also
            # takes _cond, so no submission can slip a new dep reference
            # in while the server tables are being scanned with this
            # keep-set (lock order engine._cond -> server.lock is used
            # nowhere in reverse)
            n_backend = (self.backend.prune_terminal(keep=keep)
                         if backend else 0)
        return len(prunable) + n_backend

    def pin(self, name: str):
        """Exempt `name`'s payload from prune_terminal: a terminal task
        whose (remote) value is lifted into a later submission's
        arguments has no dependency edge the prune keep-set would see —
        the worker resolving the new task must still be able to Fetch
        it (the futures client pins lifted RemoteValue results)."""
        with self._cond:
            self._pinned.add(name)

    # ----------------------------------------------------------- recovery
    @classmethod
    def recover(cls, journal_dir, **engine_kw) -> "Engine":
        """Rebuild an engine from a journal directory after a crash.

        Replays checkpoint + WAL into the control-plane state, then:

          * terminal names (completed / failed / cancelled) seed the
            exactly-once accounting — they never re-run, never re-fire
            `on_result`, and dependents treat completed producers as
            satisfied;
          * every created-but-not-terminal task is re-submitted with its
            surviving dependencies, which re-marks leased-but-unfinished
            work from the crashed run as ready (the journal records no
            leases: an assignment that never completed is work to redo);
          * a pending task whose producer failed before the crash is
            poisoned immediately, exactly as the live engine would have.

        The returned engine journals into the SAME directory (appends
        continue where the crashed run stopped), so a recovered session
        is itself recoverable.  Task `fn` closures are not journaled —
        run the recovered engine with an `execute(name, meta)` callback
        (the by-name style of the dwork/pmake adapters), carrying
        whatever the callback needs in each task's `meta`.

        `engine_kw` is forwarded to the constructor (workers, transport,
        shards, resident=..., retry=..., ...).  Works with all three
        backends: recovery happens above the backend, which starts
        empty and receives the re-created universe."""
        state = Journal.replay(journal_dir)
        eng = cls(journal=str(journal_dir), **engine_kw)
        eng._recovered = state
        terminal = state.terminal()
        eng._terminal |= terminal
        eng._failed.update(state.failed)
        eng._failed.update(state.cancelled)
        completed = state.completed
        journal = eng.journal
        for name, deps, meta in state.pending():
            live = tuple(d for d in deps if d not in completed)
            bad = next((d for d in live if d in eng._failed), None)
            if bad is not None:
                eng._terminal.add(name)
                eng._failed.add(name)
                why = f"dependency {bad} failed"
                eng.tracer.emit(FAILED, task=name, error=why)
                journal.append_terminal(name, False, why)
                continue
            eng.submit(name, deps=live, meta=meta)
        return eng

    # -------------------------------------------------------------- exec
    def _execute_registered(self, name: str, meta: dict):
        task = self.tasks.get(name)
        if task is None or task.fn is None:
            return (True, None)
        return (True, task.fn())

    def _run_one(self, exec_fn, name: str, meta: dict,
                 worker: str) -> TaskResult:
        tracer = self.tracer
        tracer.emit4(RUN_START, name, worker)
        t0 = time.perf_counter()
        ok, value, err, crashed = True, None, None, False
        try:
            if self._pass_worker:
                out = exec_fn(name, meta, worker)
            else:
                out = exec_fn(name, meta)
            if isinstance(out, tuple):
                ok, value = bool(out[0]), out[1]
            elif out is None:
                ok = True
            elif isinstance(out, bool):
                ok = out
            else:
                ok, value = True, out
        except WorkerCrash as e:
            ok, err, crashed = False, repr(e), True
        except Exception as e:                        # noqa: BLE001
            ok, err = False, repr(e)
        t1 = time.perf_counter()
        virtual = 0.0
        if self.faults is not None:
            virtual = self.faults.delay_s(name, worker)
            if self.faults.force_fail(name, worker,
                                      self._attempts.get(name, 0)):
                ok, err = False, err or "injected fault"
            tracer.emit(RUN_END, task=name, worker=worker, virtual_s=virtual)
        else:
            tracer.emit4(RUN_END, name, worker)
        return TaskResult(task=name, ok=ok, worker=worker, t_start=t0,
                          t_end=t1, value=value, error=err,
                          virtual_s=virtual, crashed=crashed)

    # --------------------------------------------------------------- run
    def run(self, execute: Optional[Callable] = None, *,
            pass_worker: bool = False) -> EngineReport:
        """Run until every task reaches a terminal state (or all workers
        die / the pool stalls).  `execute(name, meta)` may return bool,
        (ok, value), or None (success); default runs the submitted `fn`.
        In resident mode the loop instead runs until `shutdown()`."""
        if self.transport == "proc":
            return self._run_proc(execute, pass_worker)
        exec_fn = execute or self._execute_registered
        self._pass_worker = pass_worker and execute is not None
        resident = self.resident
        t_wall0 = time.perf_counter()
        alive = [f"w{i}" for i in range(self.workers)]
        n_alive = max(len(alive), 1)
        peak_workers = len(alive)
        dead: set[str] = set()
        self._dead_workers = dead            # monitoring view (GIL reads)
        wstats = self._wstats
        for w in alive:
            wstats.setdefault(w, [0, 0.0])
        steals = {w: 0 for w in alive}
        done_flag = {w: False for w in alive}
        # hot-path state, all maintained incrementally (no per-round scans):
        heap: list = []                # (-priority, seq, item) pending launch
        n_pending = 0
        pending_names: set[str] = set()
        outstanding = {w: 0 for w in alive}   # stolen, not yet finished
        finished = {w: [] for w in alive}     # (name, ok) awaiting piggyback
        running: dict[str, dict] = {}         # thread transport in-flight
        results: dict[str, TaskResult] = {}
        free = self.capacity
        idle_rounds = 0
        stalled = False
        steal_n = self.steal_n
        pending_limit = max(self.workers, 1) * steal_n + self.capacity
        inline = self.transport != "thread"
        pool = (None if inline
                else ThreadPoolExecutor(max_workers=self.capacity))
        # local bindings keep the per-round constant cost down
        emit = self.tracer.emit
        emit4 = self.tracer.emit4
        complete_steal = self.backend.complete_steal
        run_one = self._run_one
        on_terminal = self._on_terminal
        # terminal accounting runs in resident mode (drain bookkeeping)
        # and whenever a result listener OR a journal is attached (the
        # journal records terminal transitions at the same chokepoint);
        # `_terminal` then doubles as the duplicate-steal guard so
        # `keep_results=False` sessions stay exactly-once too
        note_terminal = (self._note_terminal
                         if resident or self.on_result is not None
                         or self.journal is not None else None)
        note_many = self._note_terminal_many
        terminal_seen = self._terminal if note_terminal else ()
        record_results = self.keep_results or not resident
        priority_of = self._priority_of
        capacity = self.capacity
        faults = self.faults
        # fault-free inline runs drain a priority-0 batch straight from
        # the steal response — no heap round-trip, no pending bookkeeping.
        # (With faults the slow path keeps the steal->death->launch window
        # so a dying worker observably holds stolen-but-unstarted tasks.)
        fast_drain = inline and faults is None
        seq = 0
        rounds = 0
        quiet_epoch = -1            # resident idle gate (see IDLE_PROBE_...)
        # launch gate: popping the heap is pointless until something can
        # change the outcome (a slot freed, new steals, a death scrub) —
        # without it a full backlog gets drained/re-pushed every poll
        try_launch = True
        progress = False
        # retry plumbing: a transiently-failed execution is re-enqueued
        # onto the launch heap with a not-before stamp (seeded-jitter
        # backoff) instead of reporting Complete(ok=False) — the worker
        # keeps its scheduler-side assignment, so a retry costs zero
        # protocol round-trips.  backoff_wait marks a round where heap
        # entries were held for their backoff deadline only.
        retry_default = self.retry
        attempts = self._attempts
        backoff_wait = False

        def retry_delay(name: str, res: TaskResult):
            """None = fail for real; else the backoff before re-run."""
            task = self.tasks.get(name)
            pol = (task.retry if task is not None
                   and task.retry is not None else retry_default)
            if pol is None:
                return None
            attempt = attempts.get(name, 0) + 1
            attempts[name] = attempt
            if not pol.should_retry(attempt, res.error):
                return None
            return pol.delay_s(name, attempt)

        def schedule_retry(name: str, meta, w: str, delay: float):
            nonlocal seq, n_pending, try_launch
            self.retries_total += 1
            emit(RETRIED, task=name, worker=w, attempt=attempts[name],
                 delay_s=delay)
            pending_names.add(name)
            seq += 1
            heappush(heap, (
                -priority_of(name, meta), seq,
                {"name": name, "meta": meta, "worker": w,
                 "slots": self._slots_of(name, meta),
                 "t_ready": time.perf_counter() + delay}))
            n_pending += 1
            try_launch = True

        def bury(w: str, *, announce: bool, **extra):
            """Retire a dead worker mid-stream: flush the completions it
            already reported (a result the engine recorded is never lost),
            recycle its assignment (announced Exit; silent deaths rely on
            heartbeat-lease expiry), and scrub its pending launches."""
            nonlocal heap, n_pending, try_launch, progress
            dead.add(w)
            self.worker_deaths += 1
            emit(WORKER_DEAD, worker=w, **extra)
            if finished[w]:
                complete_steal(w, finished[w], 0)
                finished[w] = []
            if announce:
                self.backend.exit_worker(w)
            if heap:
                kept = [e for e in heap if e[2]["worker"] not in dead]
                if len(kept) != len(heap):
                    for e in heap:
                        if e[2]["worker"] in dead:
                            pending_names.discard(e[2]["name"])
                    heap = kept
                    heapify(heap)
                    n_pending = len(heap)
            try_launch = True
            progress = True
            self._live = len(alive) - len(dead)
            if resident:
                self._epoch += 1     # its requeued work is stealable again

        try:
            while True:
                rounds += 1
                progress = False
                backoff_wait = False
                stopping = not resident or self._stop
                # 0) resident: abort / membership commands / live retuning
                if resident:
                    if self._abort:
                        break
                    if self._mailbox:
                        self._ingest_mailbox()
                    if self._commands:
                        with self._cond:
                            cmds = list(self._commands)
                            self._commands.clear()
                        for cmd, w in cmds:
                            if cmd == "add":
                                if w in steals and w not in dead:
                                    continue            # already live
                                if w in dead:
                                    # a recovered node rejoining under its
                                    # old id: revive with a clean slate —
                                    # only copies still in flight from the
                                    # old incarnation stay attributed
                                    dead.discard(w)
                                    done_flag[w] = False
                                    finished[w] = []
                                    outstanding[w] = sum(
                                        1 for r in running.values()
                                        if r["worker"] == w)
                                else:
                                    alive.append(w)
                                    steals[w] = 0
                                    done_flag[w] = False
                                    outstanding[w] = 0
                                    finished[w] = []
                                wstats.setdefault(w, [0, 0.0])
                                self._live = len(alive) - len(dead)
                                peak_workers = max(peak_workers, len(alive))
                            elif cmd == "lose" and w in steals \
                                    and w not in dead:
                                bury(w, announce=True, reason="lose")
                        n_alive = max(len(alive), 1)
                    # steal_n is re-read every round so membership-aware
                    # batching (elastic: pick_batch_size on remesh) applies
                    # without restarting the loop
                    steal_n = max(int(self.steal_n), 1)
                    pending_limit = n_alive * steal_n + capacity
                    epoch0 = self._epoch
                    steal_ok = (stopping or epoch0 != quiet_epoch
                                or rounds % IDLE_PROBE_ROUNDS == 0)
                else:
                    steal_ok = True
                # 1) reap finished thread-pool tasks into per-worker batches
                if running:
                    for name in [n for n, r in running.items()
                                 if r["fut"].done()]:
                        rec = running.pop(name)
                        free += rec["slots"]
                        progress = True
                        try_launch = True
                        w = rec["worker"]
                        if w in dead:
                            continue  # lost completion: requeued via Exit
                        res: TaskResult = rec["fut"].result()
                        if res.crashed:
                            bury(w, announce=True, crash=True)
                            continue
                        outstanding[w] -= 1
                        st = wstats[w]
                        if not res.ok:
                            delay = retry_delay(name, res)
                            if delay is not None:
                                # transient: the worker keeps its
                                # assignment; re-enqueue after backoff
                                st[1] += res.t_end - res.t_start
                                outstanding[w] += 1
                                schedule_retry(name, rec["meta"], w, delay)
                                continue
                        st[0] += 1
                        st[1] += res.t_end - res.t_start
                        if not res.ok:
                            self.exec_failed += 1
                        if record_results:
                            results[name] = res
                        if note_terminal:
                            note_terminal(name, res.ok, res)
                        finished[w].append((name, res.ok))
                        emit(COMPLETED if res.ok else FAILED, task=name,
                             worker=w, error=res.error)
                        if res.ok:  # failed tasks never ready their succs
                            on_terminal(name)
                # 2) complete+steal — one RPC flushes a worker's finished
                # batch AND steals its next one (Fig. 2 batch-then-drain);
                # a worker steals only while it holds fewer than steal_n
                # outstanding tasks; rotation keeps the order fair
                if n_alive == 1:
                    rotation = alive
                else:
                    start = rounds % n_alive
                    rotation = alive[start:] + alive[:start]
                for w in rotation:
                    if w in dead:
                        continue
                    batch = finished[w]
                    want_steal = (steal_ok
                                  and not done_flag[w]
                                  and outstanding[w] < steal_n
                                  and n_pending < pending_limit)
                    if not batch and not want_steal:
                        continue
                    got = complete_steal(w, batch,
                                         steal_n if want_steal else 0)
                    if batch:
                        finished[w] = []
                        progress = True
                    if not want_steal:
                        continue
                    if got == DONE:
                        # resident pre-stop: the server saying "all done"
                        # just means "idle right now" — more work may be
                        # submitted, so keep the worker in the rotation
                        if stopping:
                            done_flag[w] = True
                    elif got != EMPTY:
                        steals[w] += len(got)
                        accepted = []
                        for name, meta in got:
                            rec = running.get(name)
                            if (name in pending_names
                                    or (rec is not None
                                        and rec["worker"] not in dead)):
                                # duplicate steal after a lease-expiry
                                # requeue while a LIVE copy is still held
                                # (pending or in flight): the copy's
                                # Complete clears every stale assignment
                                # server-side, so just drop it.  A copy
                                # held only by a DEAD worker is accepted —
                                # its completion was discarded, so this
                                # re-steal is the only way forward.
                                continue
                            prior = results.get(name)
                            if prior is not None or name in terminal_seen:
                                # already terminal engine-side: a stale
                                # requeue duplicate with no live copy, or
                                # a pruned name a later dep re-declared as
                                # a server stub — report its terminal
                                # state instead of dropping it, so the
                                # server's join accounting (and any
                                # dependents) can move.  Never re-execute.
                                ok_prior = (prior.ok if prior is not None
                                            else name not in self._failed)
                                finished[w].append((name, ok_prior))
                                progress = True
                                continue
                            accepted.append((name, meta))
                        if not accepted:
                            continue
                        progress = True
                        # drain a batch inline ONLY when nothing in it (or
                        # already pending) carries a priority — otherwise a
                        # prio-0 item would run before a higher-priority
                        # one later in the same batch/heap
                        drain = fast_drain and not heap and all(
                            priority_of(name, meta) == 0.0
                            for name, meta in accepted)
                        if drain:
                            # with terminal accounting on, bookkeeping is
                            # batched: ONE lock hold (note_many) for the
                            # whole drained batch, amortizing the
                            # client-thread lock ping-pong over steal_n
                            notes = [] if note_terminal is not None \
                                else None
                            st = wstats[w]
                            for name, meta in accepted:
                                # steal order == seq order: complete rides
                                # on this worker's next CompleteSteal
                                emit4(STOLEN, name, w)
                                res = run_one(exec_fn, name, meta, w)
                                if res.crashed:
                                    # the rest of the batch is still
                                    # assigned server-side: Exit recycles
                                    # it with the in-flight task
                                    bury(w, announce=True, crash=True)
                                    break
                                if not res.ok:
                                    delay = retry_delay(name, res)
                                    if delay is not None:
                                        # the fast path never counted
                                        # this steal in outstanding: the
                                        # heap re-enqueue must
                                        st[1] += res.t_end - res.t_start
                                        outstanding[w] += 1
                                        schedule_retry(name, meta, w,
                                                       delay)
                                        continue
                                st[0] += 1
                                st[1] += res.t_end - res.t_start
                                if record_results:
                                    results[name] = res
                                finished[w].append((name, res.ok))
                                if notes is not None:
                                    notes.append((name, res.ok, res))
                                if res.ok:
                                    emit4(COMPLETED, name, w)
                                    if notes is None:
                                        on_terminal(name)
                                else:
                                    self.exec_failed += 1
                                    emit(FAILED, task=name, worker=w,
                                         error=res.error)
                            if notes:
                                note_many(notes)
                            continue
                        for name, meta in accepted:
                            emit4(STOLEN, name, w)
                            pending_names.add(name)
                            outstanding[w] += 1
                            seq += 1
                            heappush(heap, (
                                -priority_of(name, meta), seq,
                                {"name": name, "meta": meta, "worker": w,
                                 "slots": self._slots_of(name, meta)}))
                            n_pending += 1
                        try_launch = True
                # resident idle gate: a fully quiet round (no completions,
                # no steals served) arms the backoff until the epoch moves
                if resident and not stopping and not progress and steal_ok:
                    quiet_epoch = epoch0
                # 3) fault injection: worker deaths (between steal & launch,
                #    so a dying worker holds stolen-but-unstarted tasks)
                if faults is not None:
                    for w in alive:
                        if w in dead:
                            continue
                        if faults.should_die(w, steals[w]):
                            silent = faults.dies_silently(w)
                            # announced death: Exit recycles assignment;
                            # silent death: heartbeat-lease expiry recycles
                            bury(w, announce=not silent, silent=silent)
                # 4) launch: greedy highest-priority-first into free slots
                if heap and try_launch:
                    try_launch = False
                    held = []
                    while heap:
                        entry = heappop(heap)
                        it = entry[2]
                        name = it["name"]
                        if it["worker"] in dead:      # late scrub
                            pending_names.discard(name)
                            n_pending -= 1
                            continue
                        t_ready = it.get("t_ready")
                        if t_ready is not None \
                                and t_ready > time.perf_counter():
                            held.append(entry)    # retry backoff pending
                            backoff_wait = True
                            continue
                        if name in running:
                            # a dead worker's copy is still in flight;
                            # wait for it to drain before re-launching
                            held.append(entry)
                            continue
                        slots = min(it["slots"], capacity)
                        if slots > free:
                            held.append(entry)
                            continue
                        pending_names.discard(name)
                        n_pending -= 1
                        w = it["worker"]
                        if inline:
                            res = self._run_one(exec_fn, name, it["meta"], w)
                            if res.crashed:
                                # bury scrubs this worker's remaining heap
                                # entries; `held` is re-checked next pass
                                bury(w, announce=True, crash=True)
                                progress = True
                                continue
                            if not res.ok:
                                delay = retry_delay(name, res)
                                if delay is not None:
                                    # still held by w (outstanding not
                                    # yet decremented): re-enqueue only
                                    wstats[w][1] += res.t_end - res.t_start
                                    schedule_retry(name, it["meta"], w,
                                                   delay)
                                    progress = True
                                    continue
                            outstanding[w] -= 1
                            st = wstats[w]
                            st[0] += 1
                            st[1] += res.t_end - res.t_start
                            if not res.ok:
                                self.exec_failed += 1
                            if record_results:
                                results[name] = res
                            if note_terminal:
                                note_terminal(name, res.ok, res)
                            finished[w].append((name, res.ok))
                            emit(COMPLETED if res.ok else FAILED, task=name,
                                 worker=w, error=res.error)
                            if res.ok:
                                self._on_terminal(name)
                        else:
                            free -= slots
                            fut = pool.submit(self._run_one, exec_fn, name,
                                              it["meta"], w)
                            running[name] = {"worker": w, "fut": fut,
                                             "slots": slots,
                                             "meta": it["meta"]}
                        progress = True
                    for entry in held:
                        heappush(heap, entry)
                    if backoff_wait:
                        # a held backoff entry needs another launch pass
                        # once its deadline arrives, whatever else the
                        # round did
                        try_launch = True
                # 5) termination (batch mode, or resident after shutdown())
                if stopping and not running and not n_pending:
                    live = [w for w in alive if w not in dead]
                    if not live:
                        # every worker died: unless one of them saw the
                        # server's DONE first, work remains unserved —
                        # that is a stall, not a clean finish.  A resident
                        # pool counts its submitted universe instead (it
                        # may legitimately stop with zero workers).
                        if resident:
                            stalled = (self._inflight > 0
                                       or bool(self._mailbox))
                        else:
                            stalled = not any(done_flag.values())
                        break
                    if all(done_flag[w] for w in live) \
                            and not any(finished[w] for w in live):
                        break
                if progress:
                    idle_rounds = 0
                elif backoff_wait:
                    # retries waiting out their backoff are forward
                    # progress in waiting, not a stall
                    idle_rounds = 0
                    try_launch = True
                    time.sleep(self.poll)
                elif not running:
                    idle_rounds += 1
                    if idle_rounds >= self.max_idle_rounds and stopping:
                        stalled = True   # unresolvable (cycle / all leased)
                        break
                    time.sleep(self.poll)
                else:
                    time.sleep(self.poll)
        finally:
            if pool is not None:
                pool.shutdown(wait=True)
            journal = self.journal
            if journal is not None:
                # a clean exit is fully durable; an owned journal (built
                # from a path) is closed with the loop
                journal.sync()
                if self._owns_journal:
                    journal.close()
            if self._owns_backend:
                # in the finally so a mid-run RPC failure can't leak the
                # tree's sockets/threads; stats()/errors() below only
                # read in-process state and stay valid after close
                self.backend.close()
        # effective parallelism: the inline transports run tasks serially,
        # and the thread pool is sized by `capacity`, so overhead
        # accounting must not multiply wall time by phantom workers
        eff_workers = 1 if inline else min(peak_workers, self.capacity)
        return EngineReport(
            results=results, trace=self.tracer, workers=max(eff_workers, 1),
            pool_workers=max(peak_workers, 1),
            wall_s=time.perf_counter() - t_wall0,
            errors=self.backend.errors(), stalled=stalled,
            backend_stats=self.backend.stats())

    # ------------------------------------------------------- proc transport
    @property
    def comm_address(self) -> Optional[str]:
        """Where `python -m repro_torch.core.engine.comm.worker --connect`
        dials (`tcp://host:port`) — None for in-process transports."""
        return getattr(self.backend, "address", None)

    def worker_pids(self) -> dict:
        """worker -> OS pid for every handshaken worker process
        (transport="proc"; empty for in-process transports)."""
        fn = getattr(self.backend, "worker_pids", None)
        return fn() if fn is not None else {}

    def wait_workers(self, n: Optional[int] = None,
                     timeout: float = 30.0) -> bool:
        """Block until `n` workers (default: the configured pool size)
        have completed their Hello handshake.  True once reached; in-
        process transports return True immediately (workers are the
        dispatch loop itself)."""
        fn = getattr(self.backend, "connected", None)
        if fn is None:
            return True
        want = self.workers if n is None else int(n)
        deadline = time.monotonic() + timeout
        while len(fn()) < want:
            if time.monotonic() >= deadline:
                return False
            time.sleep(0.01)
        return True

    def _run_proc(self, execute, pass_worker: bool) -> EngineReport:
        """Dispatch loop for `transport="proc"` — supervision, not
        execution.  Tasks run inside worker processes that speak the
        frame protocol straight to the backend's front door on its
        handler threads; this loop ingests submissions, drains the
        completion records the door queued, reconstructs their trace
        spans, and supervises liveness (membership commands, remote
        joins, crash/stale detection with zero-loss requeue)."""
        backend = self.backend
        resident = self.resident
        tracer = self.tracer
        emit = tracer.emit
        t_wall0 = time.perf_counter()
        # serialize the execute callback BEFORE spawning anything: an
        # unpicklable callback must fail fast, not hang a handshake
        backend.prepare(execute=execute, pass_worker=pass_worker,
                        steal_n=self.steal_n, resident=resident)
        alive = [f"w{i}" for i in range(self.workers)]
        dead: set[str] = set()
        self._dead_workers = dead
        wstats = self._wstats
        for w in alive:
            wstats.setdefault(w, [0, 0.0])
        self._live = len(alive)
        peak_workers = max(len(alive), 1)
        backend.start_pool(alive)
        results: dict[str, TaskResult] = {}
        record_results = self.keep_results or not resident
        note_terminal = (self._note_terminal
                         if resident or self.on_result is not None
                         or self.journal is not None else None)
        note_many = self._note_terminal_many
        terminal_seen = self._terminal if note_terminal else ()
        # liveness grace: a worker busy on a long task still heartbeats
        # (daemon thread), so staleness only means the PROCESS is gone or
        # wedged; locally-spawned processes are additionally poll()ed
        # and surface within one round of dying
        grace = max(3.0 * self.heartbeat_s, 1.0)
        stolen_at = backend.door.stolen_at
        stalled = False
        idle_rounds = 0
        # retry plumbing, proc flavor: the front door WITHHOLDS failures
        # this predicate approves (the task stays leased), queueing them
        # for drain_failed below — the policy decision runs here but the
        # completion-suppression must happen at the wire, before the
        # scheduler learns of the failure and poisons dependents
        retry_default = self.retry
        attempts = self._attempts
        retry_pending: list = []        # (t_ready, worker, task)

        def retry_policy_of(name: str):
            task = self.tasks.get(name)
            return (task.retry if task is not None
                    and task.retry is not None else retry_default)

        def retry_check(name: str, err) -> bool:
            # runs on door handler threads: GIL-grade dict reads only
            pol = retry_policy_of(name)
            return (pol is not None
                    and pol.should_retry(attempts.get(name, 0) + 1, err))

        backend.retry_check = retry_check

        def spawn_recompute(missing: str):
            """Ensure a recompute of a lost value is in flight: reuse the
            pending store-as alias when it has not itself terminated, else
            create a fresh one from the task's packed call.  -> the alias
            name, or None when recompute is impossible (no packed call) or
            the attempt budget is spent — callers fail/raise then."""
            with self._xfer_lock:
                alias = self._xfer_pending.get(missing)
                if alias is not None and alias not in terminal_seen \
                        and alias not in results:
                    return alias
                k = self._xfer_attempts.get(missing, 0) + 1
                task_m = self.tasks.get(missing)
                call = (task_m.meta.get("__call__")
                        if task_m is not None else None)
                if call is None or k > 3:
                    self._xfer_attempts[missing] = k   # mark exhausted:
                    return None                        # waiters stop too
                self._xfer_attempts[missing] = k
                alias = f"{missing}~r{k}"
                self._xfer_pending[missing] = alias
            backend.create(alias, deps=(), meta={
                "__call__": call, "__store_as__": missing})
            self.xfer_lost_total += 1
            return alias

        self._loop_live = True
        try:
            while True:
                progress = False
                stopping = not resident or self._stop
                if resident:
                    if self._abort:
                        break
                    if self._mailbox:
                        self._ingest_mailbox()
                        progress = True
                    if self._commands:
                        with self._cond:
                            cmds = list(self._commands)
                            self._commands.clear()
                        for cmd, w in cmds:
                            if cmd == "add":
                                if w in wstats and w not in dead:
                                    continue          # already live
                                dead.discard(w)
                                backend.door.exited.discard(w)
                                if w not in alive:
                                    alive.append(w)
                                wstats.setdefault(w, [0, 0.0])
                                backend.spawn(w)
                                self._live = len(alive) - len(dead)
                                peak_workers = max(peak_workers,
                                                   self._live)
                            elif cmd == "lose" and w in wstats \
                                    and w not in dead:
                                dead.add(w)
                                self.worker_deaths += 1
                                emit(WORKER_DEAD, worker=w, reason="lose")
                                backend.kill_worker(w)
                                backend.exit_worker(w)
                                self._live = len(alive) - len(dead)
                                progress = True
                                door = backend.door
                                for missing, loc in \
                                        list(door.locations.items()):
                                    if loc[0] != w \
                                            or missing in door.values:
                                        continue
                                    door.locations.pop(missing, None)
                                    if missing not in self.tasks:
                                        continue
                                    if spawn_recompute(missing) is not None:
                                        emit(REQUEUED, task=missing, n=1,
                                             via="xfer_lost")
                # remote joins: a CLI worker's Hello is add_worker-on-
                # connect (multi-host launch), and locally-spawned
                # workers land here too (their handshake confirms them)
                for w in backend.drain_joined():
                    if w in wstats and w not in dead:
                        continue
                    if w in dead:
                        dead.discard(w)
                    if w not in alive:
                        alive.append(w)
                    wstats.setdefault(w, [0, 0.0])
                    self._live = len(alive) - len(dead)
                    peak_workers = max(peak_workers, self._live)
                    progress = True
                # completion records queued by the front door
                recs = backend.drain_records()
                if recs:
                    progress = True
                    notes = [] if note_terminal is not None else None
                    for w, name, ok, err, dur, payload, nbytes, xfers \
                            in recs:
                        if xfers:
                            # dependency-value transfers this execution
                            # performed (peer fetches and hub fallbacks):
                            # every one is attributed, no sampling
                            for path, n, dt in xfers:
                                self._record_xfer(name, w, path, n, dt)
                        if name in terminal_seen or name in results:
                            # duplicate after a requeue: first one won
                            stolen_at.pop(name, None)
                            continue
                        value = None
                        if ok and payload is not None:
                            try:
                                value = loads(payload)
                            except Exception as e:  # noqa: BLE001
                                ok = False
                                err = ("result deserialization failed: "
                                       f"{e!r}")
                        elif ok and nbytes:
                            # the payload stayed in the producing worker's
                            # store: hand out a lazy handle — materialized
                            # hub-first/peer-second only when read
                            value = RemoteValue(name, nbytes,
                                                self._proc_fetch_value)
                        # reconstruct the run span from the worker's
                        # reported duration, clamped to the STOLEN stamp
                        # so report pairing never sees negative dispatch
                        t1 = tracer.clock()
                        t0 = t1 - dur
                        t_stolen = stolen_at.pop(name, None)
                        if t_stolen is not None and t0 < t_stolen:
                            t0 = t_stolen
                        tracer.emit_at(t0, RUN_START, task=name, worker=w)
                        tracer.emit_at(t1, RUN_END, task=name, worker=w)
                        st = wstats.setdefault(w, [0, 0.0])
                        st[0] += 1
                        st[1] += dur
                        if not ok:
                            self.exec_failed += 1
                        res = TaskResult(task=name, ok=ok, worker=w,
                                         t_start=t0, t_end=t1, value=value,
                                         error=err)
                        if record_results:
                            results[name] = res
                        emit(COMPLETED if ok else FAILED, task=name,
                             worker=w, error=err)
                        if notes is not None:
                            notes.append((name, ok, res))
                        elif ok:
                            self._on_terminal(name)
                    if notes:
                        note_many(notes)
                # lease requeues observed at the wire (an expired lease
                # reaped by another worker's steal)
                n_rq = backend.drain_requeued()
                if n_rq:
                    emit(REQUEUED, n=n_rq, via="lease")
                    if self.journal is not None:
                        self.journal.append_requeue(n_rq, "lease")
                    progress = True
                # completions the door WITHHELD because a dependency value
                # is unrecoverable (its producer was killed before the
                # value replicated): recompute the missing value under a
                # store-as alias, then Transfer-requeue the dependent —
                # the zero-loss contract for the peer-to-peer data plane
                for w, name, missing in backend.drain_lost():
                    progress = True
                    if name in terminal_seen or name in results:
                        # the dependent already completed elsewhere (a
                        # requeue duplicate): just clear the stale lease
                        backend.complete(w, name,
                                         ok=name not in self._failed)
                        continue
                    if missing in backend.door.values:
                        # the value resurfaced (a spill/exit-flush landed
                        # after the worker's fetch failed): plain requeue
                        backend.transfer(w, name, [])
                        continue
                    alias = spawn_recompute(missing)
                    if alias is None:
                        why = (f"dependency value {missing!r} lost "
                               "(producer died before replication); "
                               "recompute exhausted or no packed call")
                        backend.complete(w, name, ok=False)
                        self.exec_failed += 1
                        stolen_at.pop(name, None)
                        emit(FAILED, task=name, worker=w, error=why)
                        res = TaskResult(task=name, ok=False, worker=w,
                                         error=why)
                        if record_results:
                            results[name] = res
                        if note_terminal is not None:
                            note_terminal(name, False, res, why)
                        continue
                    emit(REQUEUED, task=name, n=1, via="xfer_lost")
                    backend.transfer(w, name, [alias])
                # transiently-failed completions the door withheld on
                # retry_check's word: charge the attempt and queue the
                # Transfer-requeue behind the policy's backoff
                for w, name, err in backend.drain_failed():
                    progress = True
                    if name in terminal_seen or name in results:
                        backend.complete(w, name,
                                         ok=name not in self._failed)
                        continue
                    pol = retry_policy_of(name)
                    attempt = attempts.get(name, 0) + 1
                    if pol is None or not pol.should_retry(attempt, err):
                        # the budget ran out between the wire check and
                        # this drain: fail for real
                        backend.complete(w, name, ok=False)
                        self.exec_failed += 1
                        stolen_at.pop(name, None)
                        emit(FAILED, task=name, worker=w, error=err)
                        res = TaskResult(task=name, ok=False, worker=w,
                                         error=err)
                        if record_results:
                            results[name] = res
                        if note_terminal is not None:
                            note_terminal(name, False, res, err)
                        continue
                    attempts[name] = attempt
                    delay = pol.delay_s(name, attempt)
                    self.retries_total += 1
                    emit(RETRIED, task=name, worker=w, attempt=attempt,
                         delay_s=delay)
                    retry_pending.append(
                        (time.perf_counter() + delay, w, name))
                if retry_pending:
                    now_r = time.perf_counter()
                    due = [e for e in retry_pending if e[0] <= now_r]
                    if due:
                        retry_pending = [e for e in retry_pending
                                         if e[0] > now_r]
                        for _t, w, name in due:
                            if w in dead:
                                # exit_worker already requeued the lease
                                continue
                            backend.transfer(w, name, [])
                        progress = True
                # engine-side readers (RemoteValue.get in a client
                # thread) asking for a lost value to be recomputed: all
                # backend.create calls stay on this thread
                if self._xfer_wanted:
                    with self._xfer_lock:
                        wanted = list(self._xfer_wanted)
                        self._xfer_wanted.clear()
                    door = backend.door
                    for missing in wanted:
                        if missing not in door.values \
                                and spawn_recompute(missing) is not None:
                            emit(REQUEUED, task=missing, n=1,
                                 via="xfer_lost")
                    progress = True
                # liveness: a SIGKILLed process surfaces as a crash
                # (WORKER_DEAD) and its in-flight work requeues via Exit
                for w, reason in backend.check_dead(grace):
                    if w in dead or w not in wstats:
                        continue
                    dead.add(w)
                    self.worker_deaths += 1
                    emit(WORKER_DEAD, worker=w, crash=True, reason=reason)
                    backend.exit_worker(w)
                    self._live = len(alive) - len(dead)
                    progress = True
                    # eager zero-loss: values whose ONLY copy lived in
                    # the dead worker's store are recomputed NOW, not
                    # when (if ever) a dependent trips over the hole —
                    # client-facing RemoteValues have no dependent task
                    door = backend.door
                    for missing, loc in list(door.locations.items()):
                        if loc[0] != w or missing in door.values \
                                or missing not in self.tasks:
                            continue   # alive elsewhere, replicated, or
                        if spawn_recompute(missing) is not None:  # alias
                            emit(REQUEUED, task=missing, n=1,
                                 via="xfer_lost")
                # termination
                if stopping and not backend.has_records():
                    if resident:
                        with self._cond:
                            if self._inflight <= 0 and not self._mailbox:
                                break
                    elif backend.all_done():
                        break
                    elif len(dead) >= len(alive):
                        stalled = True     # every worker died mid-batch
                        break
                if progress:
                    idle_rounds = 0
                else:
                    idle_rounds += 1
                    if idle_rounds >= self.max_idle_rounds and stopping \
                            and not resident:
                        # workers alive but nothing moving: only a true
                        # deadlock (nothing ready, nothing leased) is a
                        # stall — long-running tasks are just busy.  A
                        # sharded hub reports ready and assigned per shard
                        # only: read them there, or a pool still starting
                        # up (nothing moving for max_idle_rounds polls)
                        # would pass for a deadlock
                        st = backend.stats()
                        busy = any(s.get("ready", 0) or s.get("assigned", 0)
                                   for s in st.get("shards", [st]))
                        if not busy and not backend.all_done():
                            stalled = True
                            break
                        idle_rounds = 0
                    time.sleep(self.poll)
        finally:
            self._loop_live = False
            backend.stop_pool()
            # the workers' exit flush has replicated every owned value to
            # the hub by now: materialize outstanding RemoteValue handles
            # while the door still exists (the handles are shared with
            # client futures, so get() caches for them too)
            for res in results.values():
                v = res.value
                if isinstance(v, RemoteValue):
                    try:
                        res.value = v.get()
                    except Exception:  # noqa: BLE001 — unrecoverable value
                        pass           # keep the handle; reads raise
            self._close_xfer_conns()
            journal = self.journal
            if journal is not None:
                journal.sync()
                if self._owns_journal:
                    journal.close()
            if self._owns_backend:
                self.backend.close()
        live_peak = max(peak_workers, 1)
        return EngineReport(
            results=results, trace=self.tracer, workers=live_peak,
            pool_workers=live_peak,
            wall_s=time.perf_counter() - t_wall0,
            errors=self.backend.errors(), stalled=stalled,
            backend_stats=self.backend.stats())

    # ----------------------------------------------- data plane (helpers)
    def _record_xfer(self, task: str, worker: Optional[str], path: str,
                     nbytes: int, dt: float):
        """Attribute one dependency-value transfer: an `xfer` trace event
        (never sampled — fetches are rare next to rpcs), the per-path
        running totals, and the obs metrics sink when wired."""
        self.tracer.emit(XFER, task=task, worker=worker, path=path,
                         n=int(nbytes), dt=float(dt))
        with self._xfer_lock:
            tot = self.xfer_totals.setdefault(path, [0, 0, 0.0])
            tot[0] += 1
            tot[1] += int(nbytes)
            tot[2] += float(dt)
        m = self.xfer_metrics
        if m is not None:
            m.observe(path, int(nbytes), float(dt))

    def _fetch_value_once(self, name: str):
        """One fetch attempt: the hub's value store first (a spill or
        exit-flush may have landed), then a direct dial of the producing
        worker's data listener.  -> (payload, path) or (None, None)."""
        door = self.backend.door
        payload = door.values.get(name)
        path = "hub"
        if payload is None:
            loc = door.locations.get(name)
            if loc is not None and loc[1]:
                addr = loc[1]
                resp = None
                try:
                    comm = self._xfer_conns.get(addr)
                    if comm is None:
                        comm = comm_core.connect(addr)
                        self._xfer_conns[addr] = comm
                    resp = comm.request(Fetch(task=name))
                except Exception:  # noqa: BLE001 — producer gone mid-dial
                    stale = self._xfer_conns.pop(addr, None)
                    if stale is not None:
                        try:
                            stale.close()
                        except Exception:  # noqa: BLE001
                            pass
                if isinstance(resp, ValueMsg):
                    payload = resp.payload
                    path = "peer"
            if payload is None:
                payload = door.values.get(name)  # a spill raced us in
        return (payload, path) if payload is not None else (None, None)

    def _proc_fetch_value(self, name: str):
        """Engine-side RemoteValue materializer, called from client
        threads (`Future.result()`, `gather`).  Cache-miss recovery: when
        the value is gone AND the dispatch loop is live AND the task has a
        packed call with attempt budget left, ask the loop to recompute it
        (`_xfer_wanted` — all backend.create calls stay on the dispatch
        thread) and poll until the store-as lands the value back on the
        hub.  Raises KeyError only when genuinely unrecoverable."""
        t0 = time.perf_counter()
        deadline = t0 + 30.0
        next_ask = t0
        while True:
            payload, path = self._fetch_value_once(name)
            if payload is not None:
                self._record_xfer(name, None, path, len(payload),
                                  time.perf_counter() - t0)
                return loads(payload)
            now = time.perf_counter()
            task = self.tasks.get(name)
            recomputable = (
                self._loop_live and now < deadline
                and task is not None
                and task.meta.get("__call__") is not None
                and self._xfer_attempts.get(name, 0) <= 3)
            if not recomputable:
                raise KeyError(
                    f"value for {name!r} is unrecoverable: not on the hub "
                    "and its producing worker cannot serve it")
            if now >= next_ask:   # re-ask ~1/s: idempotent while an alias
                with self._xfer_lock:          # is live, rolls to the next
                    self._xfer_wanted.add(name)  # attempt once one fails
                next_ask = now + 1.0
            time.sleep(0.02)

    def _close_xfer_conns(self):
        for comm in self._xfer_conns.values():
            try:
                comm.close()
            except Exception:  # noqa: BLE001
                pass
        self._xfer_conns.clear()

    # ------------------------------------------------------------ helpers
    def _priority_of(self, name: str, meta: dict) -> float:
        task = self.tasks.get(name)
        if task is not None:
            return task.priority
        return float(meta.get("priority", 0.0)) if meta else 0.0

    def _slots_of(self, name: str, meta: dict) -> int:
        task = self.tasks.get(name)
        if task is not None:
            return task.slots
        return int(meta.get("slots", 1)) if meta else 1
