"""`Client`: the futures front door over the unified engine, the port's
copy of the JAX package's `repro.client.client`.  The "proc" transport
raises `NotImplementedError` until its modules are ported (ROADMAP.md
Queue 1 item 4g).

One class drives all three schedulers and the serving layer.  The
default (resident) mode owns an `Engine(resident=True)` whose dispatch
loop runs in a background thread: `submit()` builds the task graph
dynamically (futures passed as arguments become engine dependencies —
no pre-declared universe), and every task's first terminal transition
resolves its `Future` through the engine's `on_result` plumbing, so a
`WorkerCrash` requeue re-executes the task but can never double-resolve
the future.

Batch mode (`resident=False`) serves the legacy front doors: the
dwork `run_pool`, `PMake.run`, and engine-backed `mpi_list.Context` are
thin shims that build a universe through the same `submit()` calls and
then `run()` it to a terminal state, returning the familiar
`EngineReport` — one construction path, two execution styles.
"""
from __future__ import annotations

import threading
from typing import Callable, Iterable, Optional

from repro_torch.client.futures import (_CANCELLED, _DONE, CancelledError,
                                        DependencyFailed, Future, TaskFailed)
from repro_torch.core.engine.comm.serialize import RemoteValue
from repro_torch.core.engine.executor import Engine, EngineReport
from repro_torch.core.engine.model import (CREATED, FAILED, WorkerCrash,
                                           next_seq)
from repro_torch.core.engine.tracing import OverheadReport, TraceRecorder

SCHEDULERS = ("dwork", "pmake", "mpi_list")

# per-scheduler defaults: dwork is the bag-of-tasks baseline; pmake needs
# a wide steal window so EFT priorities order globally (the engine's heap
# only ranks tasks it has stolen); mpi_list adapters size steal_n to
# ranks/workers themselves
_DEFAULT_STEAL_N = {"dwork": 4, "pmake": 64, "mpi_list": 4}
# core.metg spells the third scheduler with a dash
_METG_NAME = {"dwork": "dwork", "pmake": "pmake", "mpi_list": "mpi-list"}


class Client:
    """Futures-first front door for every scheduler and the serving layer.

        with Client(scheduler="dwork", workers=4) as c:
            fs = [c.submit(f, x) for x in xs]
            values = c.gather(fs)

    See the `repro_torch.client` package docstring for the per-scheduler
    quickstarts and the bounded-state options
    (`max_trace_events` / `keep_results` / `prune_every`).
    """

    def __init__(self, scheduler: str = "dwork", *, workers: int = 4,
                 transport: str = "inproc", shards: int = 1,
                 steal_n: Optional[int] = None, resident: bool = True,
                 server=None, executor: Optional[Callable] = None,
                 pass_worker: bool = False, tracer=None, faults=None,
                 clock=None, poll: float = 0.001,
                 lease_timeout: Optional[float] = None,
                 tree_fanout: int = 4, tree_levels: int = 1,
                 keep_results: bool = True,
                 max_trace_events: Optional[int] = None,
                 prune_every: int = 0, retry=None,
                 journal_dir=None, **engine_kw):
        scheduler = scheduler.replace("-", "_")
        if scheduler not in SCHEDULERS:
            raise ValueError(f"unknown scheduler {scheduler!r}; "
                             f"pick one of {SCHEDULERS}")
        self.scheduler = scheduler
        self.resident = bool(resident)
        self._executor = executor
        self._executor_pass_worker = bool(pass_worker)
        if steal_n is None:
            steal_n = _DEFAULT_STEAL_N[scheduler]
        if max_trace_events is not None:
            if tracer is not None:
                raise ValueError(
                    "pass max_trace_events OR a pre-built tracer, not "
                    "both — a caller-supplied recorder would silently "
                    "ignore the bound (build it with "
                    "TraceRecorder(max_events=...) instead)")
            tracer = TraceRecorder(clock=clock, max_events=max_trace_events)
        # an existing task universe (run_pool shim): adapt the caller's
        # TaskServer / ShardedHub instead of letting the engine build one
        backend = None
        self._owns_backend = False
        if server is not None:
            backend, lease = self._adapt_server(
                server, transport=transport, workers=workers,
                tree_fanout=tree_fanout, tree_levels=tree_levels,
                tracer=tracer, clock=clock)
            if backend.tracer is not None:
                tracer = backend.tracer
            if lease_timeout is None:
                lease_timeout = lease
            self._owns_backend = transport == "tree"   # sockets to release
        self.engine = Engine(
            workers=workers, transport=transport, steal_n=steal_n,
            shards=shards, backend=backend, tracer=tracer, faults=faults,
            clock=clock, poll=poll, lease_timeout=lease_timeout,
            tree_fanout=tree_fanout, tree_levels=tree_levels,
            resident=self.resident, keep_results=keep_results,
            retry=retry, journal=journal_dir, **engine_kw)
        self._futures: dict[str, Future] = {}
        self._cv = threading.Condition(threading.Lock())  # every Future
        self._waiters = 0                    # result() callers blocked
        self._lifecycle = threading.Lock()
        self._frontends: list = []
        self._closed = False
        self._report: Optional[EngineReport] = None
        self._live_results_needed = False   # a wrapper will _peek mid-run
        self._pruned_any = False            # arms stub containment
        self._loop_failed: Optional[BaseException] = None
        self._prune_every = max(int(prune_every), 0)
        self._resolved = 0
        self._submitted = 0
        self._futures_resolved = 0          # futures only (not __batch etc.)
        self._metrics = None                # MetricsRegistry once attached
        self._stats_servers: list = []      # stopped by close()

    @staticmethod
    def _adapt_server(server, *, transport, workers, tree_fanout,
                      tree_levels, tracer, clock):
        # lazy imports: dwork submodules import engine pieces
        from repro_torch.core.dwork.sharded import ShardedHub
        from repro_torch.core.engine.backends import (ServerBackend,
                                                      ShardedBackend,
                                                      TreeBackend)

        if isinstance(server, ShardedHub):
            lease = (server.shards[0].lease_timeout if server.shards
                     else None)
            if transport == "tree":
                # sharded hub BEHIND the forwarding tree: the top-level
                # routers hash-route the Table-2 verbs per shard
                tracer = tracer or TraceRecorder(clock=clock)
                return TreeBackend(hub=server, workers=workers,
                                   fanout=tree_fanout, levels=tree_levels,
                                   tracer=tracer), lease
            return ShardedBackend(hub=server, tracer=tracer), lease
        if transport == "tree":
            # the Forwarders capture the tracer at construction, so it
            # must exist BEFORE the tree is built or hop events are lost
            tracer = tracer or TraceRecorder(clock=clock)
            return TreeBackend(server=server, workers=workers,
                               fanout=tree_fanout, levels=tree_levels,
                               tracer=tracer), server.lease_timeout
        return (ServerBackend(server=server, tracer=tracer),
                server.lease_timeout)

    # ------------------------------------------------------------- submit
    def submit(self, fn: Callable, *args, key: Optional[str] = None,
               priority: float = 0.0, slots: int = 1, deps=(),
               retry=None, tenant: Optional[str] = None,
               **kwargs) -> Future:
        """Schedule `fn(*args, **kwargs)` and return its `Future`.

        Any `Future` among the arguments is lifted into an engine
        dependency and replaced by its value when the task runs, so
        chains of submits build the DAG dynamically.  `deps` adds extra
        dependencies (futures or task names) that are ordering-only.
        `priority` is greedy-highest-first (pmake EFT); `slots` is the
        pool capacity the task occupies while running (pmake nodes).
        Task names are single-use — pass `key=` only for unique names.

        `retry` attaches a per-task `RetryPolicy` (overrides the
        client-wide `retry=` passed at construction); transient failures
        re-enqueue with backoff instead of failing the future.

        `tenant` labels the task for per-tenant observability: the label
        lands in the task's engine `meta` (the same slot the serving
        layer uses) so accounting tools can slice by tenant.  Purely
        observational — scheduling never looks at it.  (Serving-path
        requests take the label via `Frontend.submit(tenant=)`, which
        also threads it through REQ_* trace events, windowed
        `LatencyReport.by_tenant` slices, and the tenant-labelled
        request-latency histogram.)

        NOTE: `key`, `priority`, `slots`, `deps`, `retry`, and `tenant`
        are reserved by this signature (per the scheduler API) and are
        NOT forwarded to `fn` — to call a function with a same-named
        keyword, wrap it: `c.submit(functools.partial(fn, priority=3),
        x)`."""
        self._check_open()
        name = key if key is not None else \
            f"{getattr(fn, '__name__', 'task')}-{next_seq()}"
        fdeps = [a for a in args if isinstance(a, Future)]
        if kwargs:
            fdeps += [v for v in kwargs.values() if isinstance(v, Future)]
        extra = []
        for d in deps:
            (fdeps if isinstance(d, Future) else extra).append(d)
        dep_names = self._lift_deps(fdeps, extra)
        if dep_names is None:           # a dependency already failed
            return self._fail_fast(name, fdeps)
        fut = Future(self, name)
        engine_kw = {}
        if tenant is not None:
            engine_kw["meta"] = {"tenant": tenant}
        if not all(d.done() for d in fdeps):
            # the wrapper will _peek a producer mid-run, so futures must
            # resolve live (batch run() otherwise defers resolution to
            # the final report and keeps the raw dispatch hot path)
            self._live_results_needed = True
        return self._submit(fut, fn=_make_call(fut, fn, args, kwargs),
                            deps=dep_names, priority=priority,
                            slots=max(int(slots), 1), retry=retry,
                            **engine_kw)

    def submit_task(self, name: str, *, deps=(), meta: Optional[dict] = None,
                    priority: float = 0.0, slots: int = 1,
                    fn: Optional[Callable] = None, retry=None) -> Future:
        """Schedule a NAMED task executed by the client's `executor=`
        callback (or `fn`, a zero-arg callable) — the by-name execution
        style of the pmake and elastic adapters, with a `Future` attached.
        `deps` may mix task names and futures."""
        self._check_open()
        fdeps, extra = [], []
        for d in deps:
            (fdeps if isinstance(d, Future) else extra).append(d)
        dep_names = self._lift_deps(fdeps, extra)
        if dep_names is None:           # a dependency already failed
            return self._fail_fast(name, fdeps)
        return self._submit(Future(self, name), fn=fn, deps=dep_names,
                            meta=meta, priority=priority,
                            slots=max(int(slots), 1), retry=retry)

    def map(self, fn: Callable, *iterables, priority: float = 0.0,
            slots: int = 1) -> list:
        """One future per element (zipped across `iterables`), like
        `distributed.Client.map`."""
        return [self.submit(fn, *xs, priority=priority, slots=slots)
                for xs in zip(*iterables)]

    @staticmethod
    def _lift_deps(fdeps: list, extra: list) -> Optional[list]:
        """Future deps -> engine dep names.  Already-RESOLVED futures are
        satisfied dependencies and are dropped (their value is delivered
        via `_peek` at execution) — re-declaring a name that
        `prune_terminal()` already dropped server-side would resurrect it
        as a READY stub and wedge the dependent.  Returns None when a
        dependency already failed/cancelled: the task must never run
        (client-side fail-fast, since the pruned server may have
        forgotten the failure)."""
        for d in fdeps:
            if d.done() and (d.cancelled() or d._exception is not None):
                return None
        return [d.name for d in fdeps if not d.done()] + extra

    def _fail_fast(self, name: str, fdeps: list) -> Future:
        """Mirror of the engine's failed-dep fail-fast, applied at the
        client layer: resolve the future as DependencyFailed without
        submitting anything.  The name is still registered so the
        single-use contract holds (a later duplicate key raises like
        every other)."""
        bad = next(d for d in fdeps if d.done()
                   and (d.cancelled() or d._exception is not None))
        fut = Future(self, name)
        if self._futures.setdefault(name, fut) is not fut:
            raise ValueError(f"future key {name!r} already in use "
                             "(task names are single-use)")
        tracer = self.engine.tracer
        why = f"dependency {bad.name} failed"
        tracer.emit(CREATED, task=name)
        tracer.emit(FAILED, task=name, error=why)
        fut._resolve(state=_DONE,
                     exception=DependencyFailed(f"{name}: {why}"))
        return fut

    def _check_open(self):
        """Reject submissions that could only produce futures nothing
        will ever resolve: a closed client, a one-shot batch client that
        already ran, or a resident client whose dispatch loop died."""
        if self._closed:
            raise RuntimeError("client is closed")
        if not self.resident and self._report is not None:
            raise RuntimeError(
                "batch client already ran (run() is one-shot); "
                "create a new Client for more work")
        if self.engine._loop_error is not None:
            raise RuntimeError(
                "engine dispatch loop died: "
                f"{self.engine._loop_error!r}")

    def _submit(self, fut: Future, **engine_kw) -> Future:
        """Shared registration + engine submission: registration is an
        atomic setdefault (a concurrent duplicate key cannot displace the
        original future's entry) and MUST precede the engine submit — a
        resident loop may ingest and resolve the task before submit()
        returns.  The engine listeners are attached lazily so
        pure-executor sessions (run_pool shim, the serving frontend
        alone) keep the no-listener fast path."""
        name = fut.name
        if self._futures.setdefault(name, fut) is not fut:
            raise ValueError(f"future key {name!r} already in use "
                             "(task names are single-use)")
        if self.engine.on_result is None:
            self.engine.on_result = self._on_result
            self.engine.on_loop_error = self._on_loop_error
        try:
            self.engine.submit(name, **engine_kw)
        except BaseException:
            # collision with an engine-level (non-future) name; only
            # drop OUR registry entry, never a racing winner's
            if self._futures.get(name) is fut:
                self._futures.pop(name, None)
            raise
        self._submitted += 1
        if (self._loop_failed is not None or self._closed) \
                and not fut.done():
            # the dispatch loop died — or close() ran to completion —
            # while this submit was in flight (after _check_open, after
            # the respective registry drain): nothing will ever resolve
            # this future, so fail it here instead of leaving a
            # permanent waiter
            why = (f"engine dispatch loop died: {self._loop_failed!r}"
                   if self._loop_failed is not None
                   else "client closed during submit")
            self._futures.pop(name, None)
            fut._resolve(state=_DONE,
                         exception=TaskFailed(f"{name}: {why}"))
        return fut

    def _on_loop_error(self, exc: BaseException):
        """The resident dispatch loop died: fail every pending future so
        result()/gather() waiters surface the cause instead of hanging
        (shutdown() still re-raises the original).  `_loop_failed` is set
        FIRST so a submit racing the death either sees it after
        registering (and self-fails in `_submit`) or registers before
        this drain and is failed here."""
        self._loop_failed = exc
        for name in list(self._futures):
            fut = self._futures.pop(name, None)
            if fut is not None and not fut.done():
                fut._resolve(state=_DONE, exception=TaskFailed(
                    f"{name}: engine dispatch loop died: {exc!r}"))

    # ------------------------------------------------------------ results
    def _on_result(self, name: str, ok: bool, res, error: Optional[str]):
        """Engine result plumbing: fires exactly once per task name, on
        the dispatch thread, outside the engine lock.  (The auto-prune
        below marks `_pruned_any`, which arms `_execute`'s
        resurrected-stub containment.)"""
        fut = self._futures.pop(name, None)
        if fut is not None:
            self._futures_resolved += 1
            if ok:
                fut._resolve(state=_DONE, value=res.value, record=res)
            elif error == "cancelled" and res is None:
                fut._resolve(state=_CANCELLED)
            elif fut._pending_exc is not None:
                fut._resolve(state=_DONE, exception=fut._pending_exc,
                             record=res)
            elif res is None:
                # never executed: poisoned upstream / failed at submit
                fut._resolve(state=_DONE,
                             exception=DependencyFailed(f"{name}: {error}"))
            else:
                fut._resolve(state=_DONE,
                             exception=TaskFailed(f"{name}: {error}"))
        self._resolved += 1
        if self._prune_every and self._resolved % self._prune_every == 0:
            self._pruned_any = True
            self.engine.prune_terminal()

    def gather(self, futures: Iterable[Future], *,
               timeout: Optional[float] = None,
               return_exceptions: bool = False) -> list:
        """Wait for every future and return their values in order.  A
        failure raises its exception (after all futures resolved) unless
        `return_exceptions=True`, which returns exceptions in-place.  In
        batch mode the first gather runs the engine."""
        fs = list(futures)
        self._ensure_running()
        # one-shot barrier instead of per-future waits: callbacks run on
        # the dispatch thread, so the countdown needs no lock, and the
        # waiting thread is woken exactly once — per-future condition
        # broadcasts would bounce the GIL on every resolution
        pending = [f for f in fs if not f.done()]
        if pending:
            remaining = [len(pending)]
            lk = threading.Lock()     # immediate callbacks run on THIS
            done_evt = threading.Event()   # thread, late ones on dispatch

            def _one_done(_f):
                with lk:
                    remaining[0] -= 1
                    last = remaining[0] == 0
                if last:
                    done_evt.set()

            for f in pending:
                f.add_done_callback(_one_done)
            if not done_evt.wait(timeout):
                for f in pending:       # a re-polled gather must not
                    f._remove_callback(_one_done)   # accumulate barriers
                n_left = sum(1 for f in fs if not f.done())
                raise TimeoutError(
                    f"gather: {n_left}/{len(fs)} futures unresolved "
                    f"after {timeout}s")
        out, first = [], None
        for f in fs:
            exc = (CancelledError(f.name) if f.cancelled()
                   else f._exception)
            if exc is None:
                if isinstance(f._value, RemoteValue):
                    # data-plane handle: materialize (and cache) on read
                    f._value = f._value.get()
                out.append(f._value)
            elif return_exceptions:
                out.append(exc)
            elif first is None:
                first = exc
        if first is not None:
            raise first
        return out

    def _cancel(self, fut: Future) -> bool:
        if fut.done():
            return False
        return self.engine.cancel(fut.name)

    # ---------------------------------------------------------- lifecycle
    def start(self) -> "Client":
        """Start the resident dispatch loop (idempotent; `with Client(...)
        as c:` and the first blocking wait call this for you)."""
        if not self.resident:
            raise RuntimeError("start() is resident-mode; batch mode "
                               "(resident=False) executes via run()")
        if self._closed:
            raise RuntimeError("client is closed")
        self._start_engine()
        return self

    def _start_engine(self):
        with self._lifecycle:
            if not self.engine.started:
                if self._executor is None:
                    # futures-only session: the engine's own registered-fn
                    # dispatch is the leanest path (no worker plumbing)
                    self.engine.start()
                else:
                    self.engine.start(self._execute, pass_worker=True)

    def _ensure_running(self):
        if self._closed:
            return
        if self.resident:
            if not self.engine.started:
                self.start()
        elif self._report is None:
            self.run()

    def run(self) -> EngineReport:
        """Batch mode: drain the submitted universe to a terminal state
        and resolve every future (the legacy front doors' execution
        path).  One-shot; returns the `EngineReport`."""
        if self.resident:
            raise RuntimeError("run() is batch-mode; resident clients "
                               "drain via gather()/drain()/close()")
        with self._lifecycle:
            # serialized: concurrent result()/gather() waiters must not
            # drive two dispatch loops over the same engine (each would
            # see only a partial result set)
            if self._report is not None:
                return self._report
            execute = None if self._executor is None else self._execute
            if not self._live_results_needed:
                # no wrapper peeks a producer mid-run: drop the per-task
                # result listener so the dispatch loop keeps the raw
                # (run_pool-identical) hot path; every future resolves
                # from the report below — this keeps the legacy shims'
                # measured overhead at the engine baseline
                self.engine.on_result = None
                self.engine.on_loop_error = None
            try:
                report = self.engine.run(execute, pass_worker=True)
            finally:
                if self._owns_backend:
                    self.engine.backend.close()
                    self._owns_backend = False
            self._report = report
            self._resolve_leftovers(report)
            return report

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Resident mode: block until every submitted task is terminal."""
        self._ensure_running()
        return self.engine.drain(timeout)

    def close(self, *, drain: bool = True,
              timeout: Optional[float] = None) -> Optional[EngineReport]:
        """Shut the client down: close any serving frontends, stop the
        resident loop (draining outstanding work by default), and fail
        any future the engine never resolved.  Idempotent; returns the
        final `EngineReport` (None for a never-started resident client)."""
        if self._closed:
            return self._report
        self._closed = True
        try:
            if not self.resident and self._report is None \
                    and self._futures:
                self.run()                # `with Client(resident=False)`
            if self.resident and not self.engine.started and drain \
                    and self._futures and self.engine._loop_error is None:
                self._start_engine()      # lazy start: run pending work
            for fe in self._frontends:
                fe.close(drain=drain, timeout=timeout)
            if self.resident:
                self._report = self.engine.shutdown(drain=drain,
                                                    timeout=timeout)
        finally:
            for srv in self._stats_servers:
                srv.stop()
            self._stats_servers = []
            for name in list(self._futures):
                fut = self._futures.pop(name, None)
                if fut is not None and not fut.done():
                    fut._resolve(state=_DONE, exception=TaskFailed(
                        f"{name}: client closed before completion"))
            if self._owns_backend:
                self.engine.backend.close()
                self._owns_backend = False
        return self._report

    def __enter__(self) -> "Client":
        # inline transports (inproc/tree) run tasks on the dispatch
        # thread itself, so starting the loop during graph construction
        # buys no parallelism — it only GIL-contends with the submitting
        # thread.  The loop starts lazily at the first blocking call
        # (gather / result / drain / serve / close).  transport="thread"
        # has real concurrency to gain (blocking task bodies overlap
        # with submission), so it starts eagerly.
        if self.resident and self.engine.transport == "thread":
            self.start()
        return self

    def __exit__(self, *exc):
        self.close()

    # ---------------------------------------------------------- execution
    def _execute(self, name: str, meta: dict, worker: str):
        """The engine's execute callback when an `executor=` is attached:
        futures-submitted tasks run their wrapped fn (value wrapped so
        the engine never tuple-interprets it); named tasks fall through
        to the executor (pmake scripts, elastic work shards), whose
        return keeps the engine convention (bool | (ok, value) | None)."""
        task = self.engine.tasks.get(name)
        if task is not None and task.fn is not None:
            return (True, task.fn())
        if task is None and self._pruned_any:
            # a name the engine does not know, on a client whose every
            # task IS registered (submit/submit_task): a pruned name
            # resurrected as a server stub by a dep that raced
            # prune_terminal.  Complete it as a no-op — the original
            # already ran; re-invoking the executor would duplicate its
            # side effects.  (run_pool-style pre-created universes never
            # prune, so their unregistered names still reach the
            # executor.)
            return True
        if self._executor_pass_worker:
            return self._executor(name, meta, worker)
        return self._executor(name, meta)

    def _resolve_leftovers(self, report: EngineReport):
        """Batch mode ends with server-side-only terminal states (tasks
        poisoned before the engine ever saw them) — resolve their futures
        from the report."""
        for name in list(self._futures):
            fut = self._futures.pop(name, None)
            if fut is None or fut.done():
                continue
            res = report.results.get(name)
            if res is not None:
                if res.ok:
                    fut._resolve(state=_DONE, value=res.value, record=res)
                elif fut._pending_exc is not None:
                    fut._resolve(state=_DONE, exception=fut._pending_exc,
                                 record=res)
                else:
                    fut._resolve(state=_DONE, exception=TaskFailed(
                        f"{name}: {res.error}"), record=res)
            elif name in report.errors:
                fut._resolve(state=_DONE, exception=DependencyFailed(
                    f"{name}: poisoned by an upstream failure"))
            else:
                why = ("engine stalled before the task ran"
                       if report.stalled else "never reached terminal state")
                fut._resolve(state=_DONE,
                             exception=TaskFailed(f"{name}: {why}"))

    # ------------------------------------------------------------ serving
    def serve(self, execute_batch: Callable, **frontend_kw):
        """Attach a continuous-serving `Frontend` (bounded admission +
        METG-aware dynamic batching) to this client's resident engine and
        start it.  Closed automatically by `close()`."""
        if not self.resident:
            raise RuntimeError("serve() requires resident mode")
        from repro_torch.core.serving import Frontend

        frontend_kw.setdefault("scheduler", _METG_NAME[self.scheduler])
        self.start()
        fe = Frontend(self.engine, execute_batch, **frontend_kw)
        fe.start()
        self._frontends.append(fe)
        if self._metrics is not None:
            # a stats server is already up: fold the new frontend in so
            # its request latencies and admission counters appear live
            from repro_torch.core.obs import instrument

            instrument(self._metrics, frontend=fe,
                       frontend_index=len(self._frontends) - 1)
        return fe

    # --------------------------------------------------------- membership
    def add_worker(self, name: Optional[str] = None) -> str:
        """Grow the live pool (resident elastic scaling)."""
        return self.engine.add_worker(name)

    def lose_worker(self, name: str):
        """Driver-side failure detection: drop a worker, requeue its work."""
        self.engine.lose_worker(name)

    def live_workers(self) -> int:
        return self.engine.live_workers()

    # ---------------------------------------------------------------- obs
    def stats_server(self, port: int = 0, *, host: str = "127.0.0.1"):
        """Start the live observability endpoint for this client: wires a
        `MetricsRegistry` over the engine, backend, frontends, and the
        futures counters (`repro_torch.core.obs.instrument`), then serves
        `/stats`, `/health`, and `/metrics` from an `http.server` thread.
        `port=0` binds an ephemeral port — read it from the returned
        `StatsServer`'s `.url`.  Idempotent metrics wiring; the server is
        stopped automatically by `close()`.

            srv = client.stats_server()
            print(srv.url)   # point  python -m repro_torch.core.obs.top  here
        """
        from repro_torch.core.obs import StatsServer, instrument

        self._metrics = instrument(self._metrics, client=self)
        srv = StatsServer(self._metrics, client=self,
                          host=host, port=port).start()
        self._stats_servers.append(srv)
        return srv

    def report(self) -> OverheadReport:
        """METG accounting for the session so far (or the final report
        after close): the same empirical per-task overhead / tasks-per-s /
        rpc breakdown the engine front doors produce."""
        if self._report is not None:
            return self._report.overhead()
        if self.engine.transport == "thread":
            workers = min(self.engine.workers, self.engine.capacity)
        else:
            workers = 1      # serial inline transports (engine convention)
        return self.engine.tracer.report(workers=max(workers, 1))

    def prune(self) -> int:
        """Bounded-state maintenance: drop terminal history entries from
        the engine and server tables (see `Engine.prune_terminal`)."""
        self._pruned_any = True
        return self.engine.prune_terminal()

    def stats(self) -> dict:
        return self.engine.backend.stats()

    def __repr__(self):
        mode = "resident" if self.resident else "batch"
        state = "closed" if self._closed else (
            "running" if (self.resident and self.engine.started) else "idle")
        return (f"Client({self.scheduler}, {mode}, {state}, "
                f"workers={self.engine.workers}, "
                f"pending={len(self._futures)})")


def _make_call(fut: Future, fn: Callable, args: tuple, kwargs: dict):
    """Wrap a submitted fn: lift Future arguments to their values at
    execution time, capture the real exception object for the future
    (the engine only keeps a repr), and let WorkerCrash propagate so the
    engine requeues instead of failing.  Returns the raw value — the
    registered-fn dispatch path (`_execute_registered` / the client's
    `_execute`) wraps it in (True, value), so user return values are
    never tuple-interpreted by the engine."""
    def call():
        try:
            a = tuple(x._peek() if isinstance(x, Future) else x
                      for x in args)
            if kwargs:
                kw = {k: (v._peek() if isinstance(v, Future) else v)
                      for k, v in kwargs.items()}
                return fn(*a, **kw)
            return fn(*a)
        except WorkerCrash:
            raise
        except Exception as e:          # noqa: BLE001 — delivered via the
            fut._pending_exc = e        # future, task marked failed
            raise
    return call
