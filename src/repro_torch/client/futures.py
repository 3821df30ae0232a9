"""Futures for the client layer: one `Future` per submitted task; the
port's copy of the JAX package's `repro.client.futures`.

A `Future` is resolved exactly once, from the engine's first-terminal
notification (`Engine.on_result`) — requeued re-executions after a
worker crash never re-resolve it.  Futures share their owning client's
condition variable instead of carrying a per-future `threading.Event`,
which keeps the per-submit allocation cost low enough for the
`BENCH_client.json` overhead gate (client path <= 2x the raw engine
path).

Failure taxonomy (what `result()` raises):

    TaskFailed        the task itself failed without raising a Python
                      exception the client could capture (executor
                      returned ok=False, injected fault, engine stall)
    DependencyFailed  the task never ran because an upstream dependency
                      failed or was cancelled (failure poisoning,
                      surfaced downstream)
    CancelledError    this future was cancelled via `Future.cancel()`
    <original exc>    the task's function raised: the exception object
                      is captured in-process and re-raised verbatim
"""
from __future__ import annotations

import queue
import time
from typing import Callable, Iterable, Optional

from repro_torch.core.engine.comm.serialize import RemoteValue


class CancelledError(Exception):
    """The future was cancelled before its task was stolen."""


class TaskFailed(RuntimeError):
    """The task reached the failed terminal state without a captured
    Python exception (executor returned ok=False, injected fault, or the
    engine stalled before the task could run)."""


class DependencyFailed(TaskFailed):
    """The task was poisoned: an upstream dependency failed or was
    cancelled, so this task can never run (dwork terminal-state
    semantics surfaced on the downstream future)."""


_PENDING = "pending"
_DONE = "done"
_CANCELLED = "cancelled"


class Future:
    """Handle for one submitted task.  Created by `Client.submit` /
    `Client.map` / `Client.submit_task`; may be passed as an argument to
    a later `submit`, where it is lifted into an engine dependency and
    replaced by its value at execution time (dynamic DAG construction).
    """

    __slots__ = ("_client", "name", "_state", "_value", "_exception",
                 "_record", "_callbacks", "_pending_exc")

    def __init__(self, client, name: str):
        self._client = client
        self.name = name
        self._state = _PENDING
        self._value = None
        self._exception: Optional[BaseException] = None
        self._record = None             # TaskResult of the counted execution
        self._callbacks: list = []
        self._pending_exc: Optional[BaseException] = None

    # -------------------------------------------------------------- state
    def done(self) -> bool:
        """True once resolved (value, exception, or cancelled)."""
        return self._state is not _PENDING

    def cancelled(self) -> bool:
        return self._state is _CANCELLED

    @property
    def task_result(self):
        """The engine `TaskResult` of the execution that resolved this
        future (None while pending or when the task never executed —
        poisoned, cancelled, or failed at submit).  Carries the per-rank
        timings the mpi-list adapter feeds the Gumbel straggler law."""
        return self._record

    def result(self, timeout: Optional[float] = None):
        """The task's value.  Blocks until resolved; raises `TimeoutError`
        on expiry, `CancelledError` if cancelled, or the task's failure
        (the original exception when it raised in-process, `TaskFailed` /
        `DependencyFailed` otherwise)."""
        self._wait(timeout)
        if self._state is _CANCELLED:
            raise CancelledError(self.name)
        if self._exception is not None:
            raise self._exception
        if isinstance(self._value, RemoteValue):
            # peer-to-peer data plane: the payload stayed in its producing
            # worker's store — materialize (and cache) on first read
            self._value = self._value.get()
        return self._value

    def exception(self, timeout: Optional[float] = None
                  ) -> Optional[BaseException]:
        """The task's exception (None on success).  Blocks like
        `result()`; raises `CancelledError` if the future was cancelled
        (concurrent.futures semantics)."""
        self._wait(timeout)
        if self._state is _CANCELLED:
            raise CancelledError(self.name)
        return self._exception

    def cancel(self) -> bool:
        """Withdraw the task if no worker has stolen it yet.  True means
        the task will never run (dependents are poisoned and observe
        `DependencyFailed`); False means it is already running, done, or
        the scheduler won the race."""
        return self._client._cancel(self)

    def add_done_callback(self, fn: Callable[["Future"], None]):
        """Call `fn(future)` when the future resolves (immediately if it
        already has).  Callbacks run on the engine's dispatch thread —
        keep them short and never block on another future from the same
        client."""
        with self._client._cv:
            if self._state is _PENDING:
                self._callbacks.append(fn)
                return
        fn(self)

    def _remove_callback(self, fn):
        """Unregister a pending callback (gather's timeout path, so
        repeated polls don't accumulate dead barrier closures)."""
        with self._client._cv:
            try:
                self._callbacks.remove(fn)
            except ValueError:
                pass

    def __repr__(self):
        if self._state is _PENDING:
            state = "pending"
        elif self._state is _CANCELLED:
            state = "cancelled"
        elif self._exception is not None:
            state = f"error={self._exception!r}"
        else:
            state = "ok"
        return f"Future({self.name}, {state})"

    # ----------------------------------------------------------- plumbing
    def _wait(self, timeout: Optional[float]):
        if self._state is not _PENDING:
            return
        client = self._client
        client._ensure_running()
        cv = client._cv
        with cv:
            client._waiters += 1
            try:
                if not cv.wait_for(lambda: self._state is not _PENDING,
                                   timeout):
                    raise TimeoutError(
                        f"future {self.name} unresolved after {timeout}s")
            finally:
                client._waiters -= 1

    def _peek(self):
        """Dependency lift: the producer's value, called from a dependent
        task's execution.  The engine only runs a dependent after every
        dependency completed, so an unresolved producer here is an engine
        ordering bug, not a user error."""
        if self._state is _PENDING:
            raise RuntimeError(
                f"dependency {self.name} executed out of order")
        if self._state is _CANCELLED or self._exception is not None:
            raise DependencyFailed(f"dependency {self.name} failed")
        return self._value

    def _resolve(self, *, state: str, value=None,
                 exception: Optional[BaseException] = None, record=None):
        """Exactly-once resolution; late duplicates are dropped."""
        client = self._client
        cv = client._cv
        with cv:
            if self._state is not _PENDING:
                return
            self._value = value
            self._exception = exception
            self._record = record
            self._state = state
            callbacks, self._callbacks = self._callbacks, []
            # broadcast only when a result()/exception() caller is
            # actually blocked: resolutions outnumber waits by orders of
            # magnitude on a busy client, and every needless notify is a
            # cross-thread GIL bounce on the dispatch hot path (gather
            # rides a one-shot barrier callback instead)
            if client._waiters:
                cv.notify_all()
        for fn in callbacks:
            try:
                fn(self)
            except Exception:           # noqa: BLE001 — a user callback
                pass                    # must not kill the dispatch loop


def as_completed(futures: Iterable[Future],
                 timeout: Optional[float] = None):
    """Yield futures in completion order (like
    `concurrent.futures.as_completed`).  Raises `TimeoutError` if not
    every future resolves within `timeout` seconds."""
    futures = list(futures)
    done_q: queue.Queue = queue.Queue()
    for f in futures:
        f._client._ensure_running()
        f.add_done_callback(done_q.put)
    deadline = None if timeout is None else time.monotonic() + timeout
    try:
        for _ in range(len(futures)):
            remaining = (None if deadline is None
                         else deadline - time.monotonic())
            if remaining is not None and remaining <= 0:
                raise TimeoutError("as_completed timed out")
            try:
                yield done_q.get(timeout=remaining)
            except queue.Empty:
                raise TimeoutError("as_completed timed out") from None
    finally:
        # timeout or an abandoned generator must not leave dead
        # callbacks (pinning the queue) on still-pending futures
        for f in futures:
            if not f.done():
                f._remove_callback(done_q.put)
