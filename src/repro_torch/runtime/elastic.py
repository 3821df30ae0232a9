"""Elastic worker pool: the futures client's resident engine as the
fault-tolerance layer; the port's copy of the JAX package's
`repro.runtime.elastic`.

Training work-shards / inference request batches are engine tasks
submitted through `repro_torch.client.Client` (each returns a `Future`);
the client's resident `Engine` dispatches them, and membership changes
(`start_worker` / `lose_worker`) invoke a `remesh` callback so the
runtime can re-lower the step for the new device count (elastic
scaling) and resume from the latest checkpoint.  A worker crash
(`fail_after` drills, or any `WorkerCrash` raised from the step
function) announces Exit so the in-flight tasks are requeued — never
lost, never marked failed; a silently wedged worker is reaped by the
engine's heartbeat lease.

METG-aware batching (paper §5, automated): `steal_n` is re-derived on
EVERY membership change so per-steal work tracks the live worker count —
the engine re-reads it each dispatch round, so the new batch size applies
without restarting anything.

This module is a thin client of the futures-era engine: the per-worker
steal/complete loops that used to live here are the engine's dispatch
loop, and task plumbing is the client's (`submit` hands back a `Future`
that resolves exactly once across crash requeues).
"""
from __future__ import annotations

import threading
from typing import Callable, Optional

from repro_torch.client import Client, Future
from repro_torch.core.engine import WorkerCrash
from repro_torch.core.metg import METGModel, pick_batch_size


class ElasticPool:
    def __init__(self, *, lease_timeout: float = 30.0,
                 remesh: Optional[Callable[[int], None]] = None,
                 per_task_s: float = 1.0):
        self.client = Client(scheduler="dwork", workers=0, resident=True,
                             lease_timeout=lease_timeout,
                             executor=self._execute, pass_worker=True)
        self.engine = self.client.engine
        self.remesh = remesh
        self.per_task_s = per_task_s
        self.metg = METGModel.from_paper()
        self.workers: dict[str, Callable] = {}    # worker -> execute fn
        self._crash_after: dict[str, int] = {}
        self._done: dict[str, int] = {}
        self._lock = threading.Lock()
        self.completed: list = []
        self.client.start()

    # ------------------------------------------------------------------
    def submit(self, name: str, deps=(), meta=None) -> Future:
        """Queue a named work shard; the returned `Future` resolves when
        the shard reaches its terminal state (exactly once, across any
        crash requeues)."""
        return self.client.submit_task(name, deps=deps, meta=meta)

    def steal_n_for(self, n_workers: int) -> int:
        # shards divide dwork's dispatch bound, so a sharded hub (alone
        # or behind the forwarding tree) needs proportionally less
        # batching at the same worker count
        return pick_batch_size("dwork", max(n_workers, 1), self.per_task_s,
                               model=self.metg, shards=self.engine.shards)

    def _retune(self):
        """Membership changed: re-derive the METG batch size for the live
        worker count and tell the runtime to re-lower (remesh)."""
        n = len(self.workers)
        self.engine.steal_n = self.steal_n_for(n)
        if self.remesh:
            self.remesh(n)

    def _execute(self, name: str, meta: dict, worker: str):
        limit = self._crash_after.get(worker)
        if limit is not None and self._done.get(worker, 0) >= limit:
            # simulated node crash: the engine requeues everything this
            # worker still holds (including this task) — zero loss
            raise WorkerCrash(f"{worker} crashed after {limit} tasks")
        fn = self.workers.get(worker)
        if fn is None:
            # lose_worker() raced the dispatch loop: the executor was
            # deregistered while this task was already stolen — crash the
            # worker so the task is REQUEUED, never marked failed
            raise WorkerCrash(f"{worker} was lost mid-task")
        ok = fn(name, meta)
        with self._lock:
            self.completed.append((worker, name))
            self._done[worker] = self._done.get(worker, 0) + 1
        return ok

    def start_worker(self, worker_id: str,
                     execute: Callable[[str, dict], bool], *,
                     fail_after: Optional[int] = None) -> str:
        """fail_after: simulate a node crash after N tasks (tests/drills)."""
        self.workers[worker_id] = execute
        self._done[worker_id] = 0
        if fail_after is not None:
            self._crash_after[worker_id] = fail_after
        self._retune()
        self.client.add_worker(worker_id)
        return worker_id

    def lose_worker(self, worker_id: str):
        """Caller-side failure detection (paper: Exit may be called by the
        user to recover from a node failure)."""
        self.client.lose_worker(worker_id)
        self.workers.pop(worker_id, None)
        self._retune()

    def join(self, timeout: float = 60.0) -> dict:
        """Wait for every submitted task to reach a terminal state and
        return the server stats.  The pool stays up — more work can be
        submitted after a join (continuous service)."""
        self.client.drain(timeout)
        return self.client.stats()

    def shutdown(self):
        """Stop the resident loop for good; returns the EngineReport."""
        if self.engine.started:
            return self.client.close()
        return None

    # a pool abandoned without shutdown() must not keep a dispatch thread
    # busy-waking for the life of the process
    def __enter__(self) -> "ElasticPool":
        return self

    def __exit__(self, *exc):
        self.shutdown()

    def __del__(self):
        try:
            if self.engine.started:
                self.engine.shutdown(drain=False, timeout=2.0)
        except Exception:  # noqa: BLE001 — interpreter-teardown best effort
            pass
