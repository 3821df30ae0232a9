"""dhub: the dwork task server (paper §2.2 + Fig. 2 pseudocode), the port's
copy of the JAX package's `repro.core.dwork.server` without the sharded
hub's hooks (`ShardedHub` is not ported yet).

State (exactly two tables + derived runtime info, per the paper):
  joins:  task -> [join_counter, successor list]
  meta:   task -> metadata dict
Derived: ready deque (FIFO steals / LIFO re-inserts), assigned map,
completed set, error set (failed tasks poison their transitive successors).

Fault tolerance: `Exit(worker)` recycles that worker's assigned tasks to
the FRONT of the queue; an optional lease timeout re-queues tasks held too
long (straggler mitigation — framework extension, marked as such).
Persistence: save()/load() round-trips the two tables; ready state is
reconstructed on load (paper: "generated from these tables on startup").
"""
from __future__ import annotations

import json
import threading
import time
from collections import deque
from pathlib import Path
from typing import Callable, Optional

from repro_torch.core.dwork.api import (Cancel, Complete, CompleteSteal,
                                        Create, Exit, ExitResp, NotFound,
                                        Release, Stats, Steal, TaskMsg,
                                        Transfer)


class TaskServer:
    def __init__(self, *, lease_timeout: Optional[float] = None,
                 clock: Optional[Callable[[], float]] = None):
        self.joins: dict[str, list] = {}      # task -> [join_count, [succ]]
        self.meta: dict[str, dict] = {}
        self.ready: deque[str] = deque()
        self.assigned: dict[str, set] = {}    # worker -> {task}
        self.lease: dict[str, float] = {}     # task -> steal time
        self.requeued_tasks: set[str] = set()  # may have duplicate holders
        self.completed: set[str] = set()
        self.errors: set[str] = set()
        self.lease_timeout = lease_timeout
        # injectable heartbeat clock: the engine's fault layer passes a
        # ManualClock so lease expiry is deterministic in tests
        self.clock = clock or time.monotonic
        self.lock = threading.Lock()
        self.counters = {"created": 0, "stolen": 0, "completed": 0,
                         "requeued": 0, "errors": 0}
        # tasks that reached completed OR errors, counted once: keeps
        # _all_done() O(1) — a resident engine probes it on every empty
        # steal, and a full joins-table scan there is O(history)
        self._n_terminal = 0

    # ------------------------------------------------------------------ API
    def handle(self, msg):
        with self.lock:
            if isinstance(msg, CompleteSteal):
                return self._complete_steal(msg)
            if isinstance(msg, Steal):
                return self._steal(msg)
            if isinstance(msg, Complete):
                return self._complete(msg)
            if isinstance(msg, Create):
                return self._create(msg)
            if isinstance(msg, Transfer):
                return self._transfer(msg)
            if isinstance(msg, Exit):
                return self._exit(msg)
            if isinstance(msg, Cancel):
                return self._cancel(msg)
            if isinstance(msg, Release):
                return self._release(msg)
            if isinstance(msg, Stats):
                return self.stats()
            raise TypeError(f"unknown message {msg!r}")

    def create_bulk(self, tasks: list):
        """Local API (not a wire verb): apply a batch of Creates —
        [(name, deps, meta), ...] — under ONE lock hold.  The resident
        engine's mailbox ingest calls this once per round instead of
        paying the handle() ladder and a lock acquisition per task."""
        with self.lock:
            for name, deps, meta in tasks:
                self._create(Create(task=name, deps=list(deps),
                                    meta=dict(meta or {})))

    def _create(self, msg: Create):
        if msg.task in self.joins:
            return NotFound()                 # duplicate create is a no-op
        if any(d in self.errors for d in msg.deps):
            # a dependency already failed: poison at create time — wiring
            # it up as a live dep would leave a join count that no
            # Complete can ever release (the server poisons successors at
            # failure time, so a dependent created later would dangle)
            self.joins[msg.task] = [0, []]
            self.meta[msg.task] = dict(msg.meta)
            self.counters["created"] += 1
            self._poison(msg.task)
            return ExitResp()
        live_deps = [d for d in msg.deps if d not in self.completed]
        # hold: delegation-as-assignment (paper §6) — an extra join count
        # released by a remote database/worker via Release
        self.joins[msg.task] = [len(live_deps) + (1 if msg.hold else 0), []]
        self.meta[msg.task] = dict(msg.meta)
        for d in live_deps:
            if d not in self.joins:           # forward-declared dependency
                self.joins[d] = [0, []]
                self.meta.setdefault(d, {})
                self.ready.append(d)
            self.joins[d][1].append(msg.task)
        if not live_deps and not msg.hold:
            self.ready.append(msg.task)       # FIFO tail
        self.counters["created"] += 1
        return ExitResp()

    def _steal(self, msg: Steal):
        self._reap_leases()
        out = []
        while self.ready and len(out) < max(1, msg.n):
            t = self.ready.popleft()          # FIFO: oldest ready first
            if t in self.errors or t in self.completed:
                # completed: a stale ready entry left by a late Complete
                # after a lease-timeout requeue — must not be re-executed
                continue
            self.assigned.setdefault(msg.worker, set()).add(t)
            self.lease[t] = self.clock()
            out.append((t, self.meta.get(t, {})))
        if out:
            self.counters["stolen"] += len(out)
            return TaskMsg(tasks=out)
        if self._all_done():
            return ExitResp()                 # paper: respond 'Exit'
        return NotFound()

    def _complete(self, msg: Complete):
        self._finish(msg.worker, msg.task, msg.ok)
        return ExitResp()

    def _finish(self, worker: str, t: str, ok: bool):
        self.assigned.get(worker, set()).discard(t)
        self.lease.pop(t, None)
        if t in self.requeued_tasks:
            # the task was requeued (lease expiry / Exit) so it may have
            # been re-stolen: a terminal task's assignment is stale
            # wherever it lives — clear every holder (exactly-once
            # terminal).  Never-requeued tasks (the hot path) have
            # exactly one holder and skip the all-workers scan.
            self.requeued_tasks.discard(t)
            for held in self.assigned.values():
                held.discard(t)
        if t in self.completed:
            return                            # exactly-once: idempotent
        if not ok:
            self._poison(t)
            return
        self.completed.add(t)
        self.counters["completed"] += 1
        if t not in self.errors:
            self._n_terminal += 1
        for succ in self.joins.get(t, [0, []])[1]:
            j = self.joins.get(succ)
            if j is None:
                # successor pruned while this dep was still live (it was
                # already terminal — poisoned dep-waiting): nothing left
                # to notify
                continue
            j[0] -= 1
            if j[0] == 0 and succ not in self.completed:
                self.ready.append(succ)

    def _complete_steal(self, msg: CompleteSteal):
        """Fig. 2 batch-then-drain in one round-trip: apply the finished
        batch, then serve the next steal — all under one lock hold."""
        for t, ok in msg.done:
            self._finish(msg.worker, t, ok)
        if msg.n <= 0:
            return ExitResp()                 # complete-only
        return self._steal(Steal(worker=msg.worker, n=msg.n))

    def _transfer(self, msg: Transfer):
        """Move a task back from worker to manager, adding dependencies.
        Re-inserted tasks go to the FRONT (work-stealing deque, §2.2)."""
        t = msg.task
        self.assigned.get(msg.worker, set()).discard(t)
        self.lease.pop(t, None)
        live = [d for d in msg.new_deps if d not in self.completed]
        self.joins.setdefault(t, [0, []])
        self.joins[t][0] += len(live)
        for d in live:
            if d not in self.joins:
                self.joins[d] = [0, []]
                self.meta.setdefault(d, {})
                self.ready.append(d)
            self.joins[d][1].append(t)
        if self.joins[t][0] == 0:
            self.ready.appendleft(t)          # LIFO head
        return ExitResp()

    def _exit(self, msg: Exit):
        """Node failure/abort: recycle the worker's assigned tasks."""
        for t in sorted(self.assigned.pop(msg.worker, set())):
            self.lease.pop(t, None)
            self.ready.appendleft(t)
            self.requeued_tasks.add(t)
            self.counters["requeued"] += 1
        return ExitResp()

    def _cancel(self, msg: Cancel):
        """Withdraw a task no worker holds (futures-client cancel): succeeds
        only while the task is unleased and non-terminal, then poisons it
        like a failure so transitive successors can never run.  A task
        already stolen (leased), terminal, or unknown returns NotFound —
        the cancel loses the race and the caller must treat the task as
        live.  Serialized against Steal by the server lock, so a task is
        never both cancelled and handed to a worker."""
        self._reap_leases()
        t = msg.task
        if (t not in self.joins or t in self.completed or t in self.errors
                or t in self.lease or t in self.requeued_tasks):
            # requeued_tasks: a lease-expired requeue may STILL be
            # executing on its straggler worker — "cancelled" must mean
            # "never runs", so a possibly-running task is not cancellable
            return NotFound()
        try:
            self.ready.remove(t)          # may be dep-waiting, not ready
        except ValueError:
            pass
        self._poison(t)
        return ExitResp()

    def _release(self, msg: Release):
        j = self.joins.get(msg.task)
        if j is None or msg.task in self.completed:
            return NotFound()
        j[0] -= 1
        if j[0] == 0:
            self.ready.append(msg.task)
        return ExitResp()

    # ------------------------------------------------------------- helpers
    def _poison(self, t: str):
        """Failed task: mark it and all transitive successors as errors."""
        stack = [t]
        while stack:
            cur = stack.pop()
            if cur in self.errors:
                continue
            if cur not in self.joins and cur != t:
                # a pruned ghost in a live successor list: already
                # terminal before it was pruned — re-adding it to errors
                # would inflate _n_terminal past the live table
                continue
            self.errors.add(cur)
            self.counters["errors"] += 1
            if cur not in self.completed:
                self._n_terminal += 1
            stack.extend(self.joins.get(cur, [0, []])[1])

    def _reap_leases(self):
        if self.lease_timeout is None:
            return
        now = self.clock()
        expired = [t for t, ts in self.lease.items()
                   if now - ts > self.lease_timeout]
        for t in expired:
            for w, ts in self.assigned.items():
                ts.discard(t)
            self.lease.pop(t, None)
            self.ready.appendleft(t)
            self.requeued_tasks.add(t)
            self.counters["requeued"] += 1

    def _all_done(self) -> bool:
        return self._n_terminal >= len(self.joins)

    def prune_terminal(self, keep=()) -> list:
        """Bounded-state hook for long-lived resident services: drop the
        history-table entries (joins/meta/completed/errors) of tasks that
        reached a terminal state, returning the pruned names (callers
        holding per-name side tables delete exactly those keys).  Names in
        `keep` are retained (the engine passes deps of submissions still in
        its mailbox).

        Contract: only call when no FUTURE Create will name a pruned task
        as a dependency — a pruned completed task would be re-declared as
        a READY stub (and a pruned failed one would no longer poison its
        new dependents).  Single-use task names (the futures client, the
        serving frontend) satisfy this by construction.  Tasks with a
        stale ready entry or a stale holder (requeue races) are kept so a
        late duplicate can still be recognized as terminal."""
        with self.lock:
            ready_set = set(self.ready)
            held: set = set()
            for ts in self.assigned.values():
                held |= ts
            pruned: list = []
            for t in list(self.completed) + list(self.errors):
                if t in ready_set or t in held or t in self.requeued_tasks \
                        or t in keep:
                    continue
                if self.joins.pop(t, None) is None:
                    continue                  # already pruned (both sets)
                self.meta.pop(t, None)
                self.completed.discard(t)
                self.errors.discard(t)
                self.lease.pop(t, None)
                pruned.append(t)
            self._n_terminal -= len(pruned)
            return pruned

    def stats(self) -> dict:
        return {
            "tasks": len(self.joins), "ready": len(self.ready),
            "assigned": sum(len(s) for s in self.assigned.values()),
            "completed": len(self.completed), "errors": len(self.errors),
            **self.counters,
        }

    # --------------------------------------------------------- persistence
    def save(self, path: str):
        state = {"joins": {k: [v[0], v[1]] for k, v in self.joins.items()},
                 "meta": self.meta,
                 "completed": sorted(self.completed),
                 "errors": sorted(self.errors)}
        Path(path).write_text(json.dumps(state))

    @classmethod
    def load(cls, path: str, **kw) -> "TaskServer":
        state = json.loads(Path(path).read_text())
        srv = cls(**kw)
        srv.joins = {k: [v[0], list(v[1])] for k, v in state["joins"].items()}
        srv.meta = state["meta"]
        srv.completed = set(state["completed"])
        srv.errors = set(state["errors"])
        srv._n_terminal = len(srv.completed | srv.errors)
        # reconstruct ready: join==0, not completed/errored (assigned tasks
        # from the previous run are implicitly requeued — crash tolerance)
        for t, (j, _succ) in srv.joins.items():
            if j == 0 and t not in srv.completed and t not in srv.errors:
                srv.ready.append(t)
        return srv
