"""Scheduler backends: the engine's view of a task database, the port's
copy of the JAX package's `repro.core.engine.backends` (`TreeBackend`
raises until the forwarding tree is ported).

A backend adapts a concrete scheduler state (dwork `TaskServer`, sharded
`ShardedHub`, or a TaskServer behind a forwarding tree) to the uniform
protocol the worker pool speaks — the paper's Table 2 wire API:

    create(name, deps, meta)            Create
    steal(worker, n) -> tasks|EMPTY|DONE   Steal -> TaskMsg|NotFound|Exit
    complete(worker, name, ok)          Complete (ok=False poisons succs)
    complete_steal(worker, done, n)     CompleteSteal: batched completions
                                        piggybacked on the next steal —
                                        ONE round-trip per batch in both
                                        protocol directions (Fig. 2)
    exit_worker(worker)                 Exit (recycle assignment)
    cancel(name) -> bool                Cancel: withdraw an unleased task
                                        (futures client; framework extension)
    prune_terminal() -> int             drop terminal history entries
                                        (bounded state; maintenance hook)
    close()                             release transports (tree sockets)

Every call is timed and emitted as an `rpc` trace event — the measured
analog of the paper's 23 us per-task RTT (Table 4).  `TreeBackend` hops
additionally emit `op="hop:<label>"` events so `OverheadReport.rpc_by_op`
attributes forwarding-tree latency per level.
"""
from __future__ import annotations

import time
from typing import Optional

from repro_torch.core.dwork.api import (Cancel, Complete, CompleteSteal,
                                        Create, Exit, ExitResp, NotFound,
                                        Steal, TaskMsg, Transfer)
from repro_torch.core.dwork.server import TaskServer
from repro_torch.core.dwork.sharded import ShardedHub
from repro_torch.core.engine.model import REQUEUED, RPC

# steal() sentinels
EMPTY = "empty"                 # nothing ready now, but work remains
DONE = "done"                   # every task reached a terminal state


def _steal_result(resp):
    """Decode a Steal/CompleteSteal response into the engine's uniform
    (tasks | EMPTY | DONE) — one ladder shared by every backend."""
    if isinstance(resp, TaskMsg):
        return [tuple(t) for t in resp.tasks]
    if isinstance(resp, ExitResp):
        return DONE
    return EMPTY


class ServerBackend:
    """Engine backend over a single dwork `TaskServer` (paper §2.2)."""

    n_shards = 1          # dispatch-rate multiplier for the METG laws

    def __init__(self, server: Optional[TaskServer] = None, *,
                 lease_timeout: Optional[float] = None, clock=None,
                 tracer=None):
        self.server = server or TaskServer(lease_timeout=lease_timeout,
                                           clock=clock)
        self.tracer = tracer
        # optional rpc-latency sink (the JAX package's obs RpcMetrics;
        # the port has no core/obs yet): fed the
        # same sampled timings the trace gets, so rpc_sample= thins both
        self.metrics = None
        # optional write-ahead journal (engine.journal.Journal): requeue
        # events are backend-observed, so the engine hands its journal
        # down for the ["rq", n, via] records
        self.journal = None

    # ------------------------------------------------------------ timing
    def _request(self, msg):
        """Deliver one protocol message — subclasses reroute this (the
        tree sends it over the calling worker's forwarder connection)."""
        return self.server.handle(msg)

    def _requeued_total(self) -> int:
        """Requeue counter across the whole backing store (subclasses
        with several servers sum them)."""
        return self.server.counters["requeued"]

    def _call(self, op: str, msg):
        tracer = self.tracer
        if tracer is None or not tracer.sample_rpc():
            # unsampled: skip the perf_counter pair AND the event
            # allocation — the call is still counted in tracer.rpc_seen
            return self._request(msg)
        t0 = time.perf_counter()
        resp = self._request(msg)
        dt = time.perf_counter() - t0
        tracer.emit(RPC, op=op, dt=dt)
        m = self.metrics
        if m is not None:
            m.observe(op, dt)
        return resp

    def _note_requeues(self, before: int):
        n = self._requeued_total() - before
        if n > 0:
            if self.tracer is not None:
                self.tracer.emit(REQUEUED, n=n, via="lease")
            if self.journal is not None:
                self.journal.append_requeue(n, "lease")

    # ---------------------------------------------------------- protocol
    def create(self, name: str, deps=(), meta=None):
        self._call("create", Create(task=name, deps=list(deps),
                                    meta=dict(meta or {})))

    def create_many(self, tasks: list):
        """Batched Create — `tasks` is [(name, deps, meta), ...].  One
        timed `rpc` event and one server lock hold cover the whole batch
        (the resident engine's mailbox ingest path: per-create timing
        apparatus would otherwise rival the create itself)."""
        tracer = self.tracer
        if tracer is None or not tracer.sample_rpc():
            self.server.create_bulk(tasks)
            return
        t0 = time.perf_counter()
        self.server.create_bulk(tasks)
        dt = time.perf_counter() - t0
        tracer.emit(RPC, op="create_many", dt=dt, n=len(tasks))
        m = self.metrics
        if m is not None:
            m.observe("create_many", dt)

    def steal(self, worker: str, n: int = 1):
        before = self._requeued_total()
        resp = self._call("steal", Steal(worker=worker, n=n))
        self._note_requeues(before)
        return _steal_result(resp)

    def complete(self, worker: str, name: str, ok: bool = True):
        self._call("complete", Complete(worker=worker, task=name, ok=ok))

    def complete_steal(self, worker: str, done, n: int = 0):
        """Batched completions + the next steal in ONE round-trip."""
        before = self._requeued_total()
        resp = self._call("complete_steal",
                          CompleteSteal(worker=worker, done=list(done), n=n))
        self._note_requeues(before)
        return _steal_result(resp) if n > 0 else EMPTY

    def exit_worker(self, worker: str):
        before = self._requeued_total()
        self._call("exit", Exit(worker=worker))
        n = self._requeued_total() - before
        if n > 0:
            if self.tracer is not None:
                self.tracer.emit(REQUEUED, worker=worker, n=n, via="exit")
            if self.journal is not None:
                self.journal.append_requeue(n, "exit")
        return n

    def cancel(self, name: str) -> bool:
        """Withdraw an unleased, non-terminal task (futures-client cancel);
        False means the cancel lost the race (stolen/terminal/unknown)."""
        resp = self._call("cancel", Cancel(task=name))
        return isinstance(resp, ExitResp)

    def transfer(self, worker: str, name: str, new_deps=()):
        """Table-2 Transfer: put `worker`'s leased task back into the
        queue, blocked on `new_deps` (dynamic task graphs; the engine's
        lost-value recompute path requeues dependents through this)."""
        return self._call("transfer",
                          Transfer(worker=worker, task=name,
                                   new_deps=list(new_deps)))

    def prune_terminal(self, keep=()) -> int:
        """Drop terminal entries from the server history tables (bounded
        state for resident services; see TaskServer.prune_terminal)."""
        return len(self.server.prune_terminal(keep=keep))

    def errors(self) -> set:
        return set(self.server.errors)

    def ready_depth(self) -> int:
        """Tasks ready-to-steal right now (no RPC — a monitoring probe for
        the serving layer's queue-depth accounting, not a protocol verb)."""
        return len(self.server.ready)

    def ready_depths(self) -> list:
        """Per-shard ready depths (monitoring probe; one entry here)."""
        return [self.ready_depth()]

    def stats(self) -> dict:
        return self.server.stats()

    def close(self):
        pass


class ShardedBackend:
    """Engine backend over a `ShardedHub` — sharded routing with worker
    affinity and cross-shard stealing (paper §6 expansion item 4)."""

    def __init__(self, hub: Optional[ShardedHub] = None, *, shards: int = 2,
                 lease_timeout: Optional[float] = None, clock=None,
                 tracer=None):
        self.hub = hub or ShardedHub(shards, lease_timeout=lease_timeout,
                                     clock=clock)
        self.tracer = tracer
        self.metrics = None                   # see ServerBackend.metrics
        self.journal = None                   # see ServerBackend.journal
        self._shard_of: dict[str, int] = {}   # stolen task -> serving shard

    @property
    def n_shards(self) -> int:
        return len(self.hub.shards)

    def _sampled(self) -> bool:
        return self.tracer is not None and self.tracer.sample_rpc()

    def _emit_rpc(self, op: str, dt: float):
        self.tracer.emit(RPC, op=op, dt=dt)
        m = self.metrics
        if m is not None:
            m.observe(op, dt)

    def _requeued_total(self) -> int:
        return self.hub.requeued_total()

    # shard affinity from the engine's worker naming (w<i>) — one
    # definition, shared with the hub's own wire-boundary routing
    _affinity = staticmethod(ShardedHub._affinity)

    def create(self, name: str, deps=(), meta=None):
        sampled = self._sampled()
        t0 = time.perf_counter() if sampled else 0.0
        self.hub.create(name, deps=deps, meta=meta)
        if sampled:
            self._emit_rpc("create", time.perf_counter() - t0)

    def create_many(self, tasks: list):
        sampled = self._sampled()
        t0 = time.perf_counter() if sampled else 0.0
        for name, deps, meta in tasks:
            self.hub.create(name, deps=deps, meta=meta)
        if sampled:
            self._emit_rpc("create_many", time.perf_counter() - t0)

    def steal(self, worker: str, n: int = 1):
        sampled = self._sampled()
        t0 = time.perf_counter() if sampled else 0.0
        resp, shard = self.hub.steal(worker, n=n,
                                     affinity=self._affinity(worker))
        if sampled:
            self._emit_rpc("steal", time.perf_counter() - t0)
        if isinstance(resp, TaskMsg):
            for name, _meta in resp.tasks:
                self._shard_of[name] = shard
            return list(resp.tasks)
        if isinstance(resp, ExitResp):
            return DONE
        return EMPTY

    def complete(self, worker: str, name: str, ok: bool = True):
        shard = self._shard_of.pop(name, None)
        if shard is None:
            # duplicate completion (e.g. a late report for a re-stolen
            # task): route by the hub's authoritative home map — never
            # guess a shard
            shard = self.hub.home.get(name)
            if shard is None:
                return
        sampled = self._sampled()
        t0 = time.perf_counter() if sampled else 0.0
        self.hub.complete(worker, name, shard, ok=ok)
        if sampled:
            self._emit_rpc("complete", time.perf_counter() - t0)

    def complete_steal(self, worker: str, done, n: int = 0):
        """Batched completions grouped per home shard, then the next steal
        — one timed backend round-trip for the whole batch."""
        sampled = self._sampled()
        t0 = time.perf_counter() if sampled else 0.0
        routed = []
        for name, ok in done:
            shard = self._shard_of.pop(name, None)
            if shard is None:
                shard = self.hub.home.get(name)
                if shard is None:
                    continue
            routed.append((name, ok, shard))
        resp, shard = self.hub.complete_steal(
            worker, routed, n=n, affinity=self._affinity(worker))
        out = EMPTY
        if n > 0:
            if isinstance(resp, TaskMsg):
                for name, _meta in resp.tasks:
                    self._shard_of[name] = shard
                out = list(resp.tasks)
            elif isinstance(resp, ExitResp):
                out = DONE
        if sampled:
            self._emit_rpc("complete_steal", time.perf_counter() - t0)
        return out

    def exit_worker(self, worker: str):
        before = self.hub.requeued_total()
        self.hub.exit_worker(worker)
        n = self.hub.requeued_total() - before
        if n > 0:
            if self.tracer is not None:
                self.tracer.emit(REQUEUED, worker=worker, n=n, via="exit")
            if self.journal is not None:
                self.journal.append_requeue(n, "exit")
        return n

    def cancel(self, name: str) -> bool:
        sampled = self._sampled()
        t0 = time.perf_counter() if sampled else 0.0
        ok = self.hub.cancel(name)
        if sampled:
            self._emit_rpc("cancel", time.perf_counter() - t0)
        return ok

    def transfer(self, worker: str, name: str, new_deps=()):
        """Transfer routed to the task's home shard (with held-proxy
        mediation for cross-shard new deps — see ShardedHub.transfer)."""
        sampled = self._sampled()
        t0 = time.perf_counter() if sampled else 0.0
        resp = self.hub.transfer(worker, name, new_deps=list(new_deps))
        if sampled:
            self._emit_rpc("transfer", time.perf_counter() - t0)
        return resp

    def prune_terminal(self, keep=()) -> int:
        return self.hub.prune_terminal(keep=keep)

    def errors(self) -> set:
        return self.hub.user_errors()

    def ready_depth(self) -> int:
        return self.hub.ready_depth()

    def ready_depths(self) -> list:
        return [len(s.ready) for s in self.hub.shards]

    def stats(self) -> dict:
        return self.hub.stats()

    def close(self):
        pass


class TreeBackend(ServerBackend):
    """ServerBackend whose workers reach the hub through a
    message-forwarding tree (paper §4-§5).  It needs `Forwarder` and
    `ShardRouter` (the JAX package's `dwork/forwarder.py`), which the port
    has not taken over yet, so building one raises."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "TreeBackend needs the forwarding tree (dwork/forwarder.py), "
            "which the port has not taken over yet: ROADMAP.md Queue 1 "
            "item 4d")
