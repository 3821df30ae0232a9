"""Scheduler backends: the engine's view of a task database, the port's
copy of the JAX package's `repro.core.engine.backends`.

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

import math
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
        # optional rpc-latency sink (repro_torch.core.obs.RpcMetrics): fed
        # the same sampled timings the trace gets, so rpc_sample= thins both
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
    message-forwarding tree (paper §4-§5): the hub is hosted behind TCP
    frame servers, `levels` layers of `Forwarder`s relay frames with a
    shared pipelined upstream link per node, and each worker holds one
    connection to its leaf forwarder (`fanout` workers per leaf).

    With `shards > 1` (or a caller-supplied `hub=`) the two scaling
    levers COMPOSE (paper §6 item 4 behind §4): the top-level layer is
    built from `ShardRouter`s instead of blind relays — each decodes the
    frames the tree delivers and routes the Table-2 verbs by task hash
    to per-shard TaskServers, each behind its own TCP frame server,
    through the shared `ShardedHub` routing state (affinity steals,
    cross-shard `__notify__` mediation, CompleteSteal split/merge).
    Worker-less verbs (Create/Cancel) ride the boss link into a router,
    so cross-shard dependency and poison traffic enters through the
    same apex the workers use.

    Every worker-side call is timed end-to-end as an `rpc` event; each
    forwarder hop additionally emits `op="hop:L<level>"` events, and
    each per-shard round-trip behind a router emits
    `op="hop:L1:s<shard>"`, so `OverheadReport.rpc_by_op` attributes
    where tree latency accrues — per level, and per shard at the apex.
    """

    def __init__(self, server: Optional[TaskServer] = None, *,
                 workers: int = 1, fanout: int = 4, levels: int = 1,
                 shards: int = 1, hub: Optional[ShardedHub] = None,
                 lease_timeout: Optional[float] = None, clock=None,
                 tracer=None):
        # lazy import: client.py is also imported by forwarder.py
        from repro_torch.core.dwork.client import (TCPServer,
                                                   TCPTransport)

        self.forwarders: list = []    # exists before the tracer setter runs
        self.metrics = None           # see ServerBackend.metrics
        self.journal = None           # see ServerBackend.journal
        self._shard_links = None
        self._shard_tcp: list = []
        n_shards = len(hub.shards) if hub is not None else max(int(shards), 1)
        if hub is not None or n_shards > 1:
            if server is not None:
                raise ValueError("pass server= for a single hub OR "
                                 "hub=/shards>1 for a sharded one, not both")
            self.hub = hub or ShardedHub(n_shards,
                                         lease_timeout=lease_timeout,
                                         clock=clock)
            self.server = None
            self.tracer = tracer
        else:
            self.hub = None
            super().__init__(server=server, lease_timeout=lease_timeout,
                             clock=clock, tracer=tracer)
        self.n_shards = n_shards
        self.fanout = max(int(fanout), 1)
        self.levels = max(int(levels), 1)
        self._TCPTransport = TCPTransport
        if self.hub is not None:
            from repro_torch.core.dwork.forwarder import ShardLinks

            # one TCP frame server per shard: the per-shard verbs cross a
            # real wire, so the hop:L1:s<j> fan-out timings are honest
            self._shard_tcp = [TCPServer(("127.0.0.1", 0), s)
                               for s in self.hub.shards]
            for t in self._shard_tcp:
                t.serve_background()
            self._shard_links = ShardLinks(
                [t.server_address for t in self._shard_tcp],
                tracer=self.tracer)
            self.hub.sender = self._shard_links
            self.tcp = None
        else:
            self.tcp = TCPServer(("127.0.0.1", 0), self.server)
            self.tcp.serve_background()
        self.forwarders = self._build_tree(max(int(workers), 1))
        self.leaves = self.forwarders[-1]
        self._conn: dict[str, object] = {}    # worker -> TCPTransport
        self._boss = None                     # create/stats link to the hub
        self._next_leaf = 0

    def _build_tree(self, workers: int):
        """Build `levels` forwarder layers bottom-up in size, top-down in
        wiring: layer 1 feeds the hub, the leaf layer serves workers.
        Sharded hub: the layer-1 nodes are `ShardRouter`s (hash routing
        at the apex) sharing one hub + one set of per-shard links."""
        from repro_torch.core.dwork.forwarder import Forwarder, ShardRouter

        n_leaves = max(1, math.ceil(workers / self.fanout))
        sizes = [n_leaves]
        for _ in range(self.levels - 1):
            sizes.append(max(1, math.ceil(sizes[-1] / self.fanout)))
        sizes.reverse()                       # top (hub-facing) first
        layers = []
        upstreams = [self.tcp.server_address] if self.tcp is not None else []
        for level, size in enumerate(sizes, start=1):
            layer = []
            for i in range(size):
                if level == 1 and self.hub is not None:
                    node = ShardRouter(("127.0.0.1", 0), self.hub,
                                       tracer=self.tracer, label=f"L{level}")
                else:
                    up = upstreams[i % len(upstreams)]
                    node = Forwarder(("127.0.0.1", 0), up,
                                     tracer=self.tracer, label=f"L{level}")
                node.serve_background()
                layer.append(node)
            upstreams = [f.server_address for f in layer]
            layers.append(layer)
        return layers

    @property
    def tracer(self):
        return self._tracer

    @tracer.setter
    def tracer(self, tracer):
        # the Forwarders (and the sharded hub's per-shard links) capture
        # the tracer at construction; a backend built without one (and
        # patched later by Engine.__init__) must propagate it or every
        # hop:L<k>[:s<j>] event is silently lost
        self._tracer = tracer
        for layer in self.forwarders:
            for fwd in layer:
                fwd.tracer = tracer
        links = getattr(self, "_shard_links", None)
        if links is not None:
            links.tracer = tracer

    def _requeued_total(self) -> int:
        if self.hub is not None:
            return self.hub.requeued_total()
        return self.server.counters["requeued"]

    # --------------------------------------------------------- transports
    def _transport(self, worker: str):
        tr = self._conn.get(worker)
        if tr is None:
            leaf = self.leaves[self._next_leaf % len(self.leaves)]
            self._next_leaf += 1
            tr = self._TCPTransport(*leaf.server_address)
            self._conn[worker] = tr
        return tr

    def _request(self, msg):
        """Route the shared protocol verbs over real sockets: worker
        messages go through the calling worker's forwarder connection,
        worker-less ones (Create/Cancel) over the boss link — to the hub
        direct, or into a top-level router when the hub is sharded (the
        cross-shard `__notify__` fan-out rides the boss link's frames)."""
        worker = getattr(msg, "worker", None)
        if worker is None:
            if self._boss is None:
                addr = (self.forwarders[0][0].server_address
                        if self.hub is not None else self.tcp.server_address)
                self._boss = self._TCPTransport(*addr)
            return self._boss.request(msg)
        return self._transport(worker).request(msg)

    def create_many(self, tasks: list):
        """Tree path: each Create crosses the boss link individually (the
        wire has no batched Create verb) — one timed rpc event covers the
        batch."""
        tracer = self.tracer
        sampled = tracer is not None and tracer.sample_rpc()
        t0 = time.perf_counter() if sampled else 0.0
        for name, deps, meta in tasks:
            self._request(Create(task=name, deps=list(deps),
                                 meta=dict(meta or {})))
        if sampled:
            dt = time.perf_counter() - t0
            tracer.emit(RPC, op="create_many", dt=dt, n=len(tasks))
            m = self.metrics
            if m is not None:
                m.observe("create_many", dt)

    # ------------------------------------------------------ introspection
    def prune_terminal(self, keep=()) -> int:
        if self.hub is not None:
            return self.hub.prune_terminal(keep=keep)
        return super().prune_terminal(keep=keep)

    def errors(self) -> set:
        if self.hub is not None:
            return self.hub.user_errors()
        return super().errors()

    def ready_depth(self) -> int:
        if self.hub is not None:
            return self.hub.ready_depth()
        return super().ready_depth()

    def ready_depths(self) -> list:
        if self.hub is not None:
            return [len(s.ready) for s in self.hub.shards]
        return super().ready_depths()

    def stats(self) -> dict:
        stats = self.hub.stats() if self.hub is not None \
            else self.server.stats()
        stats["tree"] = {
            "levels": self.levels, "fanout": self.fanout,
            "shards": self.n_shards,
            "forwarders": [len(layer) for layer in self.forwarders],
            "relayed": [sum(f.relayed for f in layer)
                        for layer in self.forwarders],
        }
        return stats

    def close(self):
        for tr in self._conn.values():
            tr.close()
        self._conn.clear()
        if self._boss is not None:
            self._boss.close()
            self._boss = None
        for layer in reversed(self.forwarders):
            for fwd in layer:
                fwd.close()
        if self._shard_links is not None:
            # hand the hub back to in-process dispatch: a caller-supplied
            # hub must stay usable after the tree is torn down (its verbs
            # would otherwise hit the dead links forever)
            if self.hub.sender is self._shard_links:
                self.hub.sender = None
            self._shard_links.close()
        for t in self._shard_tcp:
            t.shutdown()
            t.server_close()
        if self.tcp is not None:
            self.tcp.shutdown()
            self.tcp.server_close()
