"""Sharded dwork hub, the port's copy of the JAX package's
`repro.core.dwork.sharded` — the paper's §6 expansion item 4: "shared
responsibility for handing out tasks, sharded between multiple servers",
using the observation that "delegating a task to another task database is
logically the same as assigning it to a worker".

`ShardedHub` fronts N independent TaskServers:
  * Create: tasks hash to a home shard; cross-shard dependencies are
    mediated by proxy tasks — the home shard of a dependency gets a
    `__notify__` successor that completes the dependent's local proxy on
    its shard (the delegation-as-assignment trick).
  * Steal: workers have an affinity shard (locality); on NotFound they
    steal from the busiest other shard (work stealing across shards).
  * METG effect: dispatch rate multiplies by the shard count
    (METGModel.dwork_metg(..., shards=N)).

Relay boundary (`handle()` + `sender`): the hub can be mounted BEHIND
the §4 forwarding tree.  `handle(msg)` accepts the Table-2 verbs exactly
as they arrive over a wire — no shard annotations — and routes them by
the home map (Complete/CompleteSteal), task hash (Create), or worker
affinity (Steal); all verbs it accepts round-trip through the msgpack
wire encoding, so prune/cancel/poison behavior survives serialization.
Every per-shard verb the hub issues goes through `_send`, which a
mounted hub redirects over a real per-shard link (`ShardLinks` installs
itself as `sender` — one timed `hop:L<k>:s<j>` rpc event per shard
round-trip).  Batched `CompleteSteal` verbs whose finished-batch and
steal-target shards differ are SPLIT per home shard, and the
steal-target shard's group is MERGED onto the steal frame so that shard
still sees one round-trip (Fig. 2 batch-then-drain, per shard).

Control plane: `_propagate_poison` and `prune_terminal` read shard state
in-process (worklists + meta under the shard locks) — they are hub
maintenance, not wire verbs, and stay correct whether or not the data
plane crosses a relay.
"""
from __future__ import annotations

import threading
from typing import Callable, Optional

from repro_torch.core.dwork.api import (Cancel, Complete, CompleteSteal,
                                        Create, Exit, ExitResp, NotFound,
                                        Release, Stats, Steal, TaskMsg,
                                        Transfer)
from repro_torch.core.dwork.server import TaskServer


class ShardedHub:
    def __init__(self, n_shards: int = 2, *,
                 lease_timeout: Optional[float] = None, clock=None):
        self.shards = [TaskServer(lease_timeout=lease_timeout, clock=clock)
                       for _ in range(n_shards)]
        for s in self.shards:
            s._new_errors = []     # arm the cross-shard poison worklist
        self.home: dict[str, int] = {}
        self.lock = threading.Lock()
        # data-plane indirection: None = in-process shard handle; a hub
        # behind the tree gets a ShardLinks sender so every per-shard
        # verb crosses the per-shard wire (and is hop-timed)
        self.sender: Optional[Callable] = None

    def _send(self, shard: int, msg):
        """Deliver one Table-2 verb to shard `shard` — in-process by
        default, over the installed per-shard link when mounted behind a
        relay (TreeBackend installs `sender`)."""
        if self.sender is None:
            return self.shards[shard].handle(msg)
        return self.sender(shard, msg)

    def _shard_of(self, task: str) -> int:
        with self.lock:
            if task not in self.home:
                self.home[task] = hash(task) % len(self.shards)
            return self.home[task]

    @staticmethod
    def _affinity(worker: str) -> Optional[int]:
        """Shard affinity from the engine's worker naming (w<i>)."""
        tail = worker.rsplit("w", 1)[-1]
        return int(tail) if tail.isdigit() else None

    def _steal_order(self, affinity: Optional[int]) -> list:
        """Affinity shard first (locality), else busiest-first (cross-
        shard work stealing) — the shared probe order for steals."""
        order = list(range(len(self.shards)))
        if affinity is not None:
            order.sort(key=lambda i: 0 if i == affinity % len(self.shards)
                       else 1)
        else:
            order.sort(key=lambda i: -len(self.shards[i].ready))
        return order

    # ---------------------------------------------------- relay boundary
    def handle(self, msg):
        """Wire-boundary entry point: the Table-2 verbs as they arrive
        over a relay (no shard annotations).  Routing: CompleteSteal and
        Complete by the authoritative home map, Create by task hash,
        Steal by worker affinity.  Responses are the plain protocol
        responses (TaskMsg / NotFound / ExitResp / stats dict), so a
        `ShardRouter` can encode them straight back downstream."""
        if isinstance(msg, CompleteSteal):
            resp, _ = self.complete_steal(msg.worker,
                                          self._route_done(msg.done),
                                          n=msg.n,
                                          affinity=self._affinity(msg.worker))
            return resp
        if isinstance(msg, Steal):
            resp, _ = self.steal(msg.worker, n=msg.n,
                                 affinity=self._affinity(msg.worker))
            return resp
        if isinstance(msg, Complete):
            shard = self.home.get(msg.task)
            if shard is None:
                return NotFound()             # unknown / pruned name
            return self.complete(msg.worker, msg.task, shard, ok=msg.ok)
        if isinstance(msg, Create):
            self.create(msg.task, deps=msg.deps, meta=msg.meta)
            return ExitResp()
        if isinstance(msg, Exit):
            self.exit_worker(msg.worker)
            return ExitResp()
        if isinstance(msg, Cancel):
            return ExitResp() if self.cancel(msg.task) else NotFound()
        if isinstance(msg, Transfer):
            return self.transfer(msg.worker, msg.task,
                                 new_deps=msg.new_deps)
        if isinstance(msg, Stats):
            return self.stats()
        raise TypeError(f"unroutable message {msg!r}")

    def _route_done(self, done) -> list:
        """[(task, ok)] -> [(task, ok, home shard)], dropping names the
        home map no longer knows (a late duplicate for a pruned task —
        never guess a shard)."""
        routed = []
        for name, ok in done:
            shard = self.home.get(name)
            if shard is not None:
                routed.append((name, ok, shard))
        return routed

    # ------------------------------------------------------------------
    def create(self, task: str, deps=(), meta=None):
        s = self._shard_of(task)
        local, remote = [], []
        for d in deps:
            (local if self._shard_of(d) == s else remote).append(d)
        # remote deps: a HELD proxy per remote dep lives on the HOME shard
        # ("delegation is logically the same as assigning to a worker" —
        # the remote shard holds the proxy's extra join count and Releases
        # it via its __notify__ successor when the dependency completes)
        proxy_deps = list(local)
        for d in remote:
            proxy = f"__proxy__{d}__for__{task}"
            self._send(s, Create(task=proxy, deps=[], meta={}, hold=True))
            proxy_deps.append(proxy)
            ds = self._shard_of(d)
            self._send(ds, Create(
                task=f"__notify__{proxy}", deps=[d],
                meta={"notify_shard": s, "proxy": proxy}))
        self._send(s, Create(task=task, deps=proxy_deps,
                             meta=dict(meta or {})))
        if remote:
            # a remote dep that ALREADY failed poisons its __notify__ at
            # create time; drain the worklist so the held proxy (and the
            # dependent) fail now instead of dangling
            self._propagate_poison()

    def steal(self, worker: str, n: int = 1, affinity: Optional[int] = None,
              merged=None):
        """Serve one steal, probing shards in `_steal_order`.  `merged`
        is an optional (shard, [(task, ok), ...]) finished batch that
        must ride the steal frame to that shard (the CompleteSteal
        merge): it is forced to the front of the probe order so the
        completions are applied even if another shard could serve the
        steal first."""
        order = self._steal_order(affinity)
        if merged is not None:
            order.sort(key=lambda i: 0 if i == merged[0] else 1)  # stable
        all_exit = True
        for i in order:
            if merged is not None and merged[0] == i:
                r = self._send(i, CompleteSteal(worker=f"{worker}@{i}",
                                                done=merged[1], n=n))
                merged = None
            else:
                r = self._send(i, Steal(worker=f"{worker}@{i}", n=n))
            if isinstance(r, TaskMsg):
                served = []
                for name, meta in r.tasks:
                    if name.startswith("__notify__"):
                        # bookkeeping: Release the held proxy on the
                        # dependent's home shard, retire the notify
                        self._send(meta["notify_shard"],
                                   Release(task=meta["proxy"]))
                        self._send(i, Complete(
                            worker=f"{worker}@{i}", task=name))
                    elif name.startswith("__proxy__"):
                        # structural: released proxies auto-complete, which
                        # unblocks their dependents' join counters
                        self._send(i, Complete(
                            worker=f"{worker}@{i}", task=name))
                    else:
                        served.append((name, meta))
                if served:
                    return TaskMsg(tasks=served), i
                return self.steal(worker, n, affinity)   # retry after notify
            if isinstance(r, NotFound):
                all_exit = False
        return (ExitResp() if all_exit else NotFound()), -1

    def complete(self, worker: str, task: str, shard: int, ok: bool = True):
        resp = self._send(shard, Complete(worker=f"{worker}@{shard}",
                                          task=task, ok=ok))
        if not ok:
            self._propagate_poison()   # cross-shard dependents must fail
        return resp

    def complete_steal(self, worker: str, done, n: int = 0,
                       affinity: Optional[int] = None):
        """The batched CompleteSteal verb generalized over shards: `done`
        is [(task, ok, shard), ...] — completions are grouped per home
        shard, and the group homed on the steal-target shard rides the
        steal frame itself (split per shard, merge with the steal), so
        the common single-shard batch stays ONE per-shard round-trip.
        Groups with failures are applied before the steal (their poison
        must propagate before more work is handed out).  Returns
        (response, shard) like `steal`."""
        by_shard: dict[int, list] = {}
        any_failed = False
        for name, ok, shard in done:
            by_shard.setdefault(shard, []).append((name, ok))
            any_failed = any_failed or not ok
        merged = None
        if n > 0 and not any_failed and by_shard:
            first = self._steal_order(affinity)[0]
            if first in by_shard:
                merged = (first, by_shard.pop(first))
        for shard, batch in by_shard.items():
            self._send(shard, CompleteSteal(worker=f"{worker}@{shard}",
                                            done=batch, n=0))
        if any_failed:
            self._propagate_poison()   # cross-shard dependents must fail
        if n <= 0:
            return ExitResp(), -1
        return self.steal(worker, n=n, affinity=affinity, merged=merged)

    def transfer(self, worker: str, task: str, new_deps=()):
        """Transfer generalized over shards: replace a leased task back
        into its HOME shard's queue with new dependencies.  Cross-shard
        new deps get the same held-proxy + `__notify__` mediation as
        `create` (a dependency must exist before the Transfer lands —
        `_transfer` forward-declares unknown local names as ready stubs,
        which would shadow the real task)."""
        with self.lock:
            s = self.home.get(task)
        if s is None:
            return NotFound()              # unknown / pruned name
        local, remote = [], []
        for d in new_deps:
            (local if self._shard_of(d) == s else remote).append(d)
        proxy_deps = list(local)
        for d in remote:
            proxy = f"__proxy__{d}__for__{task}"
            self._send(s, Create(task=proxy, deps=[], meta={}, hold=True))
            proxy_deps.append(proxy)
            ds = self._shard_of(d)
            self._send(ds, Create(
                task=f"__notify__{proxy}", deps=[d],
                meta={"notify_shard": s, "proxy": proxy}))
        resp = self._send(s, Transfer(worker=f"{worker}@{s}", task=task,
                                      new_deps=proxy_deps))
        if remote:
            self._propagate_poison()
        return resp

    def exit_worker(self, worker: str):
        """Node failure: recycle the worker's assignment on every shard
        (workers steal under per-shard aliases `worker@shard`)."""
        for i in range(len(self.shards)):
            self._send(i, Exit(worker=f"{worker}@{i}"))

    def cancel(self, task: str) -> bool:
        """Cancel on the task's home shard (unleased + non-terminal only),
        then propagate the poison across shards: a cross-shard dependent
        must observe the cancel as a failed dependency, not wait forever
        on a Release its poisoned __notify__ helper can no longer send."""
        with self.lock:
            s = self.home.get(task)
        if s is None:
            return False
        if not isinstance(self._send(s, Cancel(task=task)), ExitResp):
            return False
        self._propagate_poison()
        return True

    def _propagate_poison(self):
        """Cross-shard failure propagation: poisoning a task also poisons
        its `__notify__` helpers, which then can never Release the
        dependent's HELD proxy on its home shard — so the dependent would
        dangle forever, neither run nor fail.  Poison the proxy instead
        (the dependent must never run once its dependency failed).
        Incremental: only names poisoned since the last call are
        examined (each shard's `_new_errors` worklist), looping until
        the cascade across shards quiesces.  Control plane: reads shard
        state in-process under the shard locks (not a wire verb)."""
        while True:
            metas = []
            for shard in self.shards:
                with shard.lock:
                    if not shard._new_errors:
                        continue
                    for t in shard._new_errors:
                        if t.startswith("__notify__"):
                            metas.append(dict(shard.meta.get(t) or {}))
                    shard._new_errors.clear()
            if not metas:
                return
            for meta in metas:
                ns, proxy = meta.get("notify_shard"), meta.get("proxy")
                if ns is None or proxy is None:
                    continue
                target = self.shards[ns]
                with target.lock:
                    if (proxy in target.errors
                            or proxy in target.completed):
                        continue
                    target._poison(proxy)

    def prune_terminal(self, keep=()) -> int:
        """Per-shard terminal-entry pruning plus home-map cleanup (same
        single-use-names contract as `TaskServer.prune_terminal`) —
        O(pruned), not O(live+history): only the pruned names are
        deleted from the home map."""
        pruned = 0
        for s in self.shards:
            names = s.prune_terminal(keep=keep)
            pruned += len(names)
            if names:
                with self.lock:
                    for t in names:
                        self.home.pop(t, None)
        return pruned

    # one definition of the cross-shard aggregates, shared by every
    # backend fronting this hub (in-process or behind the tree)
    def user_errors(self) -> set:
        """Failed USER tasks across shards — the `__proxy__`/`__notify__`
        bookkeeping names are the hub's own, never surfaced."""
        return {t for s in self.shards for t in s.errors
                if not t.startswith("__")}

    def ready_depth(self) -> int:
        return sum(len(s.ready) for s in self.shards)

    def requeued_total(self) -> int:
        return sum(s.counters["requeued"] for s in self.shards)

    def stats(self) -> dict:
        per = [s.stats() for s in self.shards]
        return {"shards": per,
                "completed": sum(p["completed"] for p in per),
                "user_completed": sum(
                    p["completed"] for p in per) - sum(
                        1 for t in self.home if t.startswith("__")),
                }

    def run_to_completion(self, execute, workers: int = 2,
                          max_rounds: int = 100000) -> int:
        """Simple driver: round-robin workers until global Exit."""
        done = 0
        rounds = 0
        while rounds < max_rounds:
            rounds += 1
            progress = False
            exits = 0
            for w in range(workers):
                r, shard = self.steal(f"w{w}", affinity=w)
                if isinstance(r, TaskMsg):
                    progress = True
                    for name, meta in r.tasks:
                        ok = execute(name, meta)
                        self.complete(f"w{w}", name, shard, ok=ok)
                        done += 1
                elif isinstance(r, ExitResp):
                    exits += 1
            if exits == workers:
                return done
            if not progress:
                continue
        return done
