"""`transport="proc"`: real worker processes over the Table-2 frame
protocol — the GIL-escaping transport; the port's copy of the JAX
package's `repro.core.engine.comm.proc`.  Its workers run the port's
worker module, never the JAX package's.

Topology: the engine keeps its normal in-process scheduler state (a
`ServerBackend` or `ShardedBackend` — shards compose), and `ProcBackend`
puts a TCP **front door** in front of it.  Spawned worker processes (or
remote hosts running `python -m repro_torch.core.engine.comm.worker
--connect host:port`) dial the front door and run the paper's Fig. 2
client loop against it: Hello handshake (worker id, steal_n, heartbeat
cadence, optional cloudpickled execute callback), then
CompleteSteal-driven batch-then-drain, with a daemon heartbeat thread
for liveness.

The front door is the translation layer between the process protocol
and the plain Table-2 verbs:

  * CompleteSteal `done` entries arrive EXTENDED — `[name, ok, {"v":
    value-payload, "e": error, "d": duration, "n": nbytes, "x": xfer
    stats, "as": store-as alias}]` — and are stripped to `(name, ok)`
    before reaching the TaskServer (which stays unchanged); the
    payloads/durations/xfer stats are queued as completion records for
    the engine's supervision loop (`Engine._run_proc`) to drain.
  * The data plane lives here too: a result above `inline_bytes` stays
    in its producing worker's local store — the entry carries "n"
    (byte count) instead of "v", and the door records the LOCATION
    (worker + its Hello-advertised data listener).  Fetch answers from
    the value store first, else redirects with a LocMsg; Spill accepts
    a worker's evicted/exit-flushed payload back into the value store.
    A `__xfer_lost__:`-prefixed failure (a dependency value neither its
    producer nor the hub could serve — the producer was SIGKILLed
    before replicating) is WITHHELD from the scheduler (the task stays
    leased) and queued on `lost` for the engine to recompute.
  * Hello / Heartbeat / Fetch / Spill are answered here (join
    registration, liveness touch, dependency-value serving) and never
    forwarded.
  * In resident mode a server-side "all done" (ExitResp) is converted
    to NotFound while the engine is not stopping, so workers idle-poll
    instead of exiting between submission waves.

Liveness is two-layered: locally-spawned processes are watched with
`Popen.poll()` (a SIGKILL surfaces within one supervision round), and
every worker — local or remote — is covered by heartbeat staleness.
Either way the engine announces `Exit` for the dead worker, which
recycles its in-flight assignment with zero loss (duplicate completions
after a requeue are deduplicated engine-side, exactly once per name).
"""
from __future__ import annotations

import atexit
import os
import subprocess
import sys
import threading
import time
from collections import deque
from typing import Callable, Optional

from repro_torch.core.dwork.api import (XFER_LOST_PREFIX, CompleteSteal,
                                        ExitResp, Fetch, Heartbeat, Hello,
                                        HelloResp, LocMsg, NotFound, Spill,
                                        TaskMsg, ValueMsg)
from repro_torch.core.engine.comm import core as comm_core
from repro_torch.core.engine.comm.serialize import dumps
from repro_torch.core.engine.model import RPC, STOLEN


class _FrontDoor:
    """The frame handler the TCP listener serves (per-connection
    threads).  Holds the worker directory (pids, heartbeats, joins,
    exits), the completed-value store for Fetch, and the completion
    record queue the engine supervision loop drains."""

    def __init__(self, backend: "ProcBackend"):
        self.backend = backend
        self.lock = threading.Lock()
        # (worker, task, ok, error, duration_s, value_payload, nbytes,
        #  xfers) records
        self.records: deque = deque()
        self.values: dict = {}           # task -> serialized value payload
        self.locations: dict = {}        # task -> (worker, data_addr, nbytes)
        self.data_addrs: dict = {}       # worker -> its data listener addr
        self.early_spills: dict = {}     # Spill that beat its CompleteSteal
        self.lost: deque = deque()       # (worker, task, missing-dep) queue
        self.failed_held: deque = deque()  # (worker, task, err) for retry
        self.pids: dict = {}             # worker -> os pid (0 if unknown)
        self.last_seen: dict = {}        # worker -> monotonic heartbeat
        self.joined: deque = deque()     # workers whose Hello arrived
        self.exited: set = set()         # workers told to exit (clean)
        self.stolen_at: dict = {}        # task -> STOLEN timestamp
        self.requeued = 0                # lease requeues seen at the wire
        self.stopping = False            # resident drain: let DONE through
        self._next_rid = 0               # auto ids for anonymous joins

    def handle(self, msg):
        if isinstance(msg, CompleteSteal):
            return self._complete_steal(msg)
        if isinstance(msg, Heartbeat):
            self.last_seen[msg.worker] = time.monotonic()
            return ExitResp()
        if isinstance(msg, Hello):
            return self._hello(msg)
        if isinstance(msg, Fetch):
            payload = self.values.get(msg.task)
            if payload is not None:
                return ValueMsg(task=msg.task, payload=payload)
            loc = self.locations.get(msg.task)
            if loc is not None:
                w, addr, nbytes = loc
                return LocMsg(task=msg.task, addr=addr, worker=w,
                              nbytes=nbytes)
            return NotFound()
        if isinstance(msg, Spill):
            with self.lock:
                if msg.task in self.locations or msg.task in self.values:
                    self.values.setdefault(msg.task, msg.payload)
                else:
                    # the eviction raced its own CompleteSteal: park the
                    # payload until the location registration consumes it
                    self.early_spills[msg.task] = msg.payload
            return ExitResp()
        # plain Table-2 traffic (multi-host Create, Stats, ...) passes
        # straight through to the scheduler state
        return self.backend.wire_handle(msg)

    def _hello(self, msg: Hello):
        b = self.backend
        w = msg.worker
        if not w:
            with self.lock:
                w = f"r{self._next_rid}"
                self._next_rid += 1
        now = time.monotonic()
        with self.lock:
            self.pids[w] = int(msg.pid or 0)
            self.last_seen[w] = now
            self.exited.discard(w)       # a rejoin under an old id
            self.joined.append(w)
            self.data_addrs[w] = msg.data_addr or ""
        return HelloResp(worker=w, steal_n=b.steal_n, resident=b.resident,
                         pass_worker=b.pass_worker,
                         heartbeat_s=b.heartbeat_s,
                         execute=b.execute_payload,
                         inline_bytes=b.inline_bytes,
                         spill_bytes=b.spill_bytes)

    def _complete_steal(self, msg: CompleteSteal):
        b = self.backend
        w = msg.worker
        self.last_seen[w] = time.monotonic()
        recs = []
        done = []
        lost = []
        held = []
        retry_check = b.retry_check
        for item in msg.done:
            name, ok = item[0], bool(item[1])
            info = item[2] if len(item) > 2 else {}
            err = info.get("e")
            if not ok and err and err.startswith(XFER_LOST_PREFIX):
                # a dependency value is unrecoverable worker-side: withhold
                # the entry (the task stays leased to `w`) and queue it for
                # the engine's recompute-then-Transfer path
                lost.append((w, name, err[len(XFER_LOST_PREFIX):]))
                continue
            if not ok and retry_check is not None \
                    and retry_check(name, err):
                # transient failure the engine's RetryPolicy will absorb:
                # withhold the completion the same way (the task stays
                # leased to `w`) — the engine Transfer-requeues it after
                # the policy's backoff instead of failing it for real
                held.append((w, name, err))
                continue
            done.append((name, ok))
            payload = info.get("v")
            nbytes = int(info.get("n") or 0)
            recs.append((w, name, ok, err, float(info.get("d") or 0.0),
                         payload, nbytes, info.get("x") or None))
            if ok:
                # register the value (or its location) BEFORE the scheduler
                # learns of the completion: a dependent stolen by another
                # worker must never miss a Fetch
                targets = [name]
                alias = info.get("as")
                if alias:
                    targets.append(alias)
                with self.lock:
                    for t in targets:
                        if payload is not None:
                            self.values.setdefault(t, payload)
                        elif nbytes:
                            early = self.early_spills.pop(t, None)
                            if early is not None:
                                self.values.setdefault(t, early)
                            self.locations[t] = (
                                w, self.data_addrs.get(w, ""), nbytes)
        if lost or held:
            with self.lock:
                self.lost.extend(lost)
                self.failed_held.extend(held)
        tracer = b.tracer
        sampled = tracer is not None and msg.n > 0 and tracer.sample_rpc()
        t0 = time.perf_counter() if sampled else 0.0
        # _rq_lock serializes requeue-counter delta reads across handler
        # threads AND the engine's own exit_worker calls, so a lease
        # requeue is attributed exactly once (and never double-counted
        # against an exit requeue the inner backend already recorded)
        with b._rq_lock:
            # a worker the engine already declared gone (crash/lose) gets
            # its completions applied — they really happened — but is
            # NEVER served new work: this handler thread may be the dead
            # worker's last in-flight request arriving after exit_worker
            # requeued its leases (checked under the same lock, so the
            # order is decided, not raced)
            gone = w in self.exited
            before = b.requeued_delta()
            resp = b.wire_handle(CompleteSteal(worker=w, done=done,
                                               n=0 if gone else msg.n))
            rq = b.requeued_delta() - before
        if sampled:
            dt = time.perf_counter() - t0
            tracer.emit(RPC, op="proc:complete_steal", dt=dt)
            m = b.metrics
            if m is not None:
                m.observe("proc:complete_steal", dt)
        if recs or rq:
            with self.lock:
                if recs:
                    self.records.extend(recs)
                self.requeued += rq
        if gone:
            return ExitResp()      # no polling conversion: die, worker
        if isinstance(resp, TaskMsg):
            if tracer is not None:
                stolen_at = self.stolen_at
                for name, _meta in resp.tasks:
                    ev = tracer.emit(STOLEN, task=name, worker=w)
                    stolen_at[name] = ev.t
            return resp
        if isinstance(resp, ExitResp) and msg.n > 0:
            if b.resident and not self.stopping:
                # "all done" while resident just means idle: more work
                # may be submitted, keep the worker polling
                return NotFound()
            self.exited.add(w)
        return resp


class ProcBackend:
    """Process-worker backend: delegates the scheduler protocol to an
    inner `ServerBackend` / `ShardedBackend` and serves the same state
    to worker processes through the front door's TCP listener.

    The engine drives the extra process-pool surface: `prepare()` (ships
    the execute callback — failing fast on an unpicklable one),
    `start_pool`/`spawn`/`kill_worker`/`stop_pool` (local process
    lifecycle, atexit-reaped so no orphans survive the interpreter), and
    the supervision taps `drain_records` / `drain_joined` /
    `drain_requeued` / `check_dead` / `all_done`."""

    def __init__(self, inner, *, host: str = "127.0.0.1", port: int = 0,
                 steal_n: int = 1, resident: bool = False,
                 heartbeat_s: float = 0.5, owns_inner: bool = True,
                 inline_bytes: int = 65536,
                 spill_bytes: int = 64 * 1024 * 1024):
        srv = getattr(inner, "server", None)
        hub = getattr(inner, "hub", None)
        if srv is None and hub is None:
            raise TypeError(
                "transport='proc' wraps a ServerBackend or ShardedBackend; "
                f"got {type(inner).__name__} (tree+proc do not compose — "
                "proc replaces the tree's connection-scaling role)")
        self.inner = inner
        self.owns_inner = owns_inner
        self._wire = srv.handle if srv is not None else hub.handle
        self.steal_n = max(int(steal_n), 1)
        self.resident = bool(resident)
        self.heartbeat_s = max(float(heartbeat_s), 0.05)
        self.inline_bytes = max(int(inline_bytes), 0)
        self.spill_bytes = max(int(spill_bytes), 0)
        self.pass_worker = False
        self.execute_payload: Optional[str] = None
        # engine-installed predicate `(task, err) -> bool`: True means the
        # engine's RetryPolicy will absorb this failure, so the door
        # withholds the completion (see drain_failed); None = no retry
        self.retry_check: Optional[Callable] = None
        self._rq_lock = threading.Lock()
        self.door = _FrontDoor(self)
        self.listener = comm_core.listen(f"tcp://{host}:{port}", self.door)
        self.procs: dict = {}            # worker -> subprocess.Popen
        self._closed = False
        atexit.register(self._kill_all)  # orphan reaping on interpreter exit

    # ------------------------------------------------------------ wire
    def wire_handle(self, msg):
        return self._wire(msg)

    def requeued_delta(self) -> int:
        return self.inner._requeued_total()

    @property
    def address(self) -> str:
        """What `--connect` dials: `tcp://host:port` of the front door."""
        return self.listener.address

    # ----------------------------------------------------- process pool
    def prepare(self, *, execute=None, pass_worker: bool = False,
                steal_n: Optional[int] = None,
                resident: Optional[bool] = None):
        """Stamp the run configuration the Hello handshake hands out.
        Serializing `execute` here fails fast (SerializationError) —
        before any process is spawned."""
        if steal_n is not None:
            self.steal_n = max(int(steal_n), 1)
        if resident is not None:
            self.resident = bool(resident)
        self.pass_worker = bool(pass_worker) and execute is not None
        self.execute_payload = (dumps(execute,
                                      what="the execute callback")
                                if execute is not None else None)

    def spawn(self, worker: str) -> subprocess.Popen:
        import repro_torch

        env = dict(os.environ)
        src = str(os.path.dirname(os.path.dirname(
            os.path.abspath(repro_torch.__file__))))
        pp = env.get("PYTHONPATH")
        env["PYTHONPATH"] = src + (os.pathsep + pp if pp else "")
        host, port = self.listener.host_port
        cmd = [sys.executable, "-m", "repro_torch.core.engine.comm.worker",
               "--connect", f"{host}:{port}", "--name", worker]
        quiet = not os.environ.get("REPRO_PROC_DEBUG")
        proc = subprocess.Popen(
            cmd, env=env,
            stdout=subprocess.DEVNULL if quiet else None,
            stderr=subprocess.DEVNULL if quiet else None,
            start_new_session=True)
        self.procs[worker] = proc
        return proc

    def start_pool(self, workers):
        for w in workers:
            self.spawn(w)

    def kill_worker(self, worker: str):
        """Engine-announced removal (lose_worker): terminate the local
        process; mark it exited so liveness doesn't re-report it."""
        self.door.exited.add(worker)
        p = self.procs.pop(worker, None)
        if p is not None and p.poll() is None:
            p.terminate()

    def stop_pool(self, grace: float = 3.0):
        """Drain-stop every local worker: let the protocol's ExitResp
        reach them (stopping=True), then escalate terminate -> kill."""
        self.door.stopping = True
        deadline = time.monotonic() + grace
        for w, p in list(self.procs.items()):
            if p.poll() is not None:
                continue
            try:
                p.wait(timeout=max(deadline - time.monotonic(), 0.05))
            except subprocess.TimeoutExpired:
                p.terminate()
                try:
                    p.wait(timeout=1.0)
                except subprocess.TimeoutExpired:
                    p.kill()
                    try:
                        p.wait(timeout=1.0)
                    except subprocess.TimeoutExpired:
                        pass
        self.procs.clear()

    def _kill_all(self):
        # atexit safety net: a session that never reached stop_pool()
        # (crash, test abort) must not leave worker processes behind
        for p in list(self.procs.values()):
            if p.poll() is None:
                try:
                    p.kill()
                except OSError:
                    pass

    # -------------------------------------------------- supervision taps
    def connected(self) -> set:
        return set(self.door.pids)

    def worker_pids(self) -> dict:
        """worker -> OS pid, for every process that completed Hello."""
        return dict(self.door.pids)

    def has_records(self) -> bool:
        return bool(self.door.records)

    def drain_records(self) -> list:
        d = self.door
        if not d.records:
            return []
        with d.lock:
            out = list(d.records)
            d.records.clear()
        return out

    def drain_joined(self) -> list:
        d = self.door
        if not d.joined:
            return []
        with d.lock:
            out = list(d.joined)
            d.joined.clear()
        return out

    def drain_requeued(self) -> int:
        d = self.door
        if not d.requeued:
            return 0
        with d.lock:
            n = d.requeued
            d.requeued = 0
        return n

    def drain_lost(self) -> list:
        """-> [(worker, task, missing-dep), ...]: withheld completions
        whose dependency value is unrecoverable (the engine recomputes
        the missing value, then Transfer-requeues the dependent)."""
        d = self.door
        if not d.lost:
            return []
        with d.lock:
            out = list(d.lost)
            d.lost.clear()
        return out

    def drain_failed(self) -> list:
        """-> [(worker, task, err), ...]: failed completions the door
        withheld because `retry_check` approved them (the task is still
        leased to the worker) — the engine applies the policy's backoff
        and Transfer-requeues, or fails them for real."""
        d = self.door
        if not d.failed_held:
            return []
        with d.lock:
            out = list(d.failed_held)
            d.failed_held.clear()
        return out

    def check_dead(self, grace: float) -> list:
        """-> [(worker, reason)]: locally-spawned processes that exited
        without a clean protocol goodbye ("crash"), plus any worker —
        local or remote — whose heartbeat went stale past `grace`
        ("stale").  Each worker is reported at most once."""
        out = []
        door = self.door
        exited = door.exited
        for w, p in list(self.procs.items()):
            if p.poll() is None:
                continue
            del self.procs[w]
            if w in exited:
                continue                  # announced Exit, then exited
            door.last_seen.pop(w, None)
            out.append((w, "crash"))
        if grace > 0:
            now = time.monotonic()
            for w, seen in list(door.last_seen.items()):
                if w in exited or now - seen <= grace:
                    continue
                del door.last_seen[w]
                p = self.procs.pop(w, None)
                if p is not None and p.poll() is None:
                    p.kill()              # fence: wedged, not just slow
                out.append((w, "stale"))
        return out

    def all_done(self) -> bool:
        srv = getattr(self.inner, "server", None)
        if srv is not None:
            with srv.lock:
                return srv._all_done()
        for s in self.inner.hub.shards:
            with s.lock:
                if not s._all_done():
                    return False
        return True

    # ------------------------------------------- backend protocol (inner)
    def create(self, name, deps=(), meta=None):
        return self.inner.create(name, deps=deps, meta=meta)

    def create_many(self, tasks):
        return self.inner.create_many(tasks)

    def steal(self, worker, n=1):
        return self.inner.steal(worker, n)

    def complete(self, worker, name, ok=True):
        return self.inner.complete(worker, name, ok=ok)

    def complete_steal(self, worker, done, n=0):
        return self.inner.complete_steal(worker, done, n)

    def exit_worker(self, worker):
        # exited-marking and lease-requeue are one atomic step under
        # _rq_lock: a front-door handler thread carrying the worker's
        # LAST CompleteSteal serializes against this, so it either steals
        # before (and this requeue reclaims the lease) or observes the
        # worker as gone and is refused — a dead worker can never walk
        # away holding fresh leases (the zombie-steal race)
        with self._rq_lock:
            self.door.exited.add(worker)
            return self.inner.exit_worker(worker)

    def cancel(self, name):
        return self.inner.cancel(name)

    def transfer(self, worker, name, new_deps=()):
        return self.inner.transfer(worker, name, new_deps=new_deps)

    def prune_terminal(self, keep=()):
        n = self.inner.prune_terminal(keep=keep)
        door = self.door
        # mirror the prune into EVERY data-plane store — values,
        # locations, parked early spills — so a pruned session cannot
        # leak payload bytes (sharded inner reports counts, not names,
        # so prune conservatively by the same keep-set contract:
        # single-use names)
        keep = set(keep)
        with door.lock:
            for table in (door.values, door.locations, door.early_spills):
                if not table:
                    continue
                for name in [k for k in table if k not in keep]:
                    del table[name]
        return n

    def errors(self):
        return self.inner.errors()

    def ready_depth(self):
        return self.inner.ready_depth()

    def ready_depths(self):
        return self.inner.ready_depths()

    def stats(self):
        s = self.inner.stats()
        s["proc"] = {"listen": self.address, "workers": self.worker_pids()}
        return s

    def close(self):
        if self._closed:
            return
        self._closed = True
        self.stop_pool()
        self.listener.stop()
        try:
            atexit.unregister(self._kill_all)
        except Exception:  # noqa: BLE001 — interpreter tearing down
            pass
        if self.owns_inner:
            self.inner.close()

    # --------------------------------------- forwarded engine attributes
    @property
    def n_shards(self) -> int:
        return getattr(self.inner, "n_shards", 1)

    def _requeued_total(self) -> int:
        return self.inner._requeued_total()

    @property
    def tracer(self):
        return self.inner.tracer

    @tracer.setter
    def tracer(self, tracer):
        self.inner.tracer = tracer

    @property
    def metrics(self):
        return self.inner.metrics

    @metrics.setter
    def metrics(self, m):
        self.inner.metrics = m

    @property
    def journal(self):
        return self.inner.journal

    @journal.setter
    def journal(self, j):
        self.inner.journal = j
