"""Worker process entry point: the paper's Fig. 2 client loop over TCP; the
port's copy of the JAX package's `repro.core.engine.comm.worker`.

    python -m repro_torch.core.engine.comm.worker --connect HOST:PORT \
        [--name W]

Spawned locally by `Engine(transport="proc")`, or run by hand on any
host that can reach the engine's front door (`engine.comm_address`) —
a remote worker joins the pool on connect (`add_worker` semantics: the
Hello handshake registers it, and the engine's supervision loop folds
it into the live set).

Loop shape (identical to `dwork.client.Client.run_loop`, plus the
process-boundary pieces): Hello handshake -> deserialize the shipped
execute callback (if any) -> CompleteSteal(finished, n=steal_n) ->
run each task -> repeat.  Per task: a `meta["__call__"]` payload wins
(a cloudpickled `(fn, args, kwargs)` — `Ref` arguments resolve through
the data plane below), else the shipped execute callback runs
`(name, meta[, worker])`.  Results serialize into the extended
CompleteSteal entry `[name, ok, {...}]`; a result that cannot pickle
reports ok=False with the SerializationError, never a hang.

The peer-to-peer data plane (`_DataPlane`): each worker owns a local
result store served by its own TCP data listener (advertised in Hello
as `data_addr`).  A result above the hub's `inline_bytes` threshold
stays HERE — the CompleteSteal entry carries only its byte count, and
the hub records the location.  A dependent's `Ref` then resolves
cache-first, then a hub Fetch; a `LocMsg` redirect dials the producing
worker's data listener directly (the hub is off the data path), falling
back to the hub when the producer is gone or evicted the value.  The
store is LRU-bounded by `spill_bytes`: evicted owned values are pushed
to the hub with `Spill` (so they outlive this worker), and a clean exit
flushes every still-unspilled owned value the same way.  A value
neither the producer nor the hub can serve is reported with the
`__xfer_lost__:` error prefix — the front door withholds that entry
and the engine recomputes the missing value (zero loss across SIGKILL).

A daemon thread heartbeats every `heartbeat_s` (the transport lock
makes it safe alongside the main loop).  Losing the connection — the
engine died or told us goodbye — exits the process: orphaned workers
reap themselves.  `WorkerCrash` raised by a task body hard-exits
(`os._exit`) to exercise real crash semantics end to end.
"""
from __future__ import annotations

import argparse
import os
import socket
import sys
import threading
import time
from collections import OrderedDict

from repro_torch.core.dwork.api import (XFER_LOST_PREFIX, CompleteSteal,
                                        ExitResp, Fetch, Heartbeat, Hello,
                                        LocMsg, NotFound, Spill, TaskMsg,
                                        ValueMsg)
from repro_torch.core.dwork.client import TCPTransport
from repro_torch.core.engine.comm import core as comm_core
from repro_torch.core.engine.comm.serialize import (Ref, dumps, loads,
                                                    loads_call)
from repro_torch.core.engine.model import WorkerCrash

CRASH_EXIT_CODE = 17


class _LostDep(Exception):
    """A dependency value is unrecoverable from both its producer and the
    hub (the producer died before replicating it): report the task with
    the `__xfer_lost__:` prefix so the engine recomputes the value."""

    def __init__(self, name: str):
        super().__init__(name)
        self.name = name


class _DataServer:
    """Frame handler for the worker's data listener: peers Fetch stored
    payloads straight from this worker (per-connection threads)."""

    def __init__(self, plane: "_DataPlane"):
        self.plane = plane

    def handle(self, msg):
        if isinstance(msg, Fetch):
            payload = self.plane.get_payload(msg.task)
            if payload is None:
                return NotFound()
            return ValueMsg(task=msg.task, payload=payload)
        return NotFound()


class _DataPlane:
    """Worker-local result store + the Ref resolution chain.

    `store` maps task -> [payload, owned, spilled]: `owned` marks values
    PRODUCED here (the hub points peers at us for them), and the LRU
    byte budget (`spill_bytes`) evicts oldest-first — owned unspilled
    victims are pushed to the hub with `Spill` first, so eviction never
    loses the only copy.  `objs` caches deserialized values for
    same-worker dependents (the fast path that skips every wire)."""

    def __init__(self, transport, *, listen_host: str = "127.0.0.1"):
        self.transport = transport          # control-plane link to the hub
        self.me = ""
        self.inline_bytes = 65536
        self.spill_bytes = 64 * 1024 * 1024
        self.lock = threading.Lock()
        self.store: OrderedDict = OrderedDict()  # task -> [payload, owned,
        self.stored_bytes = 0                    #          spilled]
        self.objs: dict = {}                # task -> deserialized value
        self.peers: dict = {}               # data_addr -> Comm
        try:
            self.listener = comm_core.listen(f"tcp://{listen_host}:0",
                                             _DataServer(self))
        except OSError:
            self.listener = None            # no data plane: hub-only mode

    @property
    def data_addr(self) -> str:
        return self.listener.address if self.listener is not None else ""

    # ------------------------------------------------------------- store
    def get_payload(self, name: str):
        with self.lock:
            ent = self.store.get(name)
            if ent is None:
                return None
            self.store.move_to_end(name)
            return ent[0]

    def cache_obj(self, name: str, value):
        with self.lock:
            self.objs[name] = value

    def put(self, name: str, payload: str, *, owned: bool, value=None,
            have_value: bool = False):
        """Insert a payload, then evict LRU entries past the byte budget
        (spilling owned unspilled victims to the hub — outside the lock,
        Spill is an RPC)."""
        victims = []
        with self.lock:
            if name in self.store:
                self.store.move_to_end(name)
            else:
                self.store[name] = [payload, owned, False]
                self.stored_bytes += len(payload)
            if have_value:
                self.objs[name] = value
            while self.stored_bytes > self.spill_bytes \
                    and len(self.store) > 1:
                old, (pl, own, spilled) = self.store.popitem(last=False)
                self.stored_bytes -= len(pl)
                self.objs.pop(old, None)
                if own and not spilled:
                    victims.append((old, pl))
        for old, pl in victims:
            try:
                self.transport.request(Spill(worker=self.me, task=old,
                                             payload=pl))
            except Exception:  # noqa: BLE001 — hub gone; heartbeat reaps us
                pass

    def flush_spills(self):
        """Clean-exit replication: push every owned, still-unspilled
        value to the hub so dependents (and result materialization)
        outlive this process."""
        with self.lock:
            todo = [(n, e[0]) for n, e in self.store.items()
                    if e[1] and not e[2]]
            for _, e in self.store.items():
                if e[1]:
                    e[2] = True
        for name, payload in todo:
            try:
                self.transport.request(Spill(worker=self.me, task=name,
                                             payload=payload))
            except Exception:  # noqa: BLE001 — already shutting down
                break

    # --------------------------------------------------------- resolution
    def resolve(self, obj, xfers: list):
        """Materialize a `Ref` argument: local caches, then a hub Fetch
        that either answers directly (ValueMsg) or redirects to the
        producing worker's data listener (LocMsg).  Every network fetch
        appends `[path, nbytes, seconds]` to `xfers` (ships in the
        CompleteSteal entry for engine-side attribution)."""
        if not isinstance(obj, Ref):
            return obj
        name = obj.name
        with self.lock:
            if name in self.objs:
                return self.objs[name]
            ent = self.store.get(name)
            payload = ent[0] if ent is not None else None
            if ent is not None:
                self.store.move_to_end(name)
        if payload is not None:
            val = loads(payload)
            self.cache_obj(name, val)
            return val
        t0 = time.perf_counter()
        resp = self.transport.request(Fetch(task=name))
        if isinstance(resp, ValueMsg):
            xfers.append(["hub", len(resp.payload),
                          time.perf_counter() - t0])
            val = loads(resp.payload)
            self.cache_obj(name, val)
            return val
        if isinstance(resp, LocMsg):
            val, ok = self._peer_fetch(name, resp, xfers)
            if ok:
                return val
            raise _LostDep(name)
        raise KeyError(f"dependency value {name!r} unavailable on the hub "
                       "(pruned before this task ran?)")

    def _peer_fetch(self, name: str, loc: LocMsg, xfers: list):
        """The redirect leg: dial the producer's data listener; on any
        failure (producer dead, value evicted) re-Fetch the hub ONCE —
        a Spill or exit flush may have landed meanwhile.  -> (value, ok);
        not-ok means the value is unrecoverable (recompute territory)."""
        resp = None
        if loc.addr:
            t0 = time.perf_counter()
            try:
                comm = self.peers.get(loc.addr)
                if comm is None:
                    comm = comm_core.connect(loc.addr)
                    self.peers[loc.addr] = comm
                resp = comm.request(Fetch(task=name))
            except Exception:  # noqa: BLE001 — producer gone mid-dial
                stale = self.peers.pop(loc.addr, None)
                if stale is not None:
                    try:
                        stale.close()
                    except Exception:  # noqa: BLE001
                        pass
                resp = None
            if isinstance(resp, ValueMsg):
                xfers.append(["peer", len(resp.payload),
                              time.perf_counter() - t0])
                val = loads(resp.payload)
                self.cache_obj(name, val)
                return val, True
        t0 = time.perf_counter()
        try:
            resp = self.transport.request(Fetch(task=name))
        except Exception:  # noqa: BLE001 — hub gone too
            return None, False
        if isinstance(resp, ValueMsg):
            xfers.append(["hub", len(resp.payload),
                          time.perf_counter() - t0])
            val = loads(resp.payload)
            self.cache_obj(name, val)
            return val, True
        return None, False

    def close(self):
        if self.listener is not None:
            try:
                self.listener.stop()
            except Exception:  # noqa: BLE001
                pass
        for comm in self.peers.values():
            try:
                comm.close()
            except Exception:  # noqa: BLE001
                pass
        self.peers.clear()


def _run_task(plane: _DataPlane, execute, pass_worker: bool,
              me: str, name: str, meta) -> list:
    """Execute one stolen task; -> the extended CompleteSteal entry
    [name, ok, info] where info carries "d" (duration), then either
    "v" (inlined value payload, at most inline_bytes) or "n" (payload
    bytes kept in the local store — the hub records the location), plus
    "e" (error), "x" (per-dependency fetch stats), and "as" (store-as
    alias, for engine-driven recompute of a lost value)."""
    t0 = time.perf_counter()
    ok, value, err = True, None, None
    xfers: list = []
    try:
        payload = (meta or {}).get("__call__")
        if payload is not None:
            fn, args, kwargs = loads_call(payload)
            args = tuple(plane.resolve(a, xfers) for a in args)
            kwargs = {k: plane.resolve(v, xfers)
                      for k, v in kwargs.items()}
            value = fn(*args, **kwargs)
        elif execute is not None:
            out = (execute(name, meta, me) if pass_worker
                   else execute(name, meta))
            if isinstance(out, tuple):
                ok, value = bool(out[0]), out[1]
            elif out is None:
                ok = True
            elif isinstance(out, bool):
                ok = out
            else:
                ok, value = True, out
        # neither a packed call nor an executor: a bare named task (the
        # engine's registered-fn convention) completes as a no-op
    except WorkerCrash:
        os._exit(CRASH_EXIT_CODE)     # a crash drill kills the real process
    except _LostDep as e:
        ok, err = False, XFER_LOST_PREFIX + e.name
    except BaseException as e:        # noqa: BLE001 — reported, not fatal
        ok, err = False, repr(e)
    dur = time.perf_counter() - t0
    info: dict = {"d": dur}
    if ok:
        # a None value still ships (and is kept fetchable): a dependent's
        # Ref resolution must distinguish "value is None" from "missing"
        try:
            payload = dumps(value, what=f"result of task {name!r}")
        except Exception as e:        # noqa: BLE001 — SerializationError
            ok = False
            err = repr(e)
        else:
            targets = [name]
            store_as = (meta or {}).get("__store_as__")
            if store_as:
                info["as"] = store_as
                targets.append(store_as)
            if len(payload) > plane.inline_bytes and plane.data_addr:
                info["n"] = len(payload)
                for t in targets:
                    plane.put(t, payload, owned=True, value=value,
                              have_value=True)
            else:
                info["v"] = payload
                for t in targets:
                    plane.cache_obj(t, value)
    if err is not None:
        info["e"] = err
    if xfers:
        info["x"] = xfers
    return [name, ok, info]


def run_worker(host: str, port: int, name: str = "", *,
               idle_sleep: float = 0.002) -> int:
    """Connect, handshake, and run the client loop until the engine says
    Exit (or the connection drops).  Returns tasks executed."""
    transport = TCPTransport(host, port)
    try:
        local_host = transport.sock.getsockname()[0]
    except OSError:
        local_host = "127.0.0.1"
    plane = _DataPlane(transport, listen_host=local_host)
    hello = transport.request(Hello(worker=name, pid=os.getpid(),
                                    host=socket.gethostname(),
                                    data_addr=plane.data_addr))
    me = hello.worker
    plane.me = me
    plane.inline_bytes = max(int(getattr(hello, "inline_bytes", 65536)), 0)
    plane.spill_bytes = max(int(getattr(hello, "spill_bytes",
                                        64 * 1024 * 1024)), 0)
    steal_n = max(int(hello.steal_n), 1)
    execute = loads(hello.execute) if hello.execute else None
    pass_worker = bool(hello.pass_worker)
    hb = max(float(hello.heartbeat_s or 0.5), 0.05)
    stop = threading.Event()

    def _beat():
        while not stop.wait(hb):
            try:
                transport.request(Heartbeat(worker=me))
            except Exception:  # noqa: BLE001 — engine gone: reap ourselves
                os._exit(0)

    threading.Thread(target=_beat, daemon=True,
                     name=f"heartbeat-{me}").start()

    finished: list = []
    done = 0
    while True:
        try:
            resp = transport.request(
                CompleteSteal(worker=me, done=finished, n=steal_n))
        except (ConnectionError, OSError):
            break                     # engine gone: orphan self-reaping
        finished = []
        if isinstance(resp, ExitResp):
            break
        if not isinstance(resp, TaskMsg):
            time.sleep(idle_sleep)
            continue
        for task_name, meta in resp.tasks:
            finished.append(_run_task(plane, execute, pass_worker,
                                      me, task_name, meta))
            done += 1
    stop.set()
    try:
        if finished:                  # flush a final batch (Exit raced it)
            transport.request(CompleteSteal(worker=me, done=finished, n=0))
        # replicate every locally-held owned value before the goodbye:
        # dependents and engine-side materialization outlive this process
        plane.flush_spills()
        plane.close()
        transport.close()
    except Exception:  # noqa: BLE001 — already shutting down
        pass
    return done


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.core.engine.comm.worker",
        description="Join a listening repro engine as a worker process.")
    parser.add_argument("--connect", required=True, metavar="HOST:PORT",
                        help="the engine front door (Engine.comm_address)")
    parser.add_argument("--name", default="",
                        help="worker id (default: engine-assigned)")
    parser.add_argument("--idle-sleep", type=float, default=0.002,
                        help="sleep between empty steals (s)")
    args = parser.parse_args(argv)
    addr = args.connect
    if addr.startswith("tcp://"):
        addr = addr[len("tcp://"):]
    host, _, port = addr.rpartition(":")
    try:
        run_worker(host or "127.0.0.1", int(port), args.name,
                   idle_sleep=args.idle_sleep)
    except ConnectionError as e:
        print(f"worker: {e}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
