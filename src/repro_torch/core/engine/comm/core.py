"""Comm core: the connector/listener abstraction and the transport
registry (in the spirit of dask-distributed's comm layer), the port's copy
of the JAX package's `repro.core.engine.comm.core`.  The registry holds the
same four names; "proc" raises `NotImplementedError` when an engine asks
for its backend, until its modules are ported.

Two registries live here:

  * **Address families** (`register_connector` / `register_listener`):
    `connect("tcp://host:port")` returns a `Comm` (request/response over
    the Table-2 frame protocol), `listen("tcp://host:0", handler)` binds
    a `Listener` that serves frames into any object with a `.handle(msg)`
    method.  The TCP family reuses the dwork frame machinery
    (`TCPServer` / `TCPTransport` — length-prefixed msgpack); "inproc://"
    is the zero-copy loopback.  New families (tls, uds, ...) plug in
    without touching the engine.

  * **Transport families** (`register_transport`): the engine-facing
    names — "inproc", "thread", "tree", "proc" — each owning a backend
    builder.  `Engine(transport=...)` resolves the name here, so the
    executor no longer hard-codes the backend if/else ladder and a new
    execution substrate is one `register_transport` call.

The split mirrors what the engine actually varies: HOW bytes move
(address family) vs WHO executes tasks (transport family).  "proc" is
the one family that uses both: its backend serves a TCP listener that
spawned worker processes (or remote hosts) dial back into.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Callable

from repro_torch.core.dwork.client import TCPServer, TCPTransport

# --------------------------------------------------------------- comms


class Comm:
    """One established channel speaking Table-2 verbs: `request(msg)`
    returns the decoded response message."""

    def request(self, msg):
        raise NotImplementedError

    def close(self):
        raise NotImplementedError


class Connector:
    """Dials an address of one family and returns a `Comm`."""

    scheme = ""

    def connect(self, location: str) -> Comm:
        raise NotImplementedError


class Listener:
    """Serves inbound comms of one family into `handler.handle(msg)`."""

    scheme = ""

    @property
    def address(self) -> str:
        raise NotImplementedError

    def stop(self):
        raise NotImplementedError


class TCPComm(Comm):
    """The dwork frame client as a Comm (locked socket, one in-flight
    request per comm)."""

    def __init__(self, host: str, port: int):
        self._t = TCPTransport(host, port)

    def request(self, msg):
        return self._t.request(msg)

    def close(self):
        self._t.close()


class TCPConnector(Connector):
    scheme = "tcp"

    def connect(self, location: str) -> TCPComm:
        host, _, port = location.rpartition(":")
        return TCPComm(host or "127.0.0.1", int(port))


class TCPListener(Listener):
    """The dwork threaded frame server bound to an arbitrary handler —
    `TCPServer` dispatches every decoded frame to `handler.handle(msg)`
    on a per-connection thread, exactly as it does for a TaskServer."""

    scheme = "tcp"

    def __init__(self, location: str, handler):
        host, _, port = location.rpartition(":")
        self._srv = TCPServer((host or "127.0.0.1", int(port or 0)), handler)
        self._srv.serve_background()

    @property
    def host_port(self) -> tuple:
        addr = self._srv.server_address
        return addr[0], addr[1]

    @property
    def address(self) -> str:
        host, port = self.host_port
        return f"tcp://{host}:{port}"

    def stop(self):
        self._srv.shutdown()
        self._srv.server_close()


class InProcComm(Comm):
    def __init__(self, handler):
        self._handler = handler

    def request(self, msg):
        return self._handler.handle(msg)

    def close(self):
        pass


class InProcListener(Listener):
    """Loopback listener: connectable by name within this process."""

    scheme = "inproc"

    def __init__(self, location: str, handler):
        self._name = location or f"anon-{id(handler):x}"
        with _INPROC_LOCK:
            _INPROC[self._name] = handler

    @property
    def address(self) -> str:
        return f"inproc://{self._name}"

    def stop(self):
        with _INPROC_LOCK:
            _INPROC.pop(self._name, None)


class InProcConnector(Connector):
    scheme = "inproc"

    def connect(self, location: str) -> InProcComm:
        with _INPROC_LOCK:
            handler = _INPROC.get(location)
        if handler is None:
            raise ConnectionError(f"no inproc listener named {location!r}")
        return InProcComm(handler)


_INPROC: dict = {}                  # name -> handler (loopback address table)
_INPROC_LOCK = threading.Lock()

_CONNECTORS: dict = {}
_LISTENERS: dict = {}


def register_connector(scheme: str, connector: Connector):
    _CONNECTORS[scheme] = connector


def register_listener(scheme: str, factory: Callable):
    _LISTENERS[scheme] = factory


def _split(address: str) -> tuple:
    scheme, sep, location = address.partition("://")
    if not sep:
        raise ValueError(f"address {address!r} has no scheme "
                         "(expected e.g. 'tcp://host:port')")
    return scheme, location


def connect(address: str) -> Comm:
    """Dial `address` ("tcp://host:port", "inproc://name")."""
    scheme, location = _split(address)
    conn = _CONNECTORS.get(scheme)
    if conn is None:
        raise ValueError(f"unknown address family {scheme!r}; "
                         f"registered: {sorted(_CONNECTORS)}")
    return conn.connect(location)


def listen(address: str, handler) -> Listener:
    """Bind a listener serving frames into `handler.handle(msg)`."""
    scheme, location = _split(address)
    factory = _LISTENERS.get(scheme)
    if factory is None:
        raise ValueError(f"unknown address family {scheme!r}; "
                         f"registered: {sorted(_LISTENERS)}")
    return factory(location, handler)


register_connector("tcp", TCPConnector())
register_listener("tcp", TCPListener)
register_connector("inproc", InProcConnector())
register_listener("inproc", InProcListener)


# ------------------------------------------------------ transport registry


@dataclass(frozen=True)
class TransportFamily:
    """One engine-facing transport: who executes, and how to build the
    scheduler backend for it.  `make_backend(**kw)` receives the full
    engine kwargs superset and picks what it needs."""

    name: str
    workers: str                    # "inline" | "threads" | "processes"
    description: str
    make_backend: Callable


_FAMILIES: dict = {}


def register_transport(family: TransportFamily):
    _FAMILIES[family.name] = family


def family(name: str) -> TransportFamily:
    fam = _FAMILIES.get(name)
    if fam is None:
        raise ValueError(f"unknown transport {name!r}; "
                         f"registered: {transport_names()}")
    return fam


def transport_names() -> tuple:
    return tuple(_FAMILIES)


def _make_local(*, shards=1, lease_timeout=None, clock=None, tracer=None,
                **_):
    from repro_torch.core.engine.backends import ServerBackend, ShardedBackend

    if shards > 1:
        return ShardedBackend(shards=shards, lease_timeout=lease_timeout,
                              clock=clock, tracer=tracer)
    return ServerBackend(lease_timeout=lease_timeout, clock=clock,
                         tracer=tracer)


def _make_tree(*, workers=1, tree_fanout=4, tree_levels=1, shards=1,
               lease_timeout=None, clock=None, tracer=None, **_):
    from repro_torch.core.engine.backends import TreeBackend

    return TreeBackend(workers=workers, fanout=tree_fanout,
                       levels=tree_levels, shards=shards,
                       lease_timeout=lease_timeout, clock=clock,
                       tracer=tracer)


# the JAX package's transports whose machinery the port does not have yet:
# asking for one raises instead of quietly running in-process
UNPORTED = {
    "proc": "transport='proc' needs worker processes (comm/proc.py, "
            "comm/worker.py), which the port has not taken over yet: "
            "ROADMAP.md Queue 1 item 4g",
}


def _unported(name: str) -> Callable:
    def make_backend(**_):
        raise NotImplementedError(UNPORTED[name])
    return make_backend


register_transport(TransportFamily(
    "inproc", "inline",
    "tasks run inline in the dispatch loop (deterministic; tests/METG)",
    _make_local))
register_transport(TransportFamily(
    "thread", "threads",
    "slot-bounded thread pool (blocking task bodies overlap)",
    _make_local))
register_transport(TransportFamily(
    "tree", "inline",
    "inline execution behind a real TCP forwarding tree (paper §4)",
    _make_tree))
register_transport(TransportFamily(
    "proc", "processes",
    "spawned worker processes over TCP frames (GIL-escaping parallelism)",
    _unported("proc")))
