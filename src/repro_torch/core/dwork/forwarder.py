"""Message-forwarding tree (paper §4: 2-level rack-leader tree on Summit),
the port's copy of the JAX package's `repro.core.dwork.forwarder`.

A Forwarder accepts downstream dwork connections and relays every frame
over ONE shared upstream connection — constant open connections per rack
leader, no per-worker TCP setup at the hub.  Chaining forwarders builds
deeper trees for larger machines (`Engine(transport="tree")` assembles
one automatically).

Relaying is pipelined: a downstream handler enqueues its frame and waits
on its own reply slot while other handlers keep sending, so frames from
different downstream connections overlap on the upstream link instead of
serializing one round-trip at a time.  Request/response matching uses the
upstream connection's FIFO ordering as the tag: replies are handed back
in the order frames were sent (the upstream hub serves one connection's
frames in order, so this is exact).  That machinery lives in
`UpstreamLink` so a node with SEVERAL upstreams can reuse it per link.

`ShardRouter` is the sharded apex (paper §6 expansion item 4 composed
with the §4 tree): instead of blind frame relay it DECODES each frame
and routes the Table-2 verbs by task hash to per-shard upstream
`TaskServer`s through a `ShardedHub`'s routing logic — the hub behind
the tree.  Batched `CompleteSteal` verbs whose finished-batch and
steal-target shards differ are split per home shard and the steal-target
group is merged back onto the steal frame (one round-trip for that
shard).  Every per-shard round-trip is timed as an `rpc` event
`op="hop:L<k>:s<j>"` so `OverheadReport.rpc_by_op` attributes the shard
fan-out the same way plain forwarder hops are attributed per level.

Failure behavior: an upstream error wakes every waiting handler, closes
the downstream connections (both directions — no half-open relays), and
is surfaced on `Forwarder.upstream_error` instead of being swallowed.
"""
from __future__ import annotations

import socket
import socketserver
import threading
import time
from collections import deque

from repro_torch.core.dwork.api import decode, encode, encode_stats
from repro_torch.core.dwork.client import _recv_frame, _send_frame


class _Reply:
    """One-shot reply slot a downstream handler waits on."""

    __slots__ = ("event", "frame")

    def __init__(self):
        self.event = threading.Event()
        self.frame = None

    def set(self, frame):
        self.frame = frame
        self.event.set()


class UpstreamLink:
    """One shared, pipelined upstream connection: thread-safe frame
    round-trips with FIFO request/response matching.  The send lock is
    held only while writing, never across the upstream round-trip, so
    frames from many downstream handlers overlap on the wire."""

    def __init__(self, upstream, *, reply_timeout: float = 60.0):
        self.upstream = upstream
        self.error: str | None = None
        self.relayed = 0                      # frames sent upstream
        self.reply_timeout = reply_timeout    # per-request wait, seconds
        self._sock = None                     # lazily-opened shared link
        self._send_lock = threading.Lock()    # orders sends + FIFO tags
        self._pending: deque[_Reply] = deque()
        self._pending_lock = threading.Lock()
        self._reader: threading.Thread | None = None

    def _ensure(self):
        if self._sock is None:
            sock = socket.create_connection(self.upstream)
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            self._sock = sock
            self._reader = threading.Thread(target=self._read_upstream,
                                            daemon=True)
            self._reader.start()
        return self._sock

    def relay(self, frame: bytes) -> bytes:
        """Send one frame upstream, return its response."""
        reply = _Reply()
        with self._send_lock:
            if self.error is not None:
                raise ConnectionError(self.error)
            # local snapshot: the reader thread may null self._sock on an
            # upstream error mid-send; sendall on the closed local socket
            # raises OSError (handled), never AttributeError
            sock = self._ensure()
            with self._pending_lock:
                self._pending.append(reply)
            try:
                _send_frame(sock, frame)
            except OSError as e:
                self.fail(repr(e))
                raise ConnectionError(self.error) from e
            self.relayed += 1
            if self.error is not None:
                # the reader failed while we were sending: our slot may
                # have been appended after fail() drained the FIFO, so
                # nobody would ever wake us — fail fast instead
                with self._pending_lock:
                    try:
                        self._pending.remove(reply)
                    except ValueError:
                        pass
                raise ConnectionError(self.error)
        if not reply.event.wait(timeout=self.reply_timeout):
            # transient stall: abandon THIS request only.  The slot stays
            # in the FIFO (a late response is absorbed by it, keeping
            # request/response matching aligned) and the shared link
            # survives for every other downstream client.
            raise ConnectionError("upstream response timed out")
        if reply.frame is None:
            raise ConnectionError(self.error or "upstream closed")
        return reply.frame

    def _read_upstream(self):
        sock = self._sock
        try:
            while True:
                resp = _recv_frame(sock)
                if resp is None:
                    raise ConnectionError("upstream closed")
                with self._pending_lock:
                    reply = self._pending.popleft()
                reply.set(resp)
        except Exception as e:                # noqa: BLE001
            self.fail(repr(e))

    def fail(self, error: str):
        """Surface an upstream failure: record it, wake every waiter with
        an empty reply, and close the shared link."""
        if self.error is None:
            self.error = error
        with self._pending_lock:
            waiters, self._pending = list(self._pending), deque()
        for reply in waiters:
            reply.set(None)
        sock, self._sock = self._sock, None
        if sock is not None:
            try:
                sock.close()
            except OSError:
                pass


class _RelayHandler(socketserver.BaseRequestHandler):
    """Shared downstream frame loop for every tree node: the server's
    `relay(frame)` does the node's work (blind relay for `Forwarder`,
    hash routing for `ShardRouter`)."""

    def handle(self):
        try:
            while True:
                frame = _recv_frame(self.request)
                if frame is None:
                    return                    # downstream closed cleanly
                resp = self.server.relay(frame)
                _send_frame(self.request, resp)
        except ConnectionError:
            # upstream died (or an abrupt downstream disconnect raced a
            # send): close our side so the client sees the failure now
            # instead of hanging on a half-open relay
            pass
        finally:
            try:
                self.request.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            self.request.close()


class _TreeNode(socketserver.ThreadingTCPServer):
    """Common TCP shell of a tree node (Forwarder / ShardRouter)."""

    allow_reuse_address = True
    daemon_threads = True

    def __init__(self, addr):
        super().__init__(addr, _RelayHandler)

    def serve_background(self) -> threading.Thread:
        th = threading.Thread(target=self.serve_forever, daemon=True)
        th.start()
        return th


class Forwarder(_TreeNode):
    def __init__(self, addr, upstream, *, tracer=None, label: str = "fwd"):
        super().__init__(addr)
        self.upstream = upstream
        self.link = UpstreamLink(upstream)
        self.tracer = tracer                  # emits one `rpc` per hop
        self.label = label

    # link state surfaced under the names the rest of the repo uses
    @property
    def upstream_error(self) -> str | None:
        return self.link.error

    @property
    def relayed(self) -> int:
        return self.link.relayed

    @property
    def reply_timeout(self) -> float:
        return self.link.reply_timeout

    @reply_timeout.setter
    def reply_timeout(self, value: float):
        self.link.reply_timeout = value

    # ------------------------------------------------------------- relay
    def relay(self, frame: bytes) -> bytes:
        """Send one frame upstream, return its response.  Thread-safe and
        pipelined (see `UpstreamLink.relay`)."""
        t0 = time.perf_counter()
        resp = self.link.relay(frame)
        if self.tracer is not None:
            self.tracer.emit("rpc", op=f"hop:{self.label}",
                             dt=time.perf_counter() - t0)
        return resp

    # ------------------------------------------------------------ control
    def close(self):
        self.shutdown()
        self.link.fail("forwarder closed")
        self.server_close()


class ShardLinks:
    """The per-shard upstream links of a hub mounted behind the tree: one
    pipelined `UpstreamLink` per shard TaskServer, shared by every
    top-level `ShardRouter` (links are thread-safe).  Installed as a
    `ShardedHub.sender`, so every per-shard Table-2 verb the hub sends
    crosses a real wire and is timed as an `rpc` event
    `op="hop:<label>:s<shard>"` — the shard fan-out attribution."""

    def __init__(self, addrs, *, tracer=None, label: str = "L1"):
        self.links = [UpstreamLink(a) for a in addrs]
        self.tracer = tracer
        self.label = label

    def __call__(self, shard: int, msg):
        t0 = time.perf_counter()
        resp = decode(self.links[shard].relay(encode(msg)))
        if self.tracer is not None:
            self.tracer.emit("rpc", op=f"hop:{self.label}:s{shard}",
                             dt=time.perf_counter() - t0)
        return resp

    @property
    def error(self) -> str | None:
        return next((ln.error for ln in self.links
                     if ln.error is not None), None)

    def close(self):
        for ln in self.links:
            ln.fail("shard links closed")


class ShardRouter(_TreeNode):
    """The top-level tree node when the hub is sharded: decodes each
    frame arriving from the tree (or the boss link) and routes the
    Table-2 verbs by task hash to the per-shard upstream TaskServers,
    via `ShardedHub.handle` — affinity steals, cross-shard dependency
    `__notify__` mediation, `CompleteSteal` split/merge, and poison
    propagation all happen here, at the apex, exactly once per tree.

    Several routers (a wide level-1 layer) may front the SAME hub: the
    routing state (home map) and the per-shard links are shared and
    thread-safe, so any router can serve any downstream frame."""

    def __init__(self, addr, hub, *, tracer=None, label: str = "L1"):
        super().__init__(addr)
        self.hub = hub
        self.tracer = tracer        # parity with Forwarder (tree retuning);
        self.label = label          # per-shard hops are emitted by the
        self.relayed = 0            # hub's ShardLinks sender, not here
        self._count_lock = threading.Lock()

    @property
    def upstream_error(self) -> str | None:
        sender = getattr(self.hub, "sender", None)
        return getattr(sender, "error", None)

    def relay(self, frame: bytes) -> bytes:
        """The router's version of a relay: decode, hash-route through
        the hub, re-encode.  Handler threads run this concurrently, so
        the frame counter increments under a lock (the Forwarder's
        counter is ordered by its send lock)."""
        resp = self.hub.handle(decode(frame))
        with self._count_lock:
            self.relayed += 1
        if isinstance(resp, dict):
            return encode_stats(resp)
        return encode(resp)

    def close(self):
        self.shutdown()
        self.server_close()
