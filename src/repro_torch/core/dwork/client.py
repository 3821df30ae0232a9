"""dwork transports + worker client loop, the port's copy of the JAX
package's `repro.core.dwork.client`.

InProcTransport measures pure scheduler overhead (the paper's 23 us RTT
analog); TCPTransport is the ZeroMQ stand-in: length-prefixed frames (msgpack,
or JSON where msgpack is missing) over a threaded socket server.
"""
from __future__ import annotations

import socket
import socketserver
import struct
import threading
from typing import Callable, Optional

from repro_torch.core.dwork.api import (Complete, CompleteSteal, Create,
                                        Exit, ExitResp, NotFound, Stats,
                                        Steal, TaskMsg, Transfer, decode,
                                        encode, encode_stats)
from repro_torch.core.dwork.server import TaskServer


class InProcTransport:
    def __init__(self, server: TaskServer):
        self.server = server

    def request(self, msg):
        return self.server.handle(msg)

    def close(self):
        pass


def _send_frame(sock, data: bytes):
    sock.sendall(struct.pack(">I", len(data)) + data)


def _recv_frame(sock) -> Optional[bytes]:
    hdr = b""
    while len(hdr) < 4:
        chunk = sock.recv(4 - len(hdr))
        if not chunk:
            return None
        hdr += chunk
    (n,) = struct.unpack(">I", hdr)
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(min(65536, n - len(buf)))
        if not chunk:
            return None
        buf += chunk
    return buf


class _Handler(socketserver.BaseRequestHandler):
    def handle(self):
        while True:
            frame = _recv_frame(self.request)
            if frame is None:
                return
            msg = decode(frame)
            resp = self.server.task_server.handle(msg)
            if isinstance(resp, dict):
                _send_frame(self.request, encode_stats(resp))
            else:
                _send_frame(self.request, encode(resp))


class TCPServer(socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    daemon_threads = True

    def __init__(self, addr, task_server: TaskServer):
        super().__init__(addr, _Handler)
        self.task_server = task_server

    def serve_background(self) -> threading.Thread:
        th = threading.Thread(target=self.serve_forever, daemon=True)
        th.start()
        return th


class TCPTransport:
    def __init__(self, host: str, port: int):
        self.sock = socket.create_connection((host, port))
        self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self.lock = threading.Lock()

    def request(self, msg):
        with self.lock:
            _send_frame(self.sock, encode(msg))
            frame = _recv_frame(self.sock)
        if frame is None:
            raise ConnectionError("dhub connection closed")
        return decode(frame)

    def close(self):
        self.sock.close()


class Client:
    """Worker-side API wrapper + the paper's client loop (Fig. 2)."""

    def __init__(self, transport, worker: str):
        self.t = transport
        self.worker = worker

    def create(self, task: str, deps=(), meta=None):
        return self.t.request(Create(task=task, deps=list(deps),
                                     meta=dict(meta or {})))

    def steal(self, n: int = 1):
        return self.t.request(Steal(worker=self.worker, n=n))

    def complete(self, task: str, ok: bool = True):
        return self.t.request(Complete(worker=self.worker, task=task, ok=ok))

    def complete_steal(self, done, n: int = 0):
        """Report a batch of finished tasks and steal the next batch in the
        same round-trip (`done` is [(task, ok), ...]; n=0 completes only)."""
        return self.t.request(CompleteSteal(worker=self.worker,
                                            done=list(done), n=n))

    def transfer(self, task: str, new_deps):
        return self.t.request(Transfer(worker=self.worker, task=task,
                                       new_deps=list(new_deps)))

    def exit(self):
        return self.t.request(Exit(worker=self.worker))

    def stats(self) -> dict:
        return self.t.request(Stats())

    def run_loop(self, execute: Callable[[str, dict], bool], *,
                 steal_n: int = 1, idle_sleep: float = 0.001,
                 max_idle: int = 1000):
        """CLIENT-LOOP from Fig. 2: steal -> execute -> complete, until the
        server responds Exit.  `execute` returns success; failures are
        reported (error poisoning on the server).  The finished batch rides
        on the next steal (`CompleteSteal`), so each loop iteration costs
        one round-trip regardless of `steal_n`."""
        import time as _time
        idle = 0
        done = 0
        finished: list = []
        while True:
            resp = self.complete_steal(finished, n=steal_n)
            finished = []
            if isinstance(resp, ExitResp):
                return done
            if isinstance(resp, NotFound):
                idle += 1
                if idle > max_idle:
                    return done
                _time.sleep(idle_sleep)
                continue
            idle = 0
            assert isinstance(resp, TaskMsg)
            for name, meta in resp.tasks:
                try:
                    ok = execute(name, meta)
                except Exception:
                    ok = False
                finished.append((name, ok))
                done += 1
