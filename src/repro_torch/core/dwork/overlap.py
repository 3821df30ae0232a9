"""Overlapping client — paper Fig. 2 caption: "Production client code would
use an assembly-line pattern to overlap these 4 steps", and §5: "This
waiting time can be hidden by overlapping computation and communication,
which I have implemented in the client."

`OverlapClient.run_loop` keeps one Steal in flight while the current task
executes (double-buffering), so per-task dispatch latency is hidden as long
as execution time >= round-trip time — exactly the paper's mechanism for
pushing the effective METG down to the server dispatch-rate bound.  The
port's copy of the JAX package's `repro.core.dwork.overlap`.
"""
from __future__ import annotations

import queue
import threading
from typing import Callable

from repro_torch.core.dwork.api import ExitResp, NotFound, TaskMsg
from repro_torch.core.dwork.client import Client


class OverlapClient(Client):
    def run_loop(self, execute: Callable[[str, dict], bool], *,
                 steal_n: int = 1, idle_sleep: float = 0.001,
                 max_idle: int = 1000):
        import time as _time
        prefetched: queue.Queue = queue.Queue(maxsize=1)
        stop = threading.Event()

        def fetcher():
            idle = 0
            while not stop.is_set():
                resp = self.steal(n=steal_n)
                if isinstance(resp, ExitResp):
                    prefetched.put(None)
                    return
                if isinstance(resp, NotFound):
                    idle += 1
                    if idle > max_idle:
                        prefetched.put(None)
                        return
                    _time.sleep(idle_sleep)
                    continue
                idle = 0
                prefetched.put(resp)          # blocks: one batch in flight

        th = threading.Thread(target=fetcher, daemon=True)
        th.start()
        done = 0
        try:
            while True:
                resp = prefetched.get()
                if resp is None:
                    return done
                assert isinstance(resp, TaskMsg)
                for name, meta in resp.tasks:
                    try:
                        ok = execute(name, meta)
                    except Exception:
                        ok = False
                    self.complete(name, ok=ok)
                    done += 1
        finally:
            stop.set()
