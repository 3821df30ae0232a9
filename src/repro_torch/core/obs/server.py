"""Streaming stats endpoint: a stdlib `http.server` thread over a live
`MetricsRegistry` + engine, so a resident service is observable without
stopping it (ROADMAP item 5's status/worker-monitor shape).  The port's
copy of the JAX package's `repro.core.obs.server`.

Endpoints:

  * `GET /stats`   — JSON: the registry dump, windowed rates (tasks/s
    and per-worker busy fraction over the interval since the previous
    scrape), per-worker and per-shard tables, trace counters, a
    `critical_path` section (the post-hoc analyzer's digest — why the
    run-so-far took as long as it did; skipped with a reason once the
    retained trace exceeds `explain_max_events`), and the latest
    windowed `LatencyReport` per serving frontend (with per-tenant
    slices when requests carry `tenant=` labels)
  * `GET /health`  — JSON liveness: `ok` is false once the resident
    dispatch loop has died
  * `GET /metrics` — Prometheus text exposition (format 0.0.4)

Rates are scrape-windowed: each `/stats` diffs the cumulative
done/busy tables against the previous scrape (baseline taken at
`start()`), so the scraper's own interval is the averaging window —
the standard pull-model convention, and it needs no background sampler
thread of its own.  All reads are monitoring-grade: unlocked engine
tables read under the GIL, never blocking the dispatch loop.

`Client.stats_server()` builds the registry (via `obs.instrument`) and
one of these in a single call.
"""
from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional


class _HTTPServer(ThreadingHTTPServer):
    daemon_threads = True
    allow_reuse_address = True
    owner: "StatsServer"


class _Handler(BaseHTTPRequestHandler):
    server_version = "repro-obs/1"

    def do_GET(self):  # noqa: N802 — http.server API
        owner = self.server.owner
        path = self.path.split("?", 1)[0]
        try:
            if path == "/stats":
                body = json.dumps(owner.stats(), default=str).encode()
                ctype = "application/json"
            elif path == "/health":
                body = json.dumps(owner.health()).encode()
                ctype = "application/json"
            elif path == "/metrics":
                body = owner.registry.prometheus().encode()
                ctype = "text/plain; version=0.0.4; charset=utf-8"
            else:
                self.send_error(404, "unknown endpoint "
                                     "(try /stats, /health, /metrics)")
                return
        except Exception as e:   # noqa: BLE001 — a scrape failure is the
            self.send_error(500, repr(e))   # scraper's problem, never the
            return                          # observed system's
        self.send_response(200)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, *args):     # silence per-request stderr lines
        pass


class StatsServer:
    """Serve `/stats`, `/health`, `/metrics` for one registry + engine.

        srv = StatsServer(reg, engine=engine).start()
        urllib.request.urlopen(srv.url + "/stats")

    `port=0` (default) binds an ephemeral port, published as
    `srv.port` / `srv.url` after `start()`.  Pass `client=` to follow
    its engine AND any frontends it attaches later via `serve()`.
    """

    def __init__(self, registry, *, client=None, engine=None,
                 frontends: Optional[list] = None,
                 host: str = "127.0.0.1", port: int = 0,
                 explain_max_events: int = 200_000):
        self.registry = registry
        self._client = client
        self._engine = engine if engine is not None else (
            client.engine if client is not None else None)
        self._frontends = frontends
        # critical-path scrape budget: the analyzer is post-hoc (one
        # pass over a snapshot of the event log), but a scrape must stay
        # cheap — above this many retained events the section reports
        # "skipped" instead of analyzing.  0 disables the section.
        self.explain_max_events = explain_max_events
        self.host = host
        self.port = port
        self._httpd: Optional[_HTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()
        self._last = None          # (t_mono, done_total, {w: busy_s})

    # ----------------------------------------------------------- lifecycle
    def start(self) -> "StatsServer":
        if self._httpd is not None:
            return self
        httpd = _HTTPServer((self.host, self.port), _Handler)
        httpd.owner = self
        self.port = httpd.server_address[1]
        if self._engine is not None:
            # baseline so the FIRST scrape already has a rate window
            wstats = self._engine.worker_stats()
            self._last = (time.monotonic(),
                          self._engine.tasks_done_total(),
                          {w: s["busy_s"] for w, s in wstats.items()})
        self._httpd = httpd
        self._thread = threading.Thread(target=httpd.serve_forever,
                                        name="obs-stats", daemon=True)
        self._thread.start()
        return self

    def stop(self):
        httpd, self._httpd = self._httpd, None
        if httpd is None:
            return
        httpd.shutdown()
        httpd.server_close()
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def __enter__(self) -> "StatsServer":
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    # ------------------------------------------------------------ payloads
    def _live_frontends(self) -> list:
        if self._frontends is not None:
            return list(self._frontends)
        if self._client is not None:
            return list(self._client._frontends)
        return []

    def stats(self) -> dict:
        eng = self._engine
        pids: dict = {}
        if eng is not None:
            # proc transport: register RSS gauges for workers that joined
            # after instrumentation, BEFORE the registry dump below so
            # the same scrape already exposes them
            pids = eng.worker_pids()
            if pids:
                from repro_torch.core.obs.instrument import \
                    instrument_worker_rss
                instrument_worker_rss(self.registry, eng)
        payload: dict = {"metrics": self.registry.dump()}
        if eng is not None:
            now = time.monotonic()
            wstats = eng.worker_stats()
            done_total = eng.tasks_done_total()
            busy_now = {w: s["busy_s"] for w, s in wstats.items()}
            with self._lock:
                last = self._last
                self._last = (now, done_total, busy_now)
            window = rate = None
            lbusy: dict = {}
            if last is not None:
                lt, ldone, lbusy = last
                window = max(now - lt, 1e-9)
                rate = max(done_total - ldone, 0) / window
            if pids:
                from repro_torch.core.obs.instrument import _pid_rss
            workers = {}
            for w, s in wstats.items():
                row = {"done": s["done"],
                       "busy_s": round(s["busy_s"], 6),
                       "alive": s["alive"]}
                if window is not None:
                    frac = (s["busy_s"] - lbusy.get(w, 0.0)) / window
                    row["busy_frac"] = round(min(max(frac, 0.0), 1.0), 4)
                pid = pids.get(w)
                if pid:
                    row["pid"] = pid
                    row["rss_bytes"] = _pid_rss(pid)
                workers[w] = row
            tracer = eng.tracer
            journal = eng.journal
            payload["engine"] = {
                "live_workers": eng.live_workers(),
                "worker_deaths": eng.worker_deaths,
                "tasks_done": done_total,
                "tasks_failed": eng.exec_failed,
                "tasks_retried": eng.retries_total,
                "journal_bytes": (journal.bytes_written
                                  if journal is not None else 0),
                "ready_depth": eng.backend.ready_depth(),
                "shard_ready_depth": eng.backend.ready_depths(),
                "trace": {"n_emitted": tracer.n_emitted,
                          "dropped": tracer.dropped,
                          "rpc_seen": tracer.rpc_seen},
            }
            totals = getattr(eng, "xfer_totals", None)
            if totals is not None:
                with eng._xfer_lock:
                    snap = {p: list(v) for p, v in totals.items()}
                payload["engine"]["xfer"] = {
                    "lost": eng.xfer_lost_total,
                    "by_path": {p: {"n": n, "bytes": b,
                                    "total_s": round(t, 6)}
                                for p, (n, b, t) in sorted(snap.items())},
                }
            payload["rates"] = {
                "tasks_per_s": (round(rate, 3)
                                if rate is not None else None),
                "window_s": (round(window, 3)
                             if window is not None else None),
            }
            payload["workers"] = workers
            n_events = len(tracer.events)
            if self.explain_max_events and n_events:
                if n_events <= self.explain_max_events:
                    try:
                        from repro_torch.core.obs.critical_path import \
                            CriticalPathReport
                        cp = CriticalPathReport.from_engine(eng)
                        payload["critical_path"] = cp.summary(max_tasks=16)
                    except Exception:   # noqa: BLE001 — diagnosis must
                        pass            # never fail the scrape
                else:
                    payload["critical_path"] = {
                        "skipped": f"trace too large ({n_events} events "
                                   f"> explain_max_events="
                                   f"{self.explain_max_events})"}
        serving = []
        for fe in self._live_frontends():
            # a running periodic monitor owns the window; otherwise the
            # scrape itself is the window (snapshot() arms monitoring,
            # so the priming scrape returns an empty first window)
            if fe._snap_thread is not None and fe.snapshots:
                rep = fe.snapshots[-1]
            else:
                rep = fe.snapshot()
            serving.append(rep.summary())
        payload["serving"] = serving
        return payload

    def health(self) -> dict:
        eng = self._engine
        if eng is None:
            return {"ok": True}
        loop_dead = eng._loop_error is not None
        return {
            "ok": not loop_dead,
            "resident": eng.resident,
            "loop_running": eng.started if eng.resident else False,
            "live_workers": eng.live_workers(),
        }
