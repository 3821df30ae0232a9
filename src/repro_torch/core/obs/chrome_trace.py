"""Chrome-trace export: render a `TraceRecorder` event log as a
Trace Event Format document that Perfetto / `chrome://tracing` loads
directly — the Fig. 2 protocol as a timeline you can scrub.  The port's
copy of the JAX package's `repro.core.obs.chrome_trace`.

Lane layout (one `tid` per lane, stable across exports):

  * one lane per worker, in pool order (`w0`, `w1`, ...): each task
    execution is an `X` (complete) span from RUN_START to RUN_END,
    with worker deaths and failures as instant markers on the lane
  * an `rpc` lane: every sampled scheduler round-trip as a span ending
    at its emit time (rpc events are stamped on completion with `dt`)
  * one lane per `hop:*` op (`hop:L1`, `hop:L1:s0`, ...): the
    forwarding-tree / per-shard hops nested under the worker's
    end-to-end round-trip, now visibly so
  * a `requests` lane: serving requests as async `b`/`e` pairs keyed by
    request name (overlapping freely), with batch formations and
    rejections as instants.  A REQ_DONE whose enqueue partner was
    evicted from the ring buffer gets its begin synthesized at
    `t - latency_s`, clamped at the trace epoch (a request older than
    the retained window must not render at a negative timestamp); one
    without `latency_s` at all is skipped.
  * with `critical_path=` (a list of task names, e.g.
    `CriticalPathReport.path`): a dedicated `critical path` lane at the
    top repeating the path's final executions in order, plus flow
    arrows (`s`/`f` pairs) linking each path task's run to the next
    across the worker lanes — the makespan chain, scrubbed visually.

`to_chrome_trace(trace, path=None, critical_path=None)` returns the
document as a dict and, with `path`, writes it as JSON (the
conventional suffix is `.trace.json`).  `TraceRecorder.to_chrome_trace`
forwards here.
"""
from __future__ import annotations

import json
from typing import Optional

from repro_torch.core.engine.model import (BATCH_FORMED, CANCELLED,
                                           FAILED, REQ_DONE, REQ_ENQUEUED,
                                           REQ_REJECTED, REQUEUED, RPC,
                                           RUN_END, RUN_START, WORKER_DEAD)

PID = 1


def _worker_key(w: str):
    """Natural sort for w<i> names so lanes appear in pool order."""
    if isinstance(w, str) and w[:1] == "w" and w[1:].isdigit():
        return (0, int(w[1:]), w)
    return (1, 0, str(w))


def to_chrome_trace(trace, path: Optional[str] = None, *,
                    critical_path: Optional[list] = None) -> dict:
    with trace._lock:
        events = list(trace.events)
    t0 = min((e.t for e in events), default=0.0)

    def us(t: float) -> float:
        return (t - t0) * 1e6

    cp = list(critical_path or ())
    cp_set = set(cp)
    cp_runs: dict = {}           # path task -> last (ts, dur, worker) run
    spans: list = []             # events carrying a symbolic lane key
    open_start: dict = {}        # task -> t (sequential pairing, as in
    req_open: set = set()        #          OverheadReport.from_trace)
    workers: set = set()
    hop_lanes: set = set()
    other_lanes: set = set()
    for e in events:
        ev = e.event
        if ev == RUN_START:
            open_start[e.task] = e.t
        elif ev == RUN_END:
            ts = open_start.pop(e.task, None)
            if ts is not None and e.worker is not None:
                workers.add(e.worker)
                spans.append((("w", e.worker), {
                    "ph": "X", "name": e.task, "cat": "task",
                    "ts": us(ts), "dur": max(us(e.t) - us(ts), 0.0)}))
                if e.task in cp_set:
                    # last execution wins: that is the one the critical
                    # path's decomposition attributes
                    cp_runs[e.task] = (us(ts),
                                       max(us(e.t) - us(ts), 0.0),
                                       e.worker)
        elif ev == RPC:
            op = e.extra.get("op", "?")
            dt = e.extra.get("dt", 0.0)
            if op.startswith("hop:"):
                lane = ("hop", op)
                hop_lanes.add(op)
            else:
                lane = ("rpc",)
                other_lanes.add("rpc")
            rec = {"ph": "X", "name": op, "cat": "rpc",
                   "ts": us(e.t - dt), "dur": dt * 1e6}
            if "n" in e.extra:
                rec["args"] = {"n": e.extra["n"]}
            spans.append((lane, rec))
        elif ev == REQ_ENQUEUED:
            req_open.add(e.task)
            other_lanes.add("requests")
            spans.append((("requests",), {
                "ph": "b", "cat": "request", "id": str(e.task),
                "name": "request", "ts": us(e.t),
                "args": {"depth": e.extra.get("depth", 0)}}))
        elif ev == REQ_DONE:
            lat = e.extra.get("latency_s")
            if lat is None:
                continue          # partner evicted AND unstamped: no span
            other_lanes.add("requests")
            if e.task not in req_open:
                # enqueue evicted from the ring: synthesize the begin,
                # clamped at the trace epoch — a request enqueued before
                # the retained window began must not render at a
                # negative timestamp (Perfetto misplaces the span)
                spans.append((("requests",), {
                    "ph": "b", "cat": "request", "id": str(e.task),
                    "name": "request", "ts": max(us(e.t - lat), 0.0)}))
            else:
                req_open.discard(e.task)
            spans.append((("requests",), {
                "ph": "e", "cat": "request", "id": str(e.task),
                "name": "request", "ts": us(e.t),
                "args": {"ok": e.extra.get("ok", True),
                         "latency_ms": round(lat * 1e3, 3)}}))
        elif ev == BATCH_FORMED:
            other_lanes.add("requests")
            spans.append((("requests",), {
                "ph": "i", "s": "t", "name": "batch", "cat": "serving",
                "ts": us(e.t),
                "args": {"size": e.extra.get("size", 0),
                         "depth": e.extra.get("depth", 0)}}))
        elif ev == REQ_REJECTED:
            other_lanes.add("requests")
            spans.append((("requests",), {
                "ph": "i", "s": "t", "name": "rejected", "cat": "serving",
                "ts": us(e.t),
                "args": {"depth": e.extra.get("depth", 0)}}))
        elif ev == WORKER_DEAD and e.worker is not None:
            workers.add(e.worker)
            spans.append((("w", e.worker), {
                "ph": "i", "s": "t", "name": "worker-dead", "cat": "fault",
                "ts": us(e.t), "args": dict(e.extra)}))
        elif ev == FAILED and e.worker is not None:
            workers.add(e.worker)
            spans.append((("w", e.worker), {
                "ph": "i", "s": "t", "name": f"fail:{e.task}",
                "cat": "fault", "ts": us(e.t),
                "args": {"error": e.extra.get("error")}}))
        elif ev in (REQUEUED, CANCELLED):
            other_lanes.add("scheduler")
            spans.append((("scheduler",), {
                "ph": "i", "s": "t",
                "name": ("requeue" if ev == REQUEUED
                         else f"cancel:{e.task}"),
                "cat": "scheduler", "ts": us(e.t),
                "args": dict(e.extra)}))

    # critical-path overlay: a dedicated lane repeating the path's final
    # executions in order, plus s/f flow arrows stitching consecutive
    # path tasks together across the worker lanes
    cp_drawn = [t for t in cp if t in cp_runs]
    for i, task in enumerate(cp_drawn):
        ts, dur, w = cp_runs[task]
        spans.append((("critical",), {
            "ph": "X", "name": task, "cat": "critical_path",
            "ts": ts, "dur": dur, "args": {"order": i, "worker": w}}))
    for i in range(len(cp_drawn) - 1):
        a, b = cp_drawn[i], cp_drawn[i + 1]
        ts_a, dur_a, w_a = cp_runs[a]
        ts_b, _dur_b, w_b = cp_runs[b]
        flow = {"id": i + 1, "name": "critical-path",
                "cat": "critical_path"}
        spans.append((("w", w_a), {
            **flow, "ph": "s", "ts": ts_a + dur_a}))
        spans.append((("w", w_b), {
            **flow, "ph": "f", "bp": "e", "ts": max(ts_b, ts_a + dur_a)}))

    # lane order: critical path on top, workers in pool order, then rpc,
    # hops, scheduler, requests — matched by thread_sort_index below
    lanes: list = []
    if cp_drawn:
        lanes.append(("critical",))
    lanes.extend(("w", w) for w in sorted(workers, key=_worker_key))
    if "rpc" in other_lanes:
        lanes.append(("rpc",))
    lanes.extend(("hop", op) for op in sorted(hop_lanes))
    if "scheduler" in other_lanes:
        lanes.append(("scheduler",))
    if "requests" in other_lanes:
        lanes.append(("requests",))
    tid_of = {lane: i + 1 for i, lane in enumerate(lanes)}

    out: list = [{"ph": "M", "pid": PID, "tid": 0, "name": "process_name",
                  "args": {"name": "repro engine"}}]
    for lane, tid in tid_of.items():
        label = lane[1] if lane[0] in ("w", "hop") else (
            "critical path" if lane[0] == "critical" else lane[0])
        out.append({"ph": "M", "pid": PID, "tid": tid,
                    "name": "thread_name", "args": {"name": label}})
        out.append({"ph": "M", "pid": PID, "tid": tid,
                    "name": "thread_sort_index", "args": {"sort_index": tid}})
    for lane, rec in spans:
        rec["pid"] = PID
        rec["tid"] = tid_of[lane]
        out.append(rec)

    doc = {"traceEvents": out, "displayTimeUnit": "ms"}
    if path is not None:
        with open(path, "w") as f:
            json.dump(doc, f)
    return doc
