"""Port parity for the observability layer: the programs of
tests/test_obs.py and tests/test_critical_path.py, run through the JAX
package's `repro.core.obs` and the port's `repro_torch.core.obs`.

Each program takes a side (the names it needs from one package) and returns
what it observed: registry dumps and Prometheus text, stats-server keys,
Chrome-trace documents, critical-path reports and the rendered text of
`explain` and `top`.  Both sides must observe exactly the same: everything
compared is integers, strings and times from a `ManualClock` (round-trip
times measured on the wall clock are compared by count only).  Then the
explain CLI of the port reads a trace the JAX recorder saved, and the port's
`launch.serve` writes its Chrome trace with the stats server up."""
import contextlib
import io
import json
import os
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path
from types import SimpleNamespace

import pytest

import repro.core.engine as jax_engine
import repro.core.obs as jax_obs
from repro.core.obs import explain as jax_explain
from repro.core.obs import top as jax_top
import repro_torch.core.engine as port_engine
import repro_torch.core.obs as port_obs
from repro_torch.core.obs import explain as port_explain
from repro_torch.core.obs import top as port_top

ROOT = Path(__file__).resolve().parents[1]
T = 30.0


def side(obs, explain, top, engine):
    return SimpleNamespace(obs=obs, explain=explain, top=top, E=engine)


SIDES = {"jax": side(jax_obs, jax_explain, jax_top, jax_engine),
         "port": side(port_obs, port_explain, port_top, port_engine)}


def both(program, *args):
    out = {name: program(ns, *args) for name, ns in SIDES.items()}
    assert out["port"] == out["jax"]
    return out["port"]


# ------------------------------------------------------ metrics registry


def registry_ops(ns):
    reg = ns.obs.MetricsRegistry()
    a = reg.counter("x_total", "help")
    b = reg.counter("x_total", labels={"op": "steal"})
    a.inc()
    a.inc(4)
    b.inc(2)
    reg.counter("req_total", labels={"op": "create"}).inc(1)
    g = reg.gauge("depth", "queue depth")
    g.set(10)
    g.inc(5)
    g.dec(2)
    state = {"n": 7}
    cb = reg.counter("cb_total", fn=lambda: state["n"])
    state["n"] = 9
    reg.gauge("boom", fn=lambda: 1 / 0)
    h = reg.histogram("lat_seconds", "latency", labels={"k": "v"},
                      buckets=(0.001, 0.01, 0.1, 1.0))
    for v in (0.0005, 0.005, 0.005, 0.05, 0.5):
        h.observe(v)
    reg.counter("esc_total", labels={"p": 'a"b\\c\nd'}).inc()
    raised = []
    for make in (reg.gauge, reg.histogram):
        try:
            make("x_total")
        except TypeError:
            raised.append("TypeError")
    try:
        cb.inc()
    except RuntimeError:
        raised.append("RuntimeError")
    return (reg.counter("x_total") is a, cb.value, reg.dump(),
            reg.prometheus(), h.snapshot(), h.quantile(0.5),
            h.quantile(0.95), ns.obs.Histogram("empty").quantile(0.5),
            raised, list(ns.obs.LATENCY_BUCKETS), list(ns.obs.RPC_BUCKETS))


def deterministic(dump):
    """A registry dump without what the wall clock sets: histogram sums and
    buckets of measured round-trips keep only their counts."""
    return {"counters": dump["counters"], "gauges": dump["gauges"],
            "histograms": {k: v["count"]
                           for k, v in dump["histograms"].items()}}


def instrumented_batch(ns):
    eng = ns.E.Engine(workers=4, steal_n=4,
                      clock=ns.E.ManualClock(tick=1e-6))
    for i in range(200):
        eng.submit(f"t{i}", meta={"x": i})
    reg = ns.obs.instrument(engine=eng)
    assert ns.obs.instrument(reg, engine=eng) is reg
    rep = eng.run(lambda name, meta: (name != "t7", meta["x"] * 2))
    return (deterministic(reg.dump()),
            sorted((w, s["done"], s["alive"])
                   for w, s in eng.worker_stats().items()),
            eng.tasks_done_total(), sorted(rep.errors), eng.worker_pids(),
            eng.xfer_totals, eng.xfer_lost_total,
            type(eng.xfer_metrics).__name__)


def rpc_sampling(ns):
    tracer = ns.E.TraceRecorder(rpc_sample=4,
                                clock=ns.E.ManualClock(tick=1e-6))
    eng = ns.E.Engine(workers=4, steal_n=2, tracer=tracer)
    reg = ns.obs.instrument(engine=eng)
    for i in range(200):
        eng.submit(f"t{i}", meta={"x": i})
    ov = eng.run(lambda name, meta: (True, meta["x"])).overhead()
    return (len(tracer.of(ns.E.RPC)), tracer.rpc_seen, ov.n_rpc,
            deterministic(reg.dump()))


PROGRAMS = {"registry_ops": registry_ops,
            "instrumented_batch": instrumented_batch,
            "rpc_sampling": rpc_sampling}


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_registry_programs_observe_the_same(name):
    both(PROGRAMS[name])


# ------------------------------------------------------- stats endpoint


def get(url):
    with urllib.request.urlopen(url, timeout=T) as resp:
        return resp.read().decode(), resp.headers.get("Content-Type", "")


def keys_of(x):
    """The nested key structure of a JSON value, the values dropped (a
    list's length and a float's presence depend on the threads' timing)."""
    if isinstance(x, dict):
        return {k: keys_of(v) for k, v in x.items()}
    return "list" if isinstance(x, list) else "value"


def stats_endpoints(ns):
    eng = ns.E.Engine(workers=2, transport="thread", resident=True)
    eng.start()
    try:
        reg = ns.obs.instrument(engine=eng)
        with ns.obs.StatsServer(reg, engine=eng) as srv:
            eng.submit("root", fn=lambda: None)
            for i in range(20):
                eng.submit(f"t{i}", fn=lambda: None, deps=("root",))
            assert eng.drain(timeout=T)
            stats, ctype = get(srv.url + "/stats")
            stats = json.loads(stats)
            health, _ = get(srv.url + "/health")
            metrics, mtype = get(srv.url + "/metrics")
            try:
                get(srv.url + "/nope")
                missing = None
            except urllib.error.HTTPError as e:
                missing = e.code
    finally:
        eng.shutdown()
    families = sorted(line for line in metrics.splitlines()
                      if line.startswith("# TYPE"))
    # which worker ran what, and which runs were slow, are the threads'
    workers = stats.pop("workers")
    assert isinstance(stats["critical_path"].pop("stragglers"), list)
    return (keys_of(stats), stats["engine"]["tasks_done"],
            stats["engine"]["shard_ready_depth"],
            {w: sorted(row) for w, row in workers.items()},
            sum(row["done"] for row in workers.values()),
            stats["critical_path"]["path"][0], json.loads(health), families,
            ctype, mtype, missing)


def test_stats_server_endpoints_agree():
    out = both(stats_endpoints)
    assert out[1] == out[4] == 21 and out[5] == "root"
    assert out[6]["ok"] is True and out[-1] == 404


def start_stop(ns):
    srv = ns.obs.StatsServer(ns.obs.MetricsRegistry())
    same = srv.start() is srv and srv.start() is srv
    bound = srv.port != 0
    srv.stop()
    srv.stop()
    return same, bound, srv._httpd is None


def test_stats_server_start_stop_idempotent_agree():
    assert both(start_stop) == (True, True, True)


# ---------------------------------------------- traces, paths and text


def at(ns, tr, clock, t, event, task=None, worker=None, **extra):
    clock.now = t
    tr.emit(event, task=task, worker=worker, **extra)


def chain_trace(ns):
    """tests/test_critical_path.py's a -> b -> d on two workers, with side
    task s1 riding along, every stamp explicit."""
    E = ns.E
    clock = E.ManualClock()
    tr = E.TraceRecorder(clock=clock)
    for t, ev, task, w, extra in (
            (0.00, E.CREATED, "a", None, {}), (0.00, E.READY, "a", None, {}),
            (0.00, E.CREATED, "s1", None, {}),
            (0.00, E.READY, "s1", None, {}),
            (0.00, E.CREATED, "b", None, {"deps": ["a"]}),
            (0.00, E.CREATED, "d", None, {"deps": ["b"]}),
            (0.10, E.STOLEN, "a", "w0", {}), (0.10, E.STOLEN, "s1", "w1", {}),
            (0.20, E.RUN_START, "a", "w0", {}),
            (0.20, E.RUN_START, "s1", "w1", {}),
            (0.50, E.RUN_END, "s1", "w1", {}),
            (0.55, E.COMPLETED, "s1", "w1", {}),
            (1.20, E.RUN_END, "a", "w0", {}),
            (1.30, E.COMPLETED, "a", "w0", {}),
            (1.30, E.READY, "b", None, {}), (1.50, E.STOLEN, "b", "w1", {}),
            (1.60, E.RUN_START, "b", "w1", {}),
            (3.60, E.RUN_END, "b", "w1", {}),
            (3.70, E.COMPLETED, "b", "w1", {}),
            (3.70, E.READY, "d", None, {}), (3.80, E.STOLEN, "d", "w0", {}),
            (3.90, E.RUN_START, "d", "w0", {}),
            (4.40, E.RUN_END, "d", "w0", {}),
            (4.50, E.COMPLETED, "d", "w0", {})):
        at(ns, tr, clock, t, ev, task, w, **extra)
    return tr


def retry_trace(ns):
    E = ns.E
    clock = E.ManualClock()
    tr = E.TraceRecorder(clock=clock)
    for t, ev, w, extra in ((0.00, E.CREATED, None, {}),
                            (0.00, E.READY, None, {}),
                            (0.10, E.STOLEN, "w0", {}),
                            (0.20, E.RUN_START, "w0", {}),
                            (0.60, E.RUN_END, "w0", {}),
                            (0.65, E.RETRIED, None, {"attempt": 1}),
                            (0.70, E.STOLEN, "w1", {}),
                            (0.80, E.RUN_START, "w1", {}),
                            (1.00, E.RUN_END, "w1", {}),
                            (1.05, E.COMPLETED, "w1", {})):
        at(ns, tr, clock, t, ev, "r", w, **extra)
    tr.emit(E.RPC, op="complete_steal", dt=2e-3)
    tr.emit(E.RPC, op="hop:L1", dt=1e-3)
    return tr


def serving_trace(ns):
    """Worker spans, rpc and hop lanes, and serving requests: one inside
    the retained window, one older than it, one unstamped."""
    E = ns.E
    clock = E.ManualClock()
    tr = E.TraceRecorder(clock=clock)
    clock.advance(1.0)
    tr.emit(E.RUN_START, task="a", worker="w0")
    clock.advance(0.5)
    tr.emit(E.RUN_END, task="a", worker="w0")
    tr.emit(E.RPC, op="complete_steal", dt=1e-3, n=4)
    tr.emit(E.RPC, op="hop:L1", dt=5e-4)
    tr.emit(E.REQ_ENQUEUED, task="r6", depth=0)
    clock.advance(0.1)
    tr.emit(E.BATCH_FORMED, task="__batch0", size=1, wait_s=1e-3, depth=0)
    tr.emit(E.REQ_DONE, task="r6", latency_s=0.1, ok=True)
    tr.emit(E.REQ_DONE, task="r9", latency_s=0.25, ok=True)
    tr.emit(E.REQ_DONE, task="r7", latency_s=3.0, ok=True)
    tr.emit(E.REQ_DONE, task="r8")
    return tr


TRACES = {"chain": chain_trace, "retry": retry_trace,
          "serving": serving_trace}


def chrome(ns, which):
    tr = TRACES[which](ns)
    cp = ns.obs.CriticalPathReport.from_trace(tr, workers=2)
    return (ns.obs.to_chrome_trace(tr), tr.to_chrome_trace(),
            tr.to_chrome_trace(critical_path=cp.path))


@pytest.mark.parametrize("which", sorted(TRACES))
def test_chrome_trace_of_the_same_log_agrees(which):
    """`to_chrome_trace` and `TraceRecorder.to_chrome_trace`, with and
    without the critical-path lane, on one event log."""
    docs = both(chrome, which)
    assert docs[0] == docs[1] and docs[0]["traceEvents"]


def report_of(rep, max_tasks=None):
    return (rep.path, rep.segments, rep.summary(max_tasks=max_tasks),
            rep.makespan_s, rep.sched_s, rep.run_s, rep.compute_s,
            rep.idle_gaps, rep.profile, rep.stragglers, rep.rpc_by_op)


def critical_paths(ns, which):
    tr = TRACES[which](ns)
    CP = ns.obs.CriticalPathReport
    out = [report_of(CP.from_trace(tr, workers=2)),
           report_of(CP.from_trace(tr, workers=2, straggler_factor=2.0),
                     max_tasks=2),
           report_of(tr.report(workers=2).explain())]
    events = list(tr.events)
    for e in events:
        if e.event == ns.E.CREATED:
            e.extra.pop("deps", None)
    out.append(report_of(CP.from_events(events, workers=2)))
    out.append(report_of(CP.from_events(
        events, deps={"b": ("a",), "d": ("b",)}, workers=2)))
    return out


@pytest.mark.parametrize("which", sorted(TRACES))
def test_critical_path_reports_agree(which):
    """`CriticalPathReport.from_trace` / `from_events` (explicit dep table,
    straggler factor, truncated summary) and `OverheadReport.explain()`:
    the same path and the same segments."""
    out = both(critical_paths, which)
    if which == "chain":
        assert out[0][0] == ["a", "b", "d"] and out[3][0] == ["d"]
        assert out[4][0] == ["a", "b", "d"]


def rendered(ns):
    texts = []
    for make in TRACES.values():
        rep = ns.obs.CriticalPathReport.from_trace(make(ns), workers=2)
        texts.append(ns.explain.render(rep))
        texts.append(ns.explain.render(rep, max_tasks=1))
    empty = ns.E.TraceRecorder(clock=ns.E.ManualClock())
    texts.append(ns.explain.render(
        ns.obs.CriticalPathReport.from_trace(empty)))
    return texts


def test_explain_render_agrees():
    texts = both(rendered)
    assert "critical path" in texts[0] and "scheduler" in texts[0]


STATS = {
    "engine": {"live_workers": 2, "worker_deaths": 1, "tasks_done": 40,
               "tasks_failed": 1, "tasks_retried": 2, "journal_bytes": 512,
               "ready_depth": 3, "shard_ready_depth": [1, 2],
               "trace": {"n_emitted": 321, "dropped": 0, "rpc_seen": 88}},
    "rates": {"tasks_per_s": 1234.5, "window_s": 0.25},
    "workers": {"w0": {"done": 25, "busy_s": 0.5, "alive": True,
                       "busy_frac": 0.75},
                "w1": {"done": 15, "busy_s": 0.25, "alive": False}},
    "serving": [{"n_requests": 10, "n_failed": 0,
                 "latency_ms": {"p50": 1.5, "p95": 2.5, "p99": 3.5}}],
}


def top_text(ns):
    cp = ns.obs.CriticalPathReport.from_trace(chain_trace(ns), workers=2)
    return (ns.top.render(STATS),
            ns.top.render(dict(STATS, critical_path=cp.summary(16))),
            ns.top.render(dict(STATS, critical_path={"skipped": "too big"})),
            ns.top.render({}))


def test_top_render_agrees():
    texts = both(top_text)
    assert "WORKER" in texts[0] and "critical path:" in texts[1]


def saved_loaded(ns, other, tmp):
    """A trace saved by one side's recorder and loaded by the other's."""
    path = tmp / f"{id(ns)}.trace.jsonl"
    tr = chain_trace(ns)
    n = tr.save(str(path))
    back = other.E.TraceRecorder.load(str(path))
    return n, report_of(other.obs.CriticalPathReport.from_trace(
        back, workers=2))


def test_saved_traces_load_on_the_other_side(tmp_path):
    a = saved_loaded(SIDES["jax"], SIDES["port"], tmp_path)
    b = saved_loaded(SIDES["port"], SIDES["jax"], tmp_path)
    assert a == b and a[1][0] == ["a", "b", "d"]


@pytest.mark.parametrize("flags", [[], ["--json"],
                                   ["--json", "--max-tasks", "2"]])
def test_port_explain_cli_reads_a_jax_trace(tmp_path, flags):
    """`python -m repro_torch.core.obs.explain` on a trace JAX's recorder
    saved prints what JAX's CLI prints, and writes the same Chrome trace."""
    path = tmp_path / "run.trace.jsonl"
    chain_trace(SIDES["jax"]).save(str(path))
    argv = [str(path), "--workers", "2", *flags]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert jax_explain.main(argv + ["--chrome",
                                        str(tmp_path / "jax.json")]) == 0
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    done = subprocess.run(
        [sys.executable, "-m", "repro_torch.core.obs.explain", *argv,
         "--chrome", str(tmp_path / "port.json")],
        capture_output=True, text=True, env=env, timeout=120)
    assert done.returncode == 0, done.stderr
    assert done.stdout == buf.getvalue()
    assert json.loads((tmp_path / "port.json").read_text()) == \
        json.loads((tmp_path / "jax.json").read_text())


# ------------------------------------------------- the serve entry point


def test_launch_serve_writes_a_loadable_trace(tmp_path):
    """`python -m repro_torch.launch.serve --device cpu --stats-port 0
    --trace-out <tmp>`: the stats server comes up while requests run, and
    the Chrome trace has one task span a batch and one request span a
    request, and an explain that names every batch."""
    out = tmp_path / "serve.trace.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    done = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--requests", "3", "--prompt-len", "8", "--max-new", "3",
         "--stats-port", "0", "--trace-out", str(out)],
        capture_output=True, text=True, env=env, timeout=600)
    assert done.returncode == 0, done.stderr
    assert "[serve] live stats at http://127.0.0.1:" in done.stdout
    assert "python -m repro_torch.core.obs.top --url" in done.stdout
    assert f"[serve] Chrome trace written to {out}" in done.stdout
    doc = json.loads(out.read_text())
    evs = doc["traceEvents"]
    tasks = [e for e in evs if e["ph"] == "X" and e.get("cat") == "task"]
    begins = [e["id"] for e in evs if e["ph"] == "b"]
    ends = [e["id"] for e in evs if e["ph"] == "e"]
    assert len(tasks) == 3 and len(begins) == 3
    assert sorted(begins) == sorted(ends)


def test_serve_main_returns_its_trace(capsys):
    """`serve.main` hands back the session's TraceRecorder: its explain()
    path, chained in run order, names every batch, and its attribution sums
    to the makespan."""
    from repro_torch.launch import serve
    res = serve.main(["--device", "cpu", "--requests", "2", "--prompt-len",
                      "8", "--max-new", "2", "--stats-port", "0"])
    assert "[serve] live stats at" in capsys.readouterr().out
    trace = res["trace"]
    order = [e.task for e in trace.of(port_engine.RUN_START)]
    cp = trace.report(workers=1).explain(
        deps={b: (a,) for a, b in zip(order, order[1:])})
    batches = [e.task for e in trace.of(port_engine.BATCH_FORMED)]
    assert sorted(cp.path) == sorted(batches) and len(batches) == 2
    assert abs(cp.sched_s + cp.run_s - cp.makespan_s) \
        <= 0.05 * cp.makespan_s


def test_live_stats_scrape_while_serving():
    """`Client.stats_server()` answers while a frontend serves; its
    repro_tasks_completed_total never decreases across scrapes."""
    import repro_torch.client as port_client
    seen, stop = [], threading.Event()
    with port_client.Client(workers=1) as c:
        srv = c.stats_server()
        fe = c.serve(lambda ps: [time.sleep(0.01) or p for p in ps],
                     max_wait_s=0.001)

        def scrape():
            while not stop.is_set():
                body, _ = get(srv.url + "/metrics")
                seen.append(next(float(line.split()[1])
                                 for line in body.splitlines()
                                 if line.startswith(
                                     "repro_tasks_completed_total ")))
                stop.wait(0.01)

        t = threading.Thread(target=scrape)
        t.start()
        reqs = [fe.submit(i) for i in range(20)]
        assert all(r.wait(T) and r.ok for r in reqs)
        time.sleep(0.05)
        stop.set()
        t.join()
    assert len(seen) >= 3 and seen == sorted(seen) and seen[-1] >= 1
