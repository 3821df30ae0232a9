"""Port parity for the unified engine: the same DAGs, fault plans and
journals through the JAX package's `Engine` and the port's.

Under the inproc transport with a `ManualClock` the engine is
deterministic, so both sides must agree on the completed and failed sets,
on every task's lifecycle (the trace's events in order, with the worker
that saw them) and on the backend's stats.  RPC events carry real
round-trip times, so they are compared by count per op.  The journal is
the engine's durable state: each side's journal replays under the other's
`Journal.replay` to an equal `JournalState`, and each side's
`Engine.recover` finishes a run the other side's engine crashed."""
import dataclasses
import random
from collections import Counter

import pytest

import repro.core.engine as jax_engine
import repro_torch.core.engine as port_engine

SIDES = {"jax": jax_engine, "port": port_engine}


def run_record(rep, eng=None):
    """An EngineReport as comparable data."""
    tr = rep.trace
    lifecycle = [(e.event, e.task, e.worker,
                  {k: v for k, v in (e.extra or {}).items()
                   if k not in ("dt", "t_rpc")})
                 for e in tr.events if e.event != "rpc"]
    rpcs = Counter(e.extra.get("op") for e in tr.events if e.event == "rpc")
    values = {n: r.value for n, r in sorted(rep.results.items())
              if r.ok and isinstance(r.value, (int, float, str, type(None)))}
    return {"completed": sorted(rep.completed), "errors": sorted(rep.errors),
            "stalled": rep.stalled, "lifecycle": lifecycle,
            "rpcs": dict(rpcs), "backend_stats": rep.backend_stats,
            "values": values, "workers": rep.workers,
            "retries": getattr(eng, "retries_total", None),
            "deaths": getattr(eng, "worker_deaths", None)}


def diamond(E, n, **kw):
    eng = E.Engine(transport="inproc", clock=E.ManualClock(tick=1e-6), **kw)
    mids = [f"mid{i}" for i in range(n - 2)]
    eng.submit("root", fn=lambda: 0)
    for i, m in enumerate(mids):
        eng.submit(m, fn=lambda i=i: i, deps=["root"])
    eng.submit("sink", fn=lambda: "done", deps=mids)
    return eng


def chains(E, n=48, width=6, **kw):
    eng = E.Engine(transport="inproc", clock=E.ManualClock(tick=1e-6), **kw)
    for i in range(n):
        deps = [f"t{i - width}"] if i >= width else []
        eng.submit(f"t{i}", fn=lambda i=i: i * i, deps=deps,
                   priority=float(i % 5), meta={"i": i})
    return eng


CASES = {
    "diamond_clean": lambda E: diamond(E, 200, workers=4, steal_n=8),
    "diamond_dead_worker": lambda E: diamond(
        E, 400, workers=4, steal_n=8,
        faults=E.FaultPlan(seed=7).kill_worker("w2", after_steals=40)),
    "diamond_failed_mid": lambda E: diamond(
        E, 200, workers=4, steal_n=8,
        faults=E.FaultPlan(seed=7).fail_task("mid50")),
    "chains_fail_rate": lambda E: chains(
        E, workers=3, steal_n=2, faults=E.FaultPlan(seed=5).fail_rate(0.1)),
    "chains_silent_death_lease": lambda E: chains(
        E, workers=2, steal_n=2, lease_timeout=0.05,
        faults=E.FaultPlan(seed=3).kill_worker("w1", after_steals=2,
                                               silent=True)),
    "chains_stragglers": lambda E: chains(
        E, workers=4, steal_n=1, faults=E.FaultPlan(seed=42).stragglers(1e-3)),
    "chains_retry_transient": lambda E: chains(
        E, workers=2, steal_n=4,
        faults=E.FaultPlan(seed=9).fail_first_k(1, rate=0.3),
        retry=E.RetryPolicy(max_attempts=3, backoff=0.0)),
    "chains_retry_exhausted": lambda E: chains(
        E, workers=2, steal_n=4, faults=E.FaultPlan(seed=9).fail_first_k(2),
        retry=E.RetryPolicy(max_attempts=2)),
    "chains_sharded": lambda E: chains(E, workers=4, shards=3, steal_n=2),
    "all_workers_dead_stall": lambda E: chains(
        E, workers=2, steal_n=2, max_idle_rounds=30,
        faults=E.FaultPlan(seed=1).kill_worker("w0", after_steals=1)
        .kill_worker("w1", after_steals=1)),
    "pmake_slots_priority": lambda E: chains(E, workers=2, steal_n=64),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_same_dag_same_run(case):
    recs = {}
    for side, E in SIDES.items():
        eng = CASES[case](E)
        recs[side] = run_record(eng.run(), eng)
    assert recs["port"] == recs["jax"]
    rec = recs["port"]
    if case == "diamond_dead_worker":
        assert len(rec["completed"]) == 400 and rec["deaths"] == 1
    if case == "diamond_failed_mid":
        assert rec["errors"] == ["mid50", "sink"]
    if case == "all_workers_dead_stall":
        assert rec["stalled"]
    if case == "chains_retry_exhausted":
        assert rec["errors"] and rec["retries"] > 0


def test_fault_plans_draw_the_same():
    names = [f"task{i}" for i in range(500)]
    for seed in (0, 1, 17):
        jp = jax_engine.FaultPlan(seed).fail_rate(0.2).stragglers(0.01)
        pp = port_engine.FaultPlan(seed).fail_rate(0.2).stragglers(0.01)
        assert [pp.force_fail(n) for n in names] == \
            [jp.force_fail(n) for n in names]
        assert [pp.delay_s(n) for n in names] == \
            [jp.delay_s(n) for n in names]
        jk = jax_engine.FaultPlan(seed).fail_first_k(2, rate=0.5)
        pk = port_engine.FaultPlan(seed).fail_first_k(2, rate=0.5)
        assert [[pk.force_fail(n, attempt=a) for a in range(3)]
                for n in names] == [[jk.force_fail(n, attempt=a)
                                     for a in range(3)] for n in names]
    jr = jax_engine.RetryPolicy(max_attempts=4, backoff=0.1, jitter=0.5,
                                seed=7)
    pr = port_engine.RetryPolicy(max_attempts=4, backoff=0.1, jitter=0.5,
                                 seed=7)
    assert [pr.delay_s(n, k) for n in names[:20] for k in (1, 2, 3)] == \
        [jr.delay_s(n, k) for n in names[:20] for k in (1, 2, 3)]


def test_thread_transport_completes_the_same_sets():
    """Threads are not deterministic in order; the sets and counts are."""
    out = {}
    for side, E in SIDES.items():
        eng = E.Engine(workers=3, transport="thread", steal_n=2,
                       faults=E.FaultPlan(seed=5).kill_worker(
                           "w1", after_steals=3), poll=0.002)
        for i in range(24):
            eng.submit(f"t{i}", fn=lambda i=i: i, deps=[f"t{i - 4}"]
                       if i >= 4 else ())
        rep = eng.run()
        out[side] = (sorted(rep.completed), rep.stalled,
                     rep.backend_stats["completed"],
                     rep.backend_stats["assigned"],
                     {n: r.value for n, r in rep.results.items()})
    assert out["port"] == out["jax"]
    assert len(out["port"][0]) == 24


def test_resident_engine_same_results():
    out = {}
    for side, E in SIDES.items():
        fired = []
        eng = E.Engine(workers=2, resident=True, steal_n=2,
                       clock=E.ManualClock(tick=1e-6),
                       on_result=lambda n, ok, res, err:
                       fired.append((n, ok, err)))
        eng.start()
        for i in range(30):
            eng.submit(f"r{i}", fn=lambda i=i: i, deps=[f"r{i - 3}"]
                       if i >= 3 and i % 7 else ())
        eng.submit("bad", fn=lambda: 1 / 0)
        eng.submit("kid", fn=lambda: 1, deps=["bad"])
        assert eng.drain(10.0)
        rep = eng.shutdown()
        out[side] = (sorted(fired), sorted(rep.completed),
                     sorted(rep.errors), rep.backend_stats)
    assert out["port"] == out["jax"]
    assert any(n == "kid" and not ok for n, ok, _ in out["port"][0])


# ----------------------------------------------------------------- journal


def journal_state(st):
    d = dataclasses.asdict(st)
    d["created"] = {n: (list(deps), meta)
                    for n, (deps, meta) in st.created.items()}
    d["pending"] = [(n, list(deps), meta) for n, deps, meta in st.pending()]
    return d


def write_journal(E, jdir):
    """A run with completions, failures, poison, a cancel and a requeue,
    journalled; then a checkpoint and a few more records."""
    eng = E.Engine(workers=2, transport="inproc", steal_n=2,
                   clock=E.ManualClock(tick=1e-6), journal=str(jdir),
                   faults=E.FaultPlan(seed=4).kill_worker("w1",
                                                          after_steals=3))
    for i in range(20):
        eng.submit(f"t{i}", fn=lambda i=i: i, deps=[f"t{i - 5}"]
                   if i >= 5 else (), meta={"i": i, "tag": "x" * (i % 3)})
    eng.submit("bad", fn=lambda: 1 / 0)
    eng.submit("kid", fn=lambda: 0, deps=["bad"])
    rep = eng.run()
    j = E.Journal(jdir, sync_every=1)
    j.append_create("late", ("t0",), {"k": [1, 2]})
    j.append_create("gone", (), {})
    j.append_cancel("gone")
    j.checkpoint()
    j.append_create("after", ("late",), {})
    j.append_requeue(3, "lease")
    j.close()
    return rep


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_journal_replays_the_same_both_ways(tmp_path, writer):
    write_journal(SIDES[writer], tmp_path)
    states = {side: journal_state(E.Journal.replay(tmp_path))
              for side, E in SIDES.items()}
    assert states["port"] == states["jax"]
    st = states["port"]
    assert "bad" in st["failed"] and "kid" in st["failed"]
    assert st["cancelled"] == {"gone"} and st["requeues"] >= 3
    assert [n for n, _, _ in st["pending"]] == ["late", "after"]


def test_journal_files_are_the_same_bytes(tmp_path):
    for side, E in SIDES.items():
        write_journal(E, tmp_path / side)
    files = {side: sorted(p.name for p in (tmp_path / side).iterdir())
             for side in SIDES}
    assert files["port"] == files["jax"]
    for name in files["port"]:
        assert (tmp_path / "port" / name).read_bytes() == \
            (tmp_path / "jax" / name).read_bytes(), name


@pytest.mark.parametrize("crashed,recovers", [("jax", "port"),
                                              ("port", "jax"),
                                              ("port", "port")])
def test_recover_from_the_other_sides_journal(tmp_path, crashed, recovers):
    """Phase 1 crashes mid-DAG on one side (every worker dies); the other
    side's `Engine.recover` re-runs exactly the unfinished tasks."""
    n, jdir = 24, str(tmp_path / "j")
    ran1, ran2 = [], []
    C, R = SIDES[crashed], SIDES[recovers]
    eng = C.Engine(workers=2, transport="inproc", journal=jdir,
                   max_idle_rounds=50,
                   faults=C.FaultPlan(seed=2).kill_worker("w0", after_steals=3)
                   .kill_worker("w1", after_steals=3))
    for i in range(n):
        eng.submit(f"t{i}", deps=[f"t{i - 1}"] if i % 4 else [],
                   meta={"i": i})
    rep1 = eng.run(lambda name, meta: ran1.append(name) or True)
    assert rep1.stalled and 0 < len(rep1.completed) < n
    eng2 = R.Engine.recover(jdir, workers=2, transport="inproc")
    rep2 = eng2.run(lambda name, meta: ran2.append(name) or True)
    assert not rep2.stalled
    assert set(ran2) == {f"t{i}" for i in range(n)} - set(rep1.completed)
    assert not set(ran2) & set(ran1)
    for E in SIDES.values():
        st = E.Journal.replay(jdir)
        assert len(st.completed) == n and not st.pending()


def test_recover_poisons_and_stays_exactly_once(tmp_path):
    out = {}
    for side, E in SIDES.items():
        jdir = tmp_path / side
        j = E.Journal(jdir, sync_every=1)
        for name, deps in [("a", ()), ("bad", ()), ("child", ("bad",)),
                           ("b", ("a",)), ("c", ("b",))]:
            j.append_create(name, deps, {})
        j.append_terminal("a", True)
        j.append_terminal("bad", False, "died before the crash")
        j.close()
        other = SIDES["jax" if side == "port" else "port"]
        ran, fired = [], []
        eng = other.Engine.recover(str(jdir), workers=1, transport="inproc",
                                   on_result=lambda n, ok, r, e:
                                   fired.append((n, ok)))
        rep = eng.run(lambda name, meta: ran.append(name) or True)
        out[side] = (ran, sorted(fired), sorted(rep.completed),
                     journal_state(E.Journal.replay(jdir))["failed"])
    assert out["port"] == out["jax"]
    ran, fired, completed, failed = out["port"]
    assert ran == ["b", "c"] and ("a", True) not in fired
    assert "dependency bad failed" in failed["child"]


def test_trace_analysis_agrees():
    """OverheadReport, LatencyReport and crosscheck on one synthetic
    trace, computed by both packages."""
    rng = random.Random(0)
    out = {}
    for side, E in SIDES.items():
        clk = E.ManualClock(tick=0.0)
        tr = E.TraceRecorder(clock=clk)
        for i in range(50):
            t = f"t{i}"
            tr.emit(E.CREATED, task=t)
            for ev in (E.READY, E.STOLEN, E.RUN_START, E.RUN_END,
                       E.COMPLETED):
                clk.advance(1e-4 * (1 + (i * 7 + len(ev)) % 5))
                tr.emit(ev, task=t, worker=f"w{i % 3}")
            tr.emit(E.RPC, op="steal", dt=2e-5)
        for i in range(10):
            tr.emit(E.REQ_ENQUEUED, task=f"q{i}", depth=i)
            tr.emit(E.REQ_DONE, task=f"q{i}", latency_s=1e-3 * (i + 1),
                    ok=i != 4)
        tr.emit(E.BATCH_FORMED, task="b", size=10, wait_s=1e-3, depth=0)
        rep = tr.report(workers=3)
        out[side] = (rep.summary(), tr.latency_report().summary(),
                     E.crosscheck("dwork", rep.per_task_overhead_s, 1e-4),
                     [E.percentile(sorted(rng.random() for _ in range(9)),
                                   q) for q in (0.0, 0.5, 0.99)])
        rng.seed(0)
    assert out["port"] == out["jax"]


def test_obs_paths_agree():
    """`TraceRecorder.to_chrome_trace()` and `OverheadReport.explain()`
    on the same inproc run under a ManualClock, computed by both
    packages; explain() without a trace raises ValueError on both."""
    out = {}
    for side, E in SIDES.items():
        rep = chains(E, workers=3, steal_n=2).run()
        doc = rep.trace.to_chrome_trace()
        lanes = sorted(e["args"]["name"] for e in doc["traceEvents"]
                       if e["ph"] == "M" and e["name"] == "thread_name")
        spans = [(e["name"], e["tid"], e["ts"], e["dur"])
                 for e in doc["traceEvents"] if e.get("cat") == "task"]
        cp = rep.overhead().explain()
        with pytest.raises(ValueError):
            E.OverheadReport().explain()
        # the rpc fold and the METG-law ideal read wall-clock round trips
        summ = {k: v for k, v in cp.summary().items()
                if k not in ("rpc", "concurrency")}
        out[side] = (lanes, spans, cp.path, cp.segments, summ,
                     cp.concurrency_mean, cp.concurrency_peak)
    assert out["port"] == out["jax"]
    assert len(out["port"][1]) == 48 and out["port"][2]


def test_engine_kwargs_of_the_port_exist_in_the_reference():
    import inspect
    port = set(inspect.signature(port_engine.Engine).parameters)
    jax = set(inspect.signature(jax_engine.Engine).parameters)
    assert port <= jax
    assert jax - port == {"proc_host", "proc_port", "heartbeat_s",
                          "inline_bytes", "spill_bytes"}
