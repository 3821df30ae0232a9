"""Port parity for the futures front door: the programs of
tests/test_client.py, run through the JAX package's `Client` and the
port's, for the three schedulers.

Each program takes a side (the names it needs from one package) and
returns what it observed: values, exception type names, whether futures
were cancelled, poisoned or pruned.  Both sides must observe the same,
and each program asserts the reference's expectations on its own side.
Every wait is bounded (`result(timeout=...)`, `gather(timeout=...)`)."""
import threading
import time
from types import SimpleNamespace

import pytest

import repro.client as jax_client
import repro.core.dwork as jax_dwork
import repro.core.engine as jax_engine
import repro.core.engine.executor as jax_executor
from repro.core.dwork.sharded import ShardedHub as JaxHub
import repro_torch.client as port_client
import repro_torch.core.dwork as port_dwork
import repro_torch.core.engine as port_engine
import repro_torch.core.engine.executor as port_executor
from repro_torch.core.dwork.sharded import ShardedHub as PortHub

T = 10.0          # every wait is bounded by this many seconds


def side(client, dwork, engine, hub):
    return SimpleNamespace(
        Client=client.Client, CancelledError=client.CancelledError,
        DependencyFailed=client.DependencyFailed,
        TaskFailed=client.TaskFailed, as_completed=client.as_completed,
        SCHEDULERS=client.SCHEDULERS, TaskServer=dwork.TaskServer,
        DworkClient=dwork.Client, InProcTransport=dwork.InProcTransport,
        Engine=engine.Engine, FaultPlan=engine.FaultPlan,
        TraceRecorder=engine.TraceRecorder, WorkerCrash=engine.WorkerCrash,
        CANCELLED=engine.CANCELLED, RetryPolicy=engine.RetryPolicy,
        ManualClock=engine.ManualClock, ShardedHub=hub)


SIDES = {"jax": side(jax_client, jax_dwork, jax_engine, JaxHub),
         "port": side(port_client, port_dwork, port_engine, PortHub)}


def outcome(fut):
    """A resolved future as comparable data."""
    if fut.cancelled():
        return ("cancelled",)
    exc = fut.exception(T)
    if exc is not None:
        return ("raised", type(exc).__name__)
    return ("ok", fut.result(T))


def snippet(ns, scheduler):
    xs = list(range(40))
    with ns.Client(scheduler=scheduler) as c:
        fs = [c.submit(lambda x=x: x * x) for x in xs]
        vals = c.gather(fs, timeout=T)
        assert vals == [x * x for x in xs]
        ov = c.report()
        assert ov.n_tasks == len(xs) and ov.per_task_overhead_s >= 0.0
        # rank blocks through map, as mpi_list adapters use it
        blocks = [list(range(p * 5, (p + 1) * 5)) for p in range(4)]
        done = c.map(lambda blk: [y * 2 for y in blk], blocks)
        flat = [y for blk in c.gather(done, timeout=T) for y in blk]
        assert flat == [2 * y for y in range(20)]
        return vals, flat, ov.n_tasks, c.engine.steal_n


def dynamic_dag(ns):
    with ns.Client(workers=2) as c:
        a = c.submit(lambda: 3)
        b = c.submit(lambda v: v + 4, a)
        d = c.submit(lambda v, w=0: v * w, a, w=b)
        tail = c.submit(sum, c.submit(lambda: [1, 2, 3]))
        assert d.result(T) == 21 and tail.result(T) == 6
        assert c.engine.tasks[b.name].deps == (a.name,)
        return d.result(T), tail.result(T)


def map_and_ordering(ns):
    with ns.Client(workers=4) as c:
        order = []
        first = c.submit(lambda: order.append("first"))
        fs = c.map(lambda x, y: x + y, range(10), range(10))
        gated = c.submit(lambda: order.append("second"), deps=[first])
        vals = c.gather(fs, timeout=T)
        gated.result(T)
        assert vals == [2 * i for i in range(10)]
        assert order == ["first", "second"]
        return vals, order


def failure_taxonomy(ns):
    with ns.Client(workers=2) as c:
        bad = c.submit(lambda: 1 / 0)
        down = c.submit(lambda v: v + 1, bad)
        deeper = c.submit(lambda v: v + 1, down)
        with pytest.raises(ZeroDivisionError):
            bad.result(T)
        for f in (down, deeper):
            with pytest.raises(ns.DependencyFailed):
                f.result(T)
        return [outcome(f) for f in (bad, down, deeper)]


def gather_mixed(ns):
    with ns.Client(workers=2) as c:
        ok1 = c.submit(lambda: 1)
        bad = c.submit(lambda: (_ for _ in ()).throw(ValueError("boom")))
        ok2 = c.submit(lambda: 2)
        down = c.submit(lambda v: v, bad)
        fs = [ok1, bad, ok2, down]
        with pytest.raises(ValueError, match="boom"):
            c.gather(fs, timeout=T)
        out = c.gather(fs, timeout=T, return_exceptions=True)
        assert out[0] == 1 and out[2] == 2
        assert isinstance(out[1], ValueError)
        assert isinstance(out[3], ns.DependencyFailed)
        return [x if isinstance(x, int) else type(x).__name__ for x in out]


def fail_fast(ns):
    with ns.Client(workers=1) as c:
        bad = c.submit(lambda: 1 / 0)
        with pytest.raises(ZeroDivisionError):
            bad.result(T)
        late = c.submit(lambda v: v, bad)
        with pytest.raises(ns.DependencyFailed):
            late.result(T)
        return outcome(late)


def cancel_unstolen(ns):
    c = ns.Client(workers=1)
    a = c.submit(lambda: 1)
    b = c.submit(lambda v: v + 1, a)
    down = c.submit(lambda v: v * 2, b)
    assert b.cancel() is True
    assert b.cancelled() and b.done()
    with pytest.raises(ns.CancelledError):
        b.result(1)
    assert c.engine.tracer.count(ns.CANCELLED) == 1
    with c:
        assert a.result(T) == 1
        with pytest.raises(ns.DependencyFailed):
            down.result(T)
    assert a.cancel() is False and b.cancel() is False
    return [outcome(f) for f in (a, b, down)]


def cancel_leased(ns):
    release = threading.Event()
    with ns.Client(workers=1, transport="thread") as c:
        running = c.submit(release.wait, 5)
        deadline = time.monotonic() + 5
        while c.engine.backend.server.lease == {} \
                and time.monotonic() < deadline:
            time.sleep(0.001)
        refused = running.cancel()
        release.set()
        assert refused is False and running.result(T) is True
        return refused, running.result(T)


def result_timeout(ns):
    with ns.Client(workers=1, transport="thread") as c:
        gate = threading.Event()
        slow = c.submit(gate.wait, 5)
        with pytest.raises(TimeoutError):
            slow.result(timeout=0.05)
        pending = slow.done()
        with pytest.raises(TimeoutError):
            list(ns.as_completed([slow], timeout=0.05))
        gate.set()
        assert slow.result(T) is True
    with ns.Client(workers=1) as c:
        fs = [c.submit(lambda x=x: x) for x in range(10)]
        got = sorted(f.result() for f in ns.as_completed(fs, timeout=T))
    return pending, got


def seeded_kill(ns):
    faults = ns.FaultPlan(seed=11).kill_worker("w1", after_steals=8)
    resolutions = {}
    with ns.Client(workers=4, steal_n=4, faults=faults) as c:
        flat = [c.submit(lambda x=x: x * 3, key=f"f{x}") for x in range(150)]
        chain = [c.submit(lambda: 0, key="h")]
        for i in range(15):
            chain.append(c.submit(lambda v: v + 1, chain[-1], key=f"c{i}"))
        for f in flat + chain:
            f.add_done_callback(lambda fu: resolutions.__setitem__(
                fu.name, resolutions.get(fu.name, 0) + 1))
        vals = c.gather(flat, timeout=T)
        last = chain[-1].result(T)
        ov = c.report()
        assert vals == [x * 3 for x in range(150)] and last == 15
        assert ov.n_requeued > 0 and ov.n_tasks == 166
    assert set(resolutions.values()) == {1} and len(resolutions) == 166
    stats = c.close().backend_stats
    return last, ov.n_requeued, ov.n_tasks, stats


def batch_mode(ns):
    c = ns.Client(resident=False, workers=2, steal_n=2)
    fs = [c.submit(lambda x=x: x + 1) for x in range(30)]
    bad = c.submit(lambda: 1 / 0)
    down = c.submit(lambda v: v, bad)
    vals = c.gather(fs)
    assert vals == [x + 1 for x in range(30)]
    assert isinstance(bad.exception(), ZeroDivisionError)
    with pytest.raises(ns.DependencyFailed):
        down.result()
    rep = c.run()
    assert len(rep.completed) == 30
    with pytest.raises(RuntimeError, match="one-shot"):
        c.submit(lambda: 2)
    c.close()
    return vals, outcome(bad), outcome(down), sorted(rep.errors) != [], \
        rep.backend_stats


def ring_and_no_history(ns):
    tr = ns.TraceRecorder(max_events=100)
    for i in range(500):
        tr.emit("x", task=f"t{i}")
    assert (len(tr.events), tr.dropped, tr.n_emitted) == (100, 400, 500)
    with ns.Client(workers=2, max_trace_events=64, keep_results=False) as c:
        fs = [c.submit(lambda x=x: x) for x in range(100)]
        vals = c.gather(fs, timeout=T)
        assert len(c.engine.tracer.events) <= 64 and c.engine.tracer.dropped
    assert c.close().results == {}
    return vals, tr.events[0].task, tr.events[-1].task


def prune_resolved_dep(ns):
    with ns.Client(workers=2) as c:
        a = c.submit(lambda: 21)
        assert a.result(T) == 21
        c.drain(T)
        c.prune()
        b = c.submit(lambda v: v * 2, a)
        first = b.result(T)
    with ns.Client(workers=2) as c:
        bad = c.submit(lambda: 1 / 0)
        with pytest.raises(ZeroDivisionError):
            bad.result(T)
        c.drain(T)
        c.prune()
        late = c.submit(lambda v: v, bad)
        gated = c.submit_task("gated-after-prune", deps=[bad])
        return first, outcome(late), outcome(gated)


def prune_name_dep(ns):
    done = []
    with ns.Client(workers=1, prune_every=1,
                   executor=lambda n, m: done.append(n) or True) as c:
        a = c.submit_task("A")
        assert a.exception(T) is None
        c.drain(T)
        c.prune()
        b = c.submit_task("B", deps=["A"])
        assert b.exception(T) is None
        assert done.count("A") == 1
        return outcome(a), outcome(b), done


def prune_every_bounded(ns):
    with ns.Client(workers=2, prune_every=10, keep_results=False) as c:
        fs = [c.submit(lambda x=x: x) for x in range(60)]
        vals = c.gather(fs, timeout=T)
        c.prune()
        assert len(c.engine.tasks) < 60
        assert len(c.engine.backend.server.joins) < 60
        return vals


def prune_poisoned_waiting(ns):
    gate = threading.Event()
    with ns.Client(workers=2, transport="thread", prune_every=1) as c:
        bad = c.submit(lambda: 1 / 0, key="A")
        slow = c.submit(lambda: gate.wait(5), key="C")
        dep = c.submit(lambda a, s: None, bad, slow, key="B")
        with pytest.raises(ZeroDivisionError):
            bad.result(T)
        c.prune()
        gate.set()
        assert slow.result(T) is True
        with pytest.raises(ns.DependencyFailed):
            dep.result(T)
        return [outcome(f) for f in (bad, slow, dep)]


def lifecycle(ns):
    with ns.Client(workers=1) as c:
        f1 = c.submit(lambda: 1, key="dup")
        with pytest.raises(ValueError):
            c.submit(lambda: 2, key="dup")
        assert f1.result(T) == 1
    rep = c.close()
    assert rep is c.close()
    with pytest.raises(RuntimeError):
        c.start()
    with pytest.raises(RuntimeError, match="closed"):
        c.submit(lambda: 2)
    lazy = ns.Client(workers=1)
    f = lazy.submit(lambda: 1)
    assert lazy.close() is not None and f.result(1) == 1
    abandoned = ns.Client(workers=1)
    f2 = abandoned.submit(lambda: 1)
    assert abandoned.close(drain=False) is None
    with pytest.raises(ns.TaskFailed):
        f2.result(1)
    eng = ns.Engine(workers=1, resident=True)
    assert eng.shutdown() is None
    eng.start()
    eng.submit("a", fn=lambda: 1)
    rep2 = eng.shutdown()
    assert "a" in rep2.completed and eng.shutdown() is rep2
    with pytest.raises(RuntimeError):
        ns.Engine(workers=1).shutdown()
    return outcome(f1), outcome(f), outcome(f2), sorted(rep2.completed)


def loop_death(ns):
    c = ns.Client(workers=1)
    f = c.submit(lambda: 1)
    c.engine.backend.create_many = lambda tasks: (_ for _ in ()).throw(
        RuntimeError("backend died"))
    c.start()
    with pytest.raises(ns.TaskFailed, match="loop died"):
        f.result(T)
    with pytest.raises(RuntimeError, match="dispatch loop died"):
        c.submit(lambda: 2)
    with pytest.raises(RuntimeError, match="backend died"):
        c.close()
    return outcome(f)


def executor_crash_requeues(ns):
    crashed = []

    def execute(name, meta, worker):
        if not crashed:
            crashed.append(worker)
            raise ns.WorkerCrash("drill")
        return True

    with ns.Client(workers=2, executor=execute, pass_worker=True) as c:
        fs = [c.submit_task(f"n{i}") for i in range(10)]
        vals = c.gather(fs, timeout=T)
        assert vals == [None] * 10
        n_req = c.report().n_requeued
        assert n_req >= 1
        return vals, crashed, n_req


def retry_and_journal(ns, tmp):
    attempts = {}

    def flaky(x):
        attempts[x] = attempts.get(x, 0) + 1
        if attempts[x] == 1:
            raise ConnectionError("transient")
        return x * 10

    with ns.Client(workers=2, transport="thread", journal_dir=str(tmp),
                   retry=ns.RetryPolicy(max_attempts=3, backoff=0.0)) as c:
        futs = [c.submit(flaky, i) for i in range(5)]
        vals = c.gather(futs, timeout=T)
        assert vals == [0, 10, 20, 30, 40]
        assert c.engine.retries_total == 5
    with ns.Client(workers=1) as c:
        f = c.submit(lambda x: (_ for _ in ()).throw(ConnectionError("x")),
                     1, retry=ns.RetryPolicy(max_attempts=2, backoff=0.0))
        with pytest.raises(ConnectionError):
            f.result(T)
        return vals, outcome(f), c.engine.retries_total


def sharded_client(ns):
    """Futures on a four-shard hub: a DAG whose edges cross shards, a
    failure that poisons across shards, and a cancel."""
    with ns.Client(workers=4, shards=4, steal_n=2) as c:
        roots = [c.submit(lambda i=i: i, key=f"r{i}") for i in range(8)]
        mids = [c.submit(lambda v: v * 10, r, key=f"m{i}")
                for i, r in enumerate(roots)]
        total = c.submit(lambda *vs: sum(vs), *mids, key="total")
        bad = c.submit(lambda: 1 / 0, key="bad")
        kids = [c.submit(lambda v: v, bad, key=f"k{i}") for i in range(4)]
        out = total.result(T), [outcome(k) for k in kids], outcome(bad)
        stats = c.stats()
    assert out[0] == 280 and len(stats["shards"]) == 4
    assert all(k == ("raised", "DependencyFailed") for k in out[1])
    return out, stats["completed"]


PROGRAMS = {
    **{f"snippet_{s}": (lambda s: lambda ns: snippet(ns, s))(s)
       for s in ("dwork", "pmake", "mpi_list")},
    "dynamic_dag": dynamic_dag, "map_and_ordering": map_and_ordering,
    "failure_taxonomy": failure_taxonomy, "gather_mixed": gather_mixed,
    "fail_fast": fail_fast, "cancel_unstolen": cancel_unstolen,
    "cancel_leased": cancel_leased, "result_timeout": result_timeout,
    "seeded_kill": seeded_kill, "batch_mode": batch_mode,
    "ring_and_no_history": ring_and_no_history,
    "prune_resolved_dep": prune_resolved_dep,
    "prune_name_dep": prune_name_dep,
    "prune_every_bounded": prune_every_bounded,
    "prune_poisoned_waiting": prune_poisoned_waiting,
    "lifecycle": lifecycle, "loop_death": loop_death,
    "executor_crash_requeues": executor_crash_requeues,
    "sharded_client": sharded_client,
}


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_programs_observe_the_same_on_both_sides(name):
    prog = PROGRAMS[name]
    assert prog(SIDES["port"]) == prog(SIDES["jax"])


def test_retry_and_journal_dir(tmp_path):
    port = retry_and_journal(SIDES["port"], tmp_path / "port")
    jax = retry_and_journal(SIDES["jax"], tmp_path / "jax")
    assert port == jax == ([0, 10, 20, 30, 40], ("raised", "ConnectionError"),
                           1)
    from repro.core.engine import Journal
    for d in ("port", "jax"):           # each side's journal, read by JAX's
        st = Journal.replay(tmp_path / d)
        assert len(st.completed) == 5 and not st.pending()


def test_the_registries_agree():
    assert port_client.SCHEDULERS == jax_client.SCHEDULERS == (
        "dwork", "pmake", "mpi_list")
    assert port_executor.TRANSPORTS == jax_executor.TRANSPORTS == (
        "inproc", "thread", "tree", "proc")
    assert sorted(port_client.__all__) == sorted(jax_client.__all__)
    assert sorted(port_engine.__all__) == sorted(jax_engine.__all__)


@pytest.mark.parametrize("transport", ["proc"])
def test_unported_transports_raise(transport):
    """The worker processes are not ported: asking for them raises, naming
    their ROADMAP item, and never runs the tasks in-process instead."""
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        port_client.Client(workers=2, transport=transport)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        port_engine.Engine(workers=2, transport=transport)
    srv = port_dwork.TaskServer()
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        port_client.Client(workers=2, transport=transport, server=srv)
    from repro_torch.core.engine.backends import ServerBackend
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        port_engine.Engine(workers=2, transport=transport,
                           backend=ServerBackend(server=srv))
    with pytest.raises(NotImplementedError, match="4g"):
        port_engine.Engine(workers=2, transport=transport)


def tree_program(ns, shards):
    """README's composed example at a small size: futures over the
    forwarding tree, sharded or not; the client's own sockets are released
    at close."""
    with ns.Client(scheduler="dwork", workers=8, transport="tree",
                   shards=shards, tree_fanout=4) as c:
        backend = c.engine.backend
        xs = c.gather([c.submit(lambda x=x: x * x) for x in range(64)],
                      timeout=T)
        chain = c.submit(lambda: 1)
        for _ in range(4):
            chain = c.submit(lambda v: v + 1, chain)
        last = chain.result(T)
    st = c._report.backend_stats
    for s in st.get("shards", [st]):
        assert s["completed"] == s["created"] and s["errors"] == 0
    return (xs, last, st["tree"], sorted(st),
            [t.sock.fileno() for t in backend._conn.values()],
            backend._boss is None)


@pytest.mark.parametrize("shards", [1, 4])
def test_tree_transport_runs_the_same(shards):
    """`transport="tree"` builds a working `TreeBackend` on both sides
    (README's `Client(..., transport="tree", shards=4, tree_fanout=4)`),
    and `close()` releases the tree's worker and boss links."""
    port = tree_program(SIDES["port"], shards)
    assert port == tree_program(SIDES["jax"], shards)
    assert port[1] == 5 and port[2]["forwarders"] == [2]
    assert port[4] == [] and port[5] is True


def stats_server_program(ns):
    import json
    import urllib.request

    with ns.Client(workers=2) as c:
        srv = c.stats_server()
        fe = c.serve(lambda ps: [p + 1 for p in ps], max_wait_s=0.002)
        vals = c.gather([c.submit(lambda x=x: x * 3) for x in range(20)],
                        timeout=T)
        assert all(r.wait(T) for r in [fe.submit(i) for i in range(5)])
        got = {}
        for ep in ("/health", "/stats"):
            with urllib.request.urlopen(srv.url + ep, timeout=T) as r:
                got[ep] = json.loads(r.read().decode())
        with urllib.request.urlopen(srv.url + "/metrics", timeout=T) as r:
            families = sorted(line.split()[2] for line in
                              r.read().decode().splitlines()
                              if line.startswith("# TYPE"))
    try:
        urllib.request.urlopen(srv.url + "/health", timeout=0.5)
        stopped = False
    except OSError:
        stopped = True
    st = got["/stats"]
    return (vals, got["/health"], sorted(st), sorted(st["engine"]),
            st["engine"]["tasks_done"], families, stopped)


def test_stats_server_serves_the_same():
    """`Client.stats_server()`: the same endpoints, keys, metric families
    and counts on both sides, and `close()` stops the server."""
    port = stats_server_program(SIDES["port"])
    assert port == stats_server_program(SIDES["jax"])
    assert port[1]["ok"] is True and port[-1] is True


def test_launch_counts_hold_across_threads():
    """The kernels' launch counters are bumped from the engine's pool
    threads: under a short switch interval, 8 threads x 5,000 bumps must
    count 40,000 (a bare `+= 1` loses some)."""
    import sys
    from repro_torch.kernels import count_launch
    from repro_torch.kernels.tiled_matmul import ops

    before = ops.tiled_matmul.launches
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [
            count_launch(ops.tiled_matmul) for _ in range(5000)])
            for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert ops.tiled_matmul.launches - before == 40_000
    ops.tiled_matmul.launches = before
