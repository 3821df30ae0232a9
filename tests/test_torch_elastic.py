"""Port parity for the elastic pool and `run_pool`: the programs of
tests/test_integration.py (the elastic crash drill and remesh),
tests/test_client.py (the elastic pool's futures; `run_pool` as a client
shim, server pruning) and tests/test_engine.py (the lease regression, the
idle budget under a silent worker death), run through the JAX package and
the port.  Each program returns what it observed; both sides must observe
the same, and each asserts the reference's expectations on its own side.
Counts that depend on thread timing (steals, requeues in the crash drill)
are held to the reference's bounds, not to each other."""
from types import SimpleNamespace

import pytest

pytest.importorskip("torch")

import repro.client as jax_client  # noqa: E402
import repro.core.dwork as jax_dwork  # noqa: E402
import repro.core.engine as jax_engine  # noqa: E402
import repro.runtime.elastic as jax_elastic  # noqa: E402
import repro_torch.client as port_client  # noqa: E402
import repro_torch.core.dwork as port_dwork  # noqa: E402
import repro_torch.core.engine as port_engine  # noqa: E402
import repro_torch.runtime.elastic as port_elastic  # noqa: E402

T = 30.0


def side(client, dwork, engine, elastic):
    return SimpleNamespace(
        Future=client.Future, TaskServer=dwork.TaskServer,
        DworkClient=dwork.Client, InProcTransport=dwork.InProcTransport,
        run_pool=dwork.run_pool, FaultPlan=engine.FaultPlan,
        ManualClock=engine.ManualClock, ElasticPool=elastic.ElasticPool)


SIDES = {"jax": side(jax_client, jax_dwork, jax_engine, jax_elastic),
         "port": side(port_client, port_dwork, port_engine, port_elastic)}


def both(program, *args):
    out = {name: program(ns, *args) for name, ns in SIDES.items()}
    assert out["port"] == out["jax"]
    return out["port"]


def crash_drill(ns):
    with ns.ElasticPool(lease_timeout=5.0, per_task_s=0.001) as pool:
        for i in range(30):
            pool.submit(f"step{i}")
        seen = []
        pool.start_worker("w_bad", lambda n, m: seen.append(n) or True,
                          fail_after=3)
        pool.start_worker("w_ok", lambda n, m: seen.append(n) or True)
        stats = pool.join(timeout=T)
        assert stats["completed"] == 30
        assert stats["requeued"] >= 1
        done = sorted(n for _, n in pool.completed)
        assert done == sorted(f"step{i}" for i in range(30))
        assert {w for w, _ in pool.completed} <= {"w_bad", "w_ok"}
        return (stats["completed"], stats["created"], stats["errors"], done,
                sorted(set(seen)), pool.engine.steal_n)


def test_elastic_pool_crash_recovery_equal():
    both(crash_drill)


def remesh(ns):
    calls = []
    with ns.ElasticPool(remesh=lambda n: calls.append(n)) as pool:
        f = pool.submit("a")
        pool.start_worker("w0", lambda n, m: True)
        pool.join(timeout=T)
        pool.lose_worker("w0")
        assert calls == [1, 0]
        return calls, f.exception(5) is None, [pool.steal_n_for(n)
                                               for n in (0, 1, 6, 864, 6912)]


def test_elastic_remesh_called_equal():
    both(remesh)


def futures(ns):
    with ns.ElasticPool(lease_timeout=5.0) as pool:
        pool.start_worker("a", lambda name, meta: True)
        fs = [pool.submit(f"s{i}") for i in range(10)]
        pool.join(T)
        assert all(isinstance(f, ns.Future) and f.exception(5) is None
                   for f in fs)
        assert len(pool.completed) == 10
        # more work after a join: the pool stays up
        more = [pool.submit(f"t{i}", meta={"i": i}) for i in range(5)]
        stats = pool.join(T)
        return ([f.result(5) for f in fs + more], stats["completed"],
                stats["errors"], len(pool.completed))


def test_elastic_pool_futures_equal():
    both(futures)


def shim_contract(ns):
    srv = ns.TaskServer()
    boss = ns.DworkClient(ns.InProcTransport(srv), "boss")
    for i in range(25):
        boss.create(f"t{i}", meta={"x": i})
    rep = ns.run_pool(srv, lambda name, meta: (True, meta["x"] * 2),
                      workers=3, steal_n=4)
    assert len(rep.completed) == 25
    assert rep.results["t7"].value == 14
    return (sorted(rep.completed),
            {k: r.value for k, r in rep.results.items()}, srv.stats())


def test_run_pool_is_a_client_shim_equal():
    both(shim_contract)


def prune(ns):
    srv = ns.TaskServer()
    boss = ns.DworkClient(ns.InProcTransport(srv), "boss")
    for i in range(20):
        boss.create(f"t{i}", meta={})
    ns.run_pool(srv, lambda name, meta: True, workers=2)
    assert len(srv.joins) == 20 and srv._all_done()
    pruned = srv.prune_terminal()
    assert len(pruned) == 20
    assert not srv.joins and not srv.meta and not srv.completed
    boss.create("fresh", meta={})
    rep = ns.run_pool(srv, lambda name, meta: True, workers=1)
    assert "fresh" in rep.completed
    return sorted(pruned), sorted(rep.completed), srv.stats()


def test_server_prune_and_run_pool_equal():
    both(prune)


def lease_regression(ns):
    clock = {"now": 0.0}
    srv = ns.TaskServer(lease_timeout=1.0, clock=lambda: clock["now"])
    slow = ns.DworkClient(ns.InProcTransport(srv), "slow")
    slow.create("a")
    slow.create("b")
    assert slow.steal().tasks[0][0] == "a"
    clock["now"] = 2.0
    srv._reap_leases()
    assert srv.counters["requeued"] == 1
    assert list(srv.ready)[0] == "a"
    slow.complete("a")
    assert srv.counters["requeued"] == 1
    rep = ns.run_pool(srv, lambda n, m: True, workers=2)
    assert rep.backend_stats["completed"] == 2
    assert "a" not in rep.results
    assert srv.counters["stolen"] == 2
    return dict(srv.counters), sorted(rep.results), rep.backend_stats


def test_lease_regression_equal():
    both(lease_regression)


def idle_budget(ns):
    clk = ns.ManualClock(tick=1e-3)
    srv = ns.TaskServer(lease_timeout=1.0, clock=clk)
    boss = ns.DworkClient(ns.InProcTransport(srv), "boss")
    for i in range(6):
        boss.create(f"t{i}")
    rep = ns.run_pool(srv, lambda n, m: True, workers=2, steal_n=2,
                      clock=clk, faults=ns.FaultPlan(seed=1).kill_worker(
                          "w0", after_steals=1, silent=True))
    assert len(rep.completed) == 6 and not rep.stalled
    ov = rep.overhead()
    assert ov.n_requeued >= 1
    return (sorted(rep.completed), rep.stalled, ov.n_requeued,
            rep.backend_stats, sorted(rep.errors))


def test_run_pool_inherits_server_lease_equal():
    both(idle_budget)


def test_tree_transport_raises_until_ported():
    srv = port_dwork.TaskServer()
    port_dwork.Client(port_dwork.InProcTransport(srv), "boss").create("t0")
    with pytest.raises(NotImplementedError, match="4d"):
        port_dwork.run_pool(srv, lambda n, m: True, transport="tree")
