"""Port parity for the forwarding tree: the programs of
tests/test_forwarder.py and tests/test_sharded_tree.py, run through the JAX
package's `Forwarder` / `ShardRouter` / `TreeBackend` and the port's.

Each program takes a side and returns what it observed.  The engine runs
over `transport="tree"` at 1 and N shards with the same DAGs and `FaultPlan`
seeds under a `ManualClock`: every worker round trip is synchronous, so both
sides must agree on the completed and failed sets, on every task's
lifecycle (the trace's events in order, with the worker that saw them), on
the rpc ops and their counts (hops included), and on the backend's stats
with their "tree" section.  Round-trip times are the wall clock's and are
not compared.  Frames are the JAX package's wire format, so a port
forwarder relays between a JAX server and a JAX client too."""
import threading
import time
from collections import Counter
from types import SimpleNamespace

import pytest

import repro.client as jax_client
import repro.core.dwork as jax_dwork
import repro.core.dwork.client as jax_dclient
import repro.core.dwork.sharded as jax_sharded
import repro.core.engine as jax_engine
import repro_torch.client as port_client
import repro_torch.core.dwork as port_dwork
import repro_torch.core.dwork.client as port_dclient
import repro_torch.core.dwork.sharded as port_sharded
import repro_torch.core.engine as port_engine

T = 30.0


def side(client, dwork, dclient, sharded, engine):
    return SimpleNamespace(
        Client=client.Client, TaskServer=dwork.TaskServer,
        DworkClient=dwork.Client, InProcTransport=dwork.InProcTransport,
        Forwarder=dwork.Forwarder, run_pool=dwork.run_pool,
        TCPServer=dclient.TCPServer, TCPTransport=dclient.TCPTransport,
        ShardedHub=sharded.ShardedHub, E=engine)


SIDES = {"jax": side(jax_client, jax_dwork, jax_dclient, jax_sharded,
                     jax_engine),
         "port": side(port_client, port_dwork, port_dclient, port_sharded,
                      port_engine)}


def both(program, *args):
    out = {name: program(ns, *args) for name, ns in SIDES.items()}
    assert out["port"] == out["jax"]
    return out["port"]


def run_record(rep):
    """An EngineReport over the tree as comparable data."""
    tr = rep.trace
    lifecycle = [(e.event, e.task, e.worker,
                  {k: v for k, v in (e.extra or {}).items()
                   if k not in ("dt", "t_rpc")})
                 for e in tr.events if e.event != "rpc"]
    rpcs = Counter(e.extra.get("op") for e in tr.events if e.event == "rpc")
    values = {n: r.value for n, r in sorted(rep.results.items()) if r.ok}
    return {"completed": sorted(rep.completed), "errors": sorted(rep.errors),
            "stalled": rep.stalled, "lifecycle": lifecycle,
            "rpcs": dict(rpcs), "backend_stats": rep.backend_stats,
            "values": values, "requeued": rep.overhead().n_requeued}


# ------------------------------------------------------------- forwarder


def hub_with_tasks(ns, n):
    srv = ns.TaskServer()
    boss = ns.DworkClient(ns.InProcTransport(srv), "boss")
    for i in range(n):
        boss.create(f"t{i}", meta={"x": i})
    return srv


def serve(ns, srv):
    tcp = ns.TCPServer(("127.0.0.1", 0), srv)
    tcp.serve_background()
    return tcp


def relay_concurrent(ns):
    """8 workers through ONE forwarder: every task exactly once."""
    srv = hub_with_tasks(ns, 200)
    tcp = serve(ns, srv)
    fwd = ns.Forwarder(("127.0.0.1", 0), tcp.server_address)
    fwd.serve_background()
    counts, lock = Counter(), threading.Lock()

    def work(w):
        def run(name, meta):
            with lock:
                counts[name] += 1
            return True
        ns.DworkClient(ns.TCPTransport(*fwd.server_address), w).run_loop(
            run, steal_n=2)

    try:
        threads = [threading.Thread(target=work, args=(f"w{i}",))
                   for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=T)
        return (srv.counters["completed"], sorted(counts),
                set(counts.values()), fwd.upstream_error, fwd.relayed > 0)
    finally:
        fwd.close()
        tcp.shutdown()
        tcp.server_close()


def two_level(ns):
    """worker -> leaf forwarder -> mid forwarder -> hub."""
    srv = hub_with_tasks(ns, 30)
    tcp = serve(ns, srv)
    mid = ns.Forwarder(("127.0.0.1", 0), tcp.server_address)
    mid.serve_background()
    leaf = ns.Forwarder(("127.0.0.1", 0), mid.server_address)
    leaf.serve_background()
    try:
        cl = ns.DworkClient(ns.TCPTransport(*leaf.server_address), "w0")
        done = cl.run_loop(lambda name, meta: True, steal_n=4)
        return (done, dict(srv.counters), leaf.relayed, mid.relayed,
                sorted(srv.completed))
    finally:
        leaf.close()
        mid.close()
        tcp.shutdown()
        tcp.server_close()


def upstream_failure(ns):
    """A hub dying mid-frame closes the downstream side and is recorded
    on the forwarder."""
    import socket
    lst = socket.socket()
    lst.bind(("127.0.0.1", 0))
    lst.listen(1)

    def doomed_hub():
        conn, _ = lst.accept()
        conn.recv(4)
        conn.close()

    threading.Thread(target=doomed_hub, daemon=True).start()
    fwd = ns.Forwarder(("127.0.0.1", 0), lst.getsockname())
    fwd.serve_background()
    try:
        cl = ns.DworkClient(ns.TCPTransport(*fwd.server_address), "w0")
        try:
            cl.steal(n=1)
            raised = None
        except (ConnectionError, OSError) as e:
            raised = isinstance(e, (ConnectionError, OSError))
        deadline = time.time() + 5
        while fwd.upstream_error is None and time.time() < deadline:
            time.sleep(0.01)
        return raised, fwd.upstream_error is not None
    finally:
        fwd.close()
        lst.close()


def abrupt_disconnect(ns):
    srv = hub_with_tasks(ns, 40)
    tcp = serve(ns, srv)
    fwd = ns.Forwarder(("127.0.0.1", 0), tcp.server_address)
    fwd.serve_background()
    try:
        rude = ns.TCPTransport(*fwd.server_address)
        ns.DworkClient(rude, "rude").steal(n=1)
        rude.sock.close()
        cl = ns.DworkClient(ns.TCPTransport(*fwd.server_address), "w0")
        done = cl.run_loop(lambda name, meta: True, steal_n=4)
        return done, fwd.upstream_error
    finally:
        fwd.close()
        tcp.shutdown()
        tcp.server_close()


FORWARDER_PROGRAMS = {"relay_concurrent": relay_concurrent,
                      "two_level": two_level,
                      "upstream_failure": upstream_failure,
                      "abrupt_disconnect": abrupt_disconnect}


@pytest.mark.parametrize("name", sorted(FORWARDER_PROGRAMS))
def test_forwarder_programs_observe_the_same(name):
    out = both(FORWARDER_PROGRAMS[name])
    if name == "relay_concurrent":
        assert out[0] == 200 and out[2] == {1} and out[3] is None
    if name == "upstream_failure":
        assert out == (True, True)


@pytest.mark.parametrize("relay,ends", [("port", "jax"), ("jax", "port")])
def test_a_forwarder_relays_the_other_sides_frames(relay, ends):
    """The wire is the JAX package's: one side's forwarder between the
    other side's server and client."""
    far, mid = SIDES[ends], SIDES[relay]
    srv = hub_with_tasks(far, 25)
    tcp = serve(far, srv)
    fwd = mid.Forwarder(("127.0.0.1", 0), tcp.server_address)
    fwd.serve_background()
    try:
        cl = far.DworkClient(far.TCPTransport(*fwd.server_address), "w0")
        assert cl.run_loop(lambda name, meta: True, steal_n=3) == 25
        assert srv.counters["completed"] == 25 and fwd.relayed > 0
    finally:
        fwd.close()
        tcp.shutdown()
        tcp.server_close()


# ------------------------------------------ the engine over the tree


def flat(E, n, shards, tick=1e-6, **kw):
    eng = E.Engine(transport="tree", shards=shards,
                   clock=E.ManualClock(tick=tick), **kw)
    for i in range(n):
        eng.submit(f"t{i}", fn=lambda i=i: i)
    return eng


def dag(E, shards):
    eng = E.Engine(workers=2, transport="tree", shards=shards, steal_n=2,
                   clock=E.ManualClock(tick=1e-6))
    eng.submit("a", fn=lambda: 1)
    eng.submit("b", fn=lambda: 2, deps=["a"])
    eng.submit("c", fn=lambda: 3, deps=["a", "b"])
    return eng


def cancel_boss_link(E, shards):
    eng = E.Engine(workers=2, transport="tree", shards=shards, steal_n=2,
                   clock=E.ManualClock(tick=1e-6))
    eng.submit("root", fn=lambda: None)
    eng.submit("victim", fn=lambda: None, deps=["root"])
    eng.submit("heir", fn=lambda: None, deps=["victim"])
    assert eng.cancel("victim") is True
    return eng


CASES = {
    "dag": dag,
    "two_level": lambda E, s: flat(E, 60, s, workers=8 if s > 1 else 4,
                                   steal_n=4, tree_fanout=2, tree_levels=2),
    "announced_death": lambda E, s: flat(
        E, 120, s, workers=3, steal_n=4,
        faults=E.FaultPlan(seed=7).kill_worker("w1", after_steals=4)),
    "kill_mid_complete_steal": lambda E, s: flat(
        E, 80, s, workers=2, steal_n=4,
        faults=E.FaultPlan(seed=11).kill_worker("w0", after_steals=8)),
    "silent_death_lease": lambda E, s: flat(
        E, 20, s, tick=1e-3, workers=2, steal_n=2, lease_timeout=0.05,
        faults=E.FaultPlan(seed=3).kill_worker("w1", after_steals=2,
                                               silent=True)),
    "stragglers": lambda E, s: flat(
        E, 16, s, workers=2, steal_n=2,
        faults=E.FaultPlan(seed=11).stragglers(1e-3)),
    "fail_rate": lambda E, s: flat(
        E, 48, s, workers=3, steal_n=2,
        faults=E.FaultPlan(seed=5).fail_rate(0.1)),
    "cancel_boss_link": cancel_boss_link,
}


def tree_run(ns, case, shards):
    rep = CASES[case](ns.E, shards).run()
    rec = run_record(rep)
    rec["virtual_s"] = rep.overhead().virtual_s
    return rec


@pytest.mark.parametrize("shards", [1, 2])
@pytest.mark.parametrize("case", sorted(CASES))
def test_same_dag_same_run_over_the_tree(case, shards):
    rec = both(tree_run, case, shards)
    assert not rec["stalled"] and "tree" in rec["backend_stats"]
    hops = {op for op in rec["rpcs"] if op.startswith("hop:")}
    assert hops, rec["rpcs"]
    if shards > 1:
        assert any(op.startswith("hop:L1:s") for op in hops)
        assert "hop:L1" not in hops
    else:
        assert "hop:L1" in hops
    if case == "cancel_boss_link":
        assert rec["completed"] == ["root"]
        assert {"victim", "heir"} <= set(rec["errors"])


def tree_stats_keys(ns, shards):
    eng = ns.E.Engine(workers=5, transport="tree", shards=shards,
                      tree_fanout=2, tree_levels=2)
    try:
        return (sorted(eng.backend.stats()), eng.backend.stats()["tree"],
                eng.shards, eng.backend.n_shards,
                eng.backend.tracer is eng.tracer)
    finally:
        eng.backend.close()


@pytest.mark.parametrize("shards", [1, 3])
def test_tree_stats_keys_agree(shards):
    out = both(tree_stats_keys, shards)
    assert out[1]["forwarders"] == [2, 3] and out[2] == out[3] == shards


def bare_backend(ns):
    """A TreeBackend built without a tracer gets the engine's, and hands
    it down to its forwarders."""
    backend = ns.E.TreeBackend(workers=2, fanout=2)
    eng = ns.E.Engine(workers=2, transport="tree", steal_n=2,
                      backend=backend, clock=ns.E.ManualClock(tick=1e-6))
    for i in range(20):
        eng.submit(f"t{i}", fn=lambda: None)
    try:
        rec = run_record(eng.run())
    finally:
        backend.close()
    return rec


def test_bare_tree_backend_attributes_hops():
    rec = both(bare_backend)
    assert rec["rpcs"].get("hop:L1", 0) > 0


# ------------------------------------------------ run_pool and the hub


def run_pool_tree(ns, hub_shards):
    """`run_pool(transport="tree")` gives what the inproc run gives, and a
    caller's hub stays usable in-process after the tree is closed."""
    out = []
    for transport in ("inproc", "tree"):
        if hub_shards:
            hub = ns.ShardedHub(hub_shards)
            for i in range(50):
                hub.create(f"t{i}", meta={"x": i})
        else:
            hub = hub_with_tasks(ns, 50)
        rep = ns.run_pool(hub, lambda name, meta: (True, meta["x"] * 2),
                          workers=4, steal_n=4, transport=transport,
                          tree_fanout=2)
        out.append(({k: r.value for k, r in rep.results.items()},
                    sorted(rep.completed), rep.stalled,
                    rep.backend_stats.get("tree")))
        if hub_shards:
            assert hub.sender is None
            hub.create("after_tree")
            r, _shard = hub.steal("w0", n=1)
            out.append([t for t, _m in r.tasks])
    return out


@pytest.mark.parametrize("hub_shards", [0, 2])
def test_run_pool_tree_matches_inproc_on_both_sides(hub_shards):
    out = both(run_pool_tree, hub_shards)
    inproc, tree = out[0], out[2] if hub_shards else out[1]
    assert inproc[:3] == tree[:3]
    assert inproc[0] == {f"t{i}": 2 * i for i in range(50)}
    assert tree[3]["shards"] == max(hub_shards, 1)
    if hub_shards:
        assert out[1] == out[3] == ["after_tree"]


def futures_over_sharded_tree(ns):
    """README's composed configuration: a chain of dependent futures across
    a seeded worker kill, each resolved exactly once; prune reaches every
    shard behind the tree."""
    faults = ns.E.FaultPlan(seed=9).kill_worker("w1", after_steals=6)
    resolved = []
    with ns.Client(scheduler="dwork", workers=3, transport="tree", shards=4,
                   faults=faults) as c:
        fs = [c.submit(lambda x: x * x, i) for i in range(40)]
        chain = c.submit(lambda: 1)
        for _ in range(5):
            chain = c.submit(lambda v: v + 1, chain)
        for f in fs:
            f.add_done_callback(lambda f: resolved.append(f.name))
        squares = c.gather(fs, timeout=60)
        last = chain.result(timeout=60)
        hub = c.engine.backend.hub
        before = sum(len(s.joins) for s in hub.shards)
        pruned = c.prune()
        after = sum(len(s.joins) for s in hub.shards)
        again = c.submit(lambda: 99).result(timeout=T)
    return (squares, last, sorted(resolved) == sorted(f.name for f in fs),
            pruned > 0, after < before, again)


def test_futures_over_the_sharded_tree_agree():
    out = both(futures_over_sharded_tree)
    assert out == ([i * i for i in range(40)], 6, True, True, True, 99)
