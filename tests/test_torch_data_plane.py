"""Port parity for the peer-to-peer data plane: every test of
tests/test_data_plane.py, run through the JAX package and the port.

The resolve chain's legs (cache -> store -> hub -> peer -> recompute) are
driven through `_DataPlane.resolve` with a scripted stub hub on both
sides; the integration programs then run the same legs over real worker
processes, the port's side spawning the port's workers.  Every compared
outcome is deterministic: values, digests, which legs a fetch took, and
which names the stores hold.  Counts that depend on timing are held to
their bounds on each side.  Task callables are lambdas (cloudpickle ships
them by value across the process boundary)."""
import hashlib
import os
import signal
import time
from types import SimpleNamespace

import pytest

import repro.client as jax_client
import repro.core.dwork.api as jax_api
import repro.core.engine as jax_engine
import repro.core.engine.comm.core as jax_comm_core
import repro.core.engine.comm.serialize as jax_serialize
import repro.core.engine.comm.worker as jax_worker
import repro.core.engine.model as jax_model
import repro_torch.client as port_client
import repro_torch.core.dwork.api as port_api
import repro_torch.core.engine as port_engine
import repro_torch.core.engine.comm.core as port_comm_core
import repro_torch.core.engine.comm.serialize as port_serialize
import repro_torch.core.engine.comm.worker as port_worker
import repro_torch.core.engine.model as port_model

HB = 0.1
BIG = 300_000                 # well above every inline_bytes used here


# The JAX package's batch proc run declares a stall when a sharded hub's
# workers make no progress for max_idle_rounds polls (500 by default, about
# 0.5 s), as when they start slowly under load: its check reads "ready" and
# "assigned" where only each shard reports them (ROADMAP.md Queue 3).  Its
# side of a sharded batch run is given room to start; the port's runs with
# the default, which the port's engine reads per shard.
JAX_SHARDED_IDLE_ROUNDS = 60_000


def side(pkg, client, api, engine, comm_core, ser, worker, model,
         sharded_idle_rounds=None):
    return SimpleNamespace(
        pkg=pkg, Client=client.Client, Engine=engine.Engine,
        sharded_idle_rounds=sharded_idle_rounds,
        XFER_LOST_PREFIX=api.XFER_LOST_PREFIX, Fetch=api.Fetch,
        LocMsg=api.LocMsg, NotFound=api.NotFound, ValueMsg=api.ValueMsg,
        Spill=api.Spill, listen=comm_core.listen, Ref=ser.Ref,
        RemoteValue=ser.RemoteValue, dumps=ser.dumps, loads=ser.loads,
        DataPlane=worker._DataPlane, DataServer=worker._DataServer,
        LostDep=worker._LostDep, XFER=model.XFER)


SIDES = {"jax": side("repro", jax_client, jax_api, jax_engine,
                     jax_comm_core, jax_serialize, jax_worker, jax_model,
                     JAX_SHARDED_IDLE_ROUNDS),
         "port": side("repro_torch", port_client, port_api, port_engine,
                      port_comm_core, port_serialize, port_worker,
                      port_model)}


def both(program, *args):
    """Run `program` on the port's side and the JAX package's; both must
    observe the same.  -> the port's observation."""
    port = program(SIDES["port"], *args)
    assert port == program(SIDES["jax"], *args)
    return port


def _pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:
        return True
    return True


def _wait(pred, timeout=30.0, what="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.02)
    raise AssertionError(f"timed out waiting for {what}")


def md5(b: bytes) -> str:
    """The digest the parent compares; task lambdas call hashlib
    themselves (a worker cannot import this module)."""
    return hashlib.md5(b).hexdigest()


# --------------------------------------------- resolve chain (unit, stubs)


class _StubHub:
    """Scripted control-plane transport: each request pops the next
    canned response (or raises it)."""

    def __init__(self, *script):
        self.script = list(script)
        self.calls = []

    def request(self, msg):
        self.calls.append(msg)
        r = self.script.pop(0)
        if isinstance(r, Exception):
            raise r
        return r


def with_plane(ns, body, *script):
    plane = ns.DataPlane(_StubHub(*script))
    try:
        return body(plane)
    finally:
        plane.close()


def local_caches(ns):
    def body(plane):
        xfers: list = []
        got = [plane.resolve(41, xfers)]          # not a Ref: pass-through
        plane.cache_obj("a", {"k": 7})
        got.append(plane.resolve(ns.Ref("a"), xfers))
        plane.put("b", ns.dumps([1, 2, 3]), owned=False)
        got.append(plane.resolve(ns.Ref("b"), xfers))
        # never touched the wire; local hits: no stats
        return got, plane.transport.calls, xfers
    return with_plane(ns, body)


def test_resolve_non_ref_and_local_caches():
    assert both(local_caches) == ([41, {"k": 7}, [1, 2, 3]], [], [])


def hub_value(ns):
    def body(plane):
        xfers: list = []
        first = plane.resolve(ns.Ref("c"), xfers)
        cached = plane.resolve(ns.Ref("c"), [])
        return (first, cached, [x[0] for x in xfers],
                len(plane.transport.calls))
    return with_plane(ns, body,
                      ns.ValueMsg(task="c", payload=ns.dumps("hub-served")))


def test_resolve_hub_value():
    assert both(hub_value) == ("hub-served", "hub-served", ["hub"], 1)


def peer_redirect(ns):
    class _Peer:
        def handle(self, msg):
            assert isinstance(msg, ns.Fetch)
            return ns.ValueMsg(task=msg.task, payload=ns.dumps(b"x" * 99))

    lst = ns.listen(f"inproc://dp-peer-hit-{ns.pkg}", _Peer())
    try:
        def body(plane):
            xfers: list = []
            got = plane.resolve(ns.Ref("d"), xfers)
            assert xfers[0][1] > 0 and xfers[0][2] >= 0.0
            return got, [x[0] for x in xfers]
        return with_plane(ns, body, ns.LocMsg(task="d", addr=lst.address,
                                              worker="w9", nbytes=99))
    finally:
        lst.stop()


def test_resolve_peer_redirect_hits_producer():
    assert both(peer_redirect) == (b"x" * 99, ["peer"])


def dead_peer_falls_back(ns):
    # the redirect points at a dead producer; the hub answers the retry
    # (a Spill landed meanwhile) — the chain must recover transparently
    def body(plane):
        xfers: list = []
        got = plane.resolve(ns.Ref("e"), xfers)
        return got, [x[0] for x in xfers], len(plane.transport.calls)
    return with_plane(
        ns, body,
        ns.LocMsg(task="e", addr="tcp://127.0.0.1:1", worker="w0", nbytes=5),
        ns.ValueMsg(task="e", payload=ns.dumps("spilled")))


def test_resolve_dead_peer_falls_back_to_hub():
    # Fetch + hub retry
    assert both(dead_peer_falls_back) == ("spilled", ["hub"], 2)


def unrecoverable(ns):
    # producer dead AND the hub never got a replica: recompute territory
    def body(plane):
        with pytest.raises(ns.LostDep) as ei:
            plane.resolve(ns.Ref("f"), [])
        return ei.value.name, ns.XFER_LOST_PREFIX + "f"
    return with_plane(
        ns, body,
        ns.LocMsg(task="f", addr="tcp://127.0.0.1:1", worker="w0", nbytes=5),
        ns.NotFound())


def test_resolve_unrecoverable_raises_lost_dep():
    assert both(unrecoverable) == ("f", "__xfer_lost__:f")


def never_known(ns):
    def body(plane):
        with pytest.raises(KeyError, match="unavailable on the hub") as ei:
            plane.resolve(ns.Ref("g"), [])
        return str(ei.value)
    return with_plane(ns, body, ns.NotFound())


def test_resolve_never_known_raises_keyerror():
    assert "'g'" in both(never_known)


def lru_spill_budget(ns):
    class _SpillHub(_StubHub):
        def __init__(self):
            super().__init__()
            self.spilled = []

        def request(self, msg):
            assert isinstance(msg, ns.Spill)
            self.spilled.append(msg.task)
            return ns.NotFound()

    plane = ns.DataPlane(_SpillHub())
    try:
        plane.me = "wX"
        plane.spill_bytes = 300
        p = ns.dumps(b"y" * 200)                   # ~200B payloads
        plane.put("old", p, owned=True, value=b"y" * 200, have_value=True)
        plane.put("new", p, owned=True, value=b"y" * 200, have_value=True)
        # budget 300 < 2 payloads: the oldest owned value was evicted and
        # replicated to the hub first; the store never drops to empty
        after_two = (list(plane.transport.spilled), list(plane.store),
                     sorted(plane.objs))
        # borrowed (not owned) evictions never spill — peer copies are
        # cache, the producer still holds the original
        plane.put("borrowed", p, owned=False)
        return after_two, list(plane.transport.spilled)
    finally:
        plane.close()


def test_data_plane_lru_spill_budget():
    assert both(lru_spill_budget) == ((["old"], ["new"], ["new"]),
                                      ["old", "new"])


def data_server(ns):
    def body(plane):
        plane.put("have", ns.dumps(3), owned=False)
        srv = ns.DataServer(plane)
        resp = srv.handle(ns.Fetch(task="have"))
        missing = srv.handle(ns.Fetch(task="missing"))
        return (type(resp).__name__, ns.loads(resp.payload),
                type(missing).__name__)
    return with_plane(ns, body)


def test_data_server_serves_store_and_not_found():
    assert both(data_server) == ("ValueMsg", 3, "NotFound")


def remote_value(ns):
    calls = []

    def fetch(name):
        calls.append(name)
        return [name, 1]

    rv = ns.RemoteValue("t9", 1234, fetch)
    before = (rv.resolved, rv.nbytes)
    return before, rv.get(), rv.get(), calls, rv.resolved


def test_remote_value_fetches_once_and_caches():
    assert both(remote_value) == ((False, 1234), ["t9", 1], ["t9", 1],
                                  ["t9"], True)


# ----------------------------------------------- integration: peer fetch


def peer_fetch_between_workers(ns):
    c = ns.Client(transport="proc", workers=2, heartbeat_s=HB,
                  inline_bytes=1024, steal_n=1)
    try:
        # slow producers force both workers to participate, so at least
        # one dependency of every sink lives on the OTHER worker
        bigs = [c.submit(lambda i=i: time.sleep(0.3) or bytes([i]) * BIG,
                         key=f"big{i}") for i in range(4)]
        c.gather(bigs)
        sums = [c.submit(
            (lambda *vs: hashlib.md5(b"".join(vs)).hexdigest()),
            *bigs, key=f"sum{i}") for i in range(4)]
        got = [f.result(timeout=60) for f in sums]
        eng = c.engine
        # the hub tracked locations, the workers moved the bytes directly
        assert eng.xfer_totals["peer"][0] > 0, "no peer-path fetch happened"
        assert eng.xfer_totals["peer"][1] > BIG
        # attribution: unsampled xfer trace events match the totals
        n_ev = sum(1 for e in eng.tracer.events if e.event == ns.XFER)
        n_tot = sum(v[0] for v in eng.xfer_totals.values())
        assert n_ev == n_tot > 0
        # a big result itself materializes through the lazy handle
        return got, eng.xfer_lost_total, md5(bigs[2].result(timeout=60))
    finally:
        c.close()


def test_peer_fetch_between_workers_exact_values():
    expect = md5(b"".join(bytes([j]) * BIG for j in range(4)))
    assert both(peer_fetch_between_workers) == ([expect] * 4, 0,
                                                md5(bytes([2]) * BIG))


def small_values_inline(ns):
    eng = ns.Engine(transport="proc", workers=2, heartbeat_s=HB)
    for i in range(8):
        eng.submit(f"s{i}", lambda i=i: i * 3)
    rep = eng.run()
    return (sorted(r.value for r in rep.results.values()),
            eng.backend.door.locations, eng.xfer_totals["peer"][0],
            eng.xfer_totals["hub"][0])


def test_small_values_stay_inline_no_locations():
    assert both(small_values_inline) == ([i * 3 for i in range(8)], {}, 0, 0)


def spilled_value_served_by_hub(ns):
    # a single worker with a tiny byte budget: producing big1 evicts big0
    # (replicated to the hub by Spill), so the consumer's fetch of big0
    # must come back over the hub path — and still be exact
    c = ns.Client(transport="proc", workers=1, heartbeat_s=HB,
                  inline_bytes=1024, spill_bytes=4096, steal_n=1)
    try:
        b0 = c.submit(lambda: b"a" * BIG, key="big0")
        b1 = c.submit(lambda: b"b" * BIG, key="big1")
        cons = c.submit(lambda x, y: (hashlib.md5(x).hexdigest(),
                                      hashlib.md5(y).hexdigest()),
                        b0, b1, key="cons")
        got = cons.result(timeout=60)
        assert c.engine.xfer_totals["hub"][0] >= 1, \
            "spilled value did not travel the hub path"
        return got, c.engine.xfer_lost_total
    finally:
        c.close()


def test_spilled_value_served_by_hub():
    assert both(spilled_value_served_by_hub) == (
        (md5(b"a" * BIG), md5(b"b" * BIG)), 0)


def report_materializes(ns):
    eng = ns.Engine(transport="proc", workers=2, heartbeat_s=HB,
                    inline_bytes=1024)
    for i in range(3):
        eng.submit(f"big{i}", lambda i=i: bytes([i]) * BIG)
    rep = eng.run()
    vals = [rep.results[f"big{i}"].value for i in range(3)]
    assert not any(isinstance(v, ns.RemoteValue) for v in vals)
    return [md5(v) for v in vals]


def test_engine_run_materializes_remote_values_in_report():
    assert both(report_materializes) == [md5(bytes([i]) * BIG)
                                         for i in range(3)]


# --------------------------------------- integration: SIGKILL + recompute


def producer_sigkill(ns, tmp):
    pidfile = str(tmp / "producer.pid")
    flag = str(tmp / "gate.flag")
    c = ns.Client(transport="proc", workers=2, heartbeat_s=HB,
                  inline_bytes=1024, steal_n=1)
    try:
        big = c.submit(
            lambda p=pidfile: (open(p, "w").write(str(os.getpid())),
                               b"z" * BIG)[1], key="big")
        # the gate spins until the kill landed, so the consumer cannot
        # run (and cache the value) before the producer dies
        gate = c.submit(
            lambda f=flag: [time.sleep(0.02)
                            for _ in range(3000) if not os.path.exists(f)]
            and None, key="gate")
        cons = c.submit(lambda b, g: hashlib.md5(b).hexdigest(), big, gate,
                        key="cons")
        c._ensure_running()           # dispatch starts without a waiter
        _wait(lambda: os.path.exists(pidfile), what="producer pid")
        _wait(big.done, what="big terminal")
        pid = int(open(pidfile).read())
        os.kill(pid, signal.SIGKILL)
        _wait(lambda: not _pid_alive(pid), what="producer death")
        open(flag, "w").close()                    # release the gate
        got = cons.result(timeout=120)
        assert c.engine.xfer_lost_total >= 1, \
            "consumer never hit the lost-value recompute path"
        return got
    finally:
        c.close()


def test_producer_sigkill_recomputes_lost_value(tmp_path):
    """Kill the producer AFTER its big result completed but BEFORE any
    dependent fetched it: the only copy dies with the process, the
    consumer reports `__xfer_lost__`, and the engine recomputes the
    value from the task's packed call — zero loss, exact bytes."""
    got = {}
    for name, ns in SIDES.items():
        (tmp_path / name).mkdir()
        got[name] = producer_sigkill(ns, tmp_path / name)
    assert got["port"] == got["jax"] == md5(b"z" * BIG)


# ------------------------------------------------- prune regression


def _populated_proc_engine(ns, shards=1):
    eng = ns.Engine(transport="proc", workers=2, shards=shards,
                    heartbeat_s=HB, inline_bytes=1024,
                    max_idle_rounds=(ns.sharded_idle_rounds if shards > 1
                                     else None))
    for i in range(4):
        eng.submit(f"big{i}", lambda i=i: bytes([i]) * BIG)
    rep = eng.run()
    assert len(rep.results) == 4
    return eng


def prune_evicts(ns, shards):
    eng = _populated_proc_engine(ns, shards=shards)
    door = eng.backend.door
    # exit flush replicated the big payloads hub-side; locations tracked
    assert door.values and door.locations
    door.early_spills["phantom"] = "stale-payload"
    eng.backend.prune_terminal(keep=("big1",))
    kept = (set(door.values) <= {"big1"}, set(door.locations) <= {"big1"},
            door.early_spills)
    eng.backend.prune_terminal()
    return kept, door.values, door.locations


@pytest.mark.parametrize("shards", [1, 2])
def test_prune_terminal_evicts_data_plane_stores(shards):
    """Regression: pruned sessions must not leak payload bytes — every
    data-plane table on the front door (values from exit-flush spills,
    locations, early spills) is evicted along with the task records."""
    assert both(prune_evicts, shards) == ((True, True, {}), {}, {})


def prune_respects_pinned(ns):
    eng = _populated_proc_engine(ns)
    eng.pin("big3")
    eng.prune_terminal()
    door = eng.backend.door
    return sorted(door.values), sorted(door.locations)


def test_engine_prune_respects_pinned_values():
    assert both(prune_respects_pinned) == (["big3"], ["big3"])
