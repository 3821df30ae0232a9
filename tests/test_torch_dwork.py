"""Port parity for the dwork scheduler (paper §2.2): the port's server,
clients, wire format, persistence, TCP path and dquery against the JAX
package's, on the same scripted message sequences.

The scripts are the cases of tests/test_dwork.py and of
tests/test_extensions.py::test_overlap_client_completes_and_prefetches, run
step by step against both servers; every response is compared as (type
name, fields) and the stats as dicts.  Deterministic, and deliberately not
behind hypothesis (tests/test_dwork.py skips where it is missing)."""
import contextlib
import importlib.util
import io
import json
import sys

import pytest

from repro.core import dwork as jax_dwork
from repro.core.dwork import api as jax_api
from repro.core.dwork import client as jax_client
from repro.core.dwork import dquery as jax_dquery
from repro.core.dwork.overlap import OverlapClient as JaxOverlapClient
from repro_torch.core import dwork as port_dwork
from repro_torch.core.dwork import api as port_api
from repro_torch.core.dwork import client as port_client
from repro_torch.core.dwork import dquery as port_dquery
from repro_torch.core.dwork.overlap import OverlapClient as PortOverlapClient

SIDES = {"jax": (jax_api, jax_dwork.TaskServer),
         "port": (port_api, port_dwork.TaskServer)}


def as_plain(r):
    """A response as comparable data: (type name, fields) or a stats dict;
    tuples become lists, as on the wire."""
    if isinstance(r, dict):
        return json.loads(json.dumps(r))
    return type(r).__name__, json.loads(json.dumps(r.__dict__))


# A script step is (verb, fields) sent to the server, ("clock", t) to set
# the lease clock, ("reap",) to reap leases, ("drain", worker, n, failing)
# to steal and complete until the server answers other than TaskMsg, or
# ("prune",) for prune_terminal.
SCRIPTS = {
    "fifo_order": [("Create", {"task": f"t{i}"}) for i in range(5)]
    + [("drain", "w0", 1, ())],
    "transfer_goes_to_front": [
        ("Create", {"task": "a"}), ("Create", {"task": "b"}),
        ("Steal", {"worker": "w0"}),
        ("Transfer", {"worker": "w0", "task": "a", "new_deps": []}),
        ("Steal", {"worker": "w0"}), ("drain", "w0", 1, ())],
    "transfer_with_new_deps": [
        ("Create", {"task": "a"}), ("Steal", {"worker": "w0"}),
        ("Transfer", {"worker": "w0", "task": "a", "new_deps": ["pre"]}),
        ("Steal", {"worker": "w0"}),
        ("Complete", {"worker": "w0", "task": "pre"}),
        ("Steal", {"worker": "w0"}),
        ("Complete", {"worker": "w0", "task": "a"}),
        ("Steal", {"worker": "w0"})],
    "failure_poisons_transitive_successors": [
        ("Create", {"task": "a"}), ("Create", {"task": "b", "deps": ["a"]}),
        ("Create", {"task": "c", "deps": ["b"]}), ("Create", {"task": "x"}),
        ("Steal", {"worker": "w0"}),
        ("Complete", {"worker": "w0", "task": "a", "ok": False}),
        ("Create", {"task": "late", "deps": ["c"]}),   # poisoned at create
        ("drain", "w0", 1, ()), ("Stats", {}), ("prune",), ("Stats", {})],
    "failed_task_in_a_batch": [
        *[("Create", {"task": f"t{i}"}) for i in range(6)],
        ("Create", {"task": "join", "deps": [f"t{i}" for i in range(6)]}),
        ("drain", "w0", 2, ("t3",))],
    "transfer_cycle_stalls": [
        ("Create", {"task": "a"}), ("Create", {"task": "b", "deps": ["a"]}),
        ("Steal", {"worker": "w0"}),
        ("Transfer", {"worker": "w0", "task": "a", "new_deps": ["b"]}),
        ("Steal", {"worker": "w0"}), ("Stats", {})],
    "steal_n_batching": [
        *[("Create", {"task": f"t{i}"}) for i in range(10)],
        ("Steal", {"worker": "w0", "n": 4}),
        ("CompleteSteal", {"worker": "w0", "done": [["t0", True],
                                                    ["t1", True]], "n": 3}),
        ("CompleteSteal", {"worker": "w0", "done": [["t2", True]]}),
        ("drain", "w0", 3, ())],
    "lease_requeue_front_once": [
        ("clock", 0.0), ("Create", {"task": "a"}), ("Create", {"task": "b"}),
        ("Steal", {"worker": "slow"}), ("clock", 2.0),
        ("Steal", {"worker": "fast"}),
        ("Complete", {"worker": "slow", "task": "a"}), ("Stats", {}),
        ("Steal", {"worker": "fast"}),
        ("Complete", {"worker": "fast", "task": "b"}),
        ("Steal", {"worker": "fast"})],
    "lease_stale_entry_never_served": [
        ("clock", 0.0), ("Create", {"task": "a"}),
        ("Steal", {"worker": "slow"}), ("clock", 2.0), ("reap",),
        ("Complete", {"worker": "slow", "task": "a"}),
        ("Steal", {"worker": "fast"}), ("Stats", {})],
    "exit_recycles_to_front": [
        *[("Create", {"task": t}) for t in "abcd"],
        ("Steal", {"worker": "w0", "n": 2}), ("Exit", {"worker": "w0"}),
        ("Steal", {"worker": "w1", "n": 3}), ("drain", "w1", 1, ())],
    "cancel_hold_release_duplicate": [
        ("Create", {"task": "a"}), ("Create", {"task": "b", "deps": ["a"]}),
        ("Create", {"task": "a"}),                     # duplicate: NotFound
        ("Cancel", {"task": "b"}), ("Steal", {"worker": "w0"}),
        ("Cancel", {"task": "a"}),                     # leased: NotFound
        ("Create", {"task": "h", "hold": True}), ("Steal", {"worker": "w0"}),
        ("Release", {"task": "h"}), ("Release", {"task": "zz"}),
        ("Complete", {"worker": "w0", "task": "a"}), ("drain", "w0", 1, ())],
}
LEASED = {"lease_requeue_front_once", "lease_stale_entry_never_served"}


def run_script(side, name):
    api, server_cls = SIDES[side]
    clock = {"now": 0.0}
    srv = server_cls(lease_timeout=1.0 if name in LEASED else None,
                     clock=lambda: clock["now"])
    log = []
    for step in SCRIPTS[name]:
        if step[0] == "clock":
            clock["now"] = step[1]
        elif step[0] == "reap":
            srv._reap_leases()
        elif step[0] == "prune":
            log.append(("pruned", sorted(srv.prune_terminal())))
        elif step[0] == "drain":
            _, worker, n, failing = step
            while True:
                r = srv.handle(api.Steal(worker=worker, n=n))
                log.append(as_plain(r))
                if not isinstance(r, api.TaskMsg):
                    break
                for task, _ in r.tasks:
                    log.append(as_plain(srv.handle(api.Complete(
                        worker=worker, task=task, ok=task not in failing))))
        else:
            verb, fields = step
            log.append(as_plain(srv.handle(getattr(api, verb)(**fields))))
    return log, srv


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_scripted_sequences_give_equal_responses(name):
    jax_log, jax_srv = run_script("jax", name)
    port_log, port_srv = run_script("port", name)
    assert port_log == jax_log
    assert port_srv.stats() == jax_srv.stats()
    assert (port_srv.completed, port_srv.errors, list(port_srv.ready)) == \
        (jax_srv.completed, jax_srv.errors, list(jax_srv.ready))
    assert port_srv._all_done() == jax_srv._all_done()


def test_scripts_cover_the_documented_semantics():
    """The scripts show what tests/test_dwork.py holds, on the port."""
    log, srv = run_script("port", "failure_poisons_transitive_successors")
    before_prune, pruned, after_prune = log[-3:]
    assert (before_prune["errors"], before_prune["completed"]) == (4, 1)
    assert pruned == ("pruned", ["a", "b", "c", "late", "x"])
    assert after_prune["tasks"] == 0 and srv._all_done()
    log, srv = run_script("port", "transfer_cycle_stalls")
    assert log[-2] == ("NotFound", {}) and not srv._all_done()
    log, srv = run_script("port", "lease_requeue_front_once")
    assert srv.counters["requeued"] == 1 and srv.counters["completed"] == 2
    log, srv = run_script("port", "lease_stale_entry_never_served")
    assert log[-2] == ("ExitResp", {}) and srv.counters["stolen"] == 1


@pytest.mark.parametrize("client_kind", ["run_loop", "overlap"])
@pytest.mark.parametrize("steal_n", [1, 2, 3])
def test_client_loops_run_the_same_tasks(client_kind, steal_n):
    """Client.run_loop and OverlapClient on both sides: the same execution
    order, the same failures and the same final stats (the overlap case
    of tests/test_extensions.py with 20 tasks, plus a failing task and a
    join over all of them)."""
    results = {}
    for side, (client_mod, overlap_cls) in {
            "jax": (jax_client, JaxOverlapClient),
            "port": (port_client, PortOverlapClient)}.items():
        srv = SIDES[side][1]()
        producer = client_mod.Client(client_mod.InProcTransport(srv), "producer")
        for i in range(20):
            producer.create(f"t{i}", meta={"i": i})
        producer.create("join", deps=[f"t{i}" for i in range(20)])
        cls = client_mod.Client if client_kind == "run_loop" else overlap_cls
        cl = cls(client_mod.InProcTransport(srv), "w0")
        order = []

        def execute(name, meta):
            order.append((name, meta))
            if name == "t7":
                raise RuntimeError("a failing task")   # reported as ok=False
            return True

        done = cl.run_loop(execute, steal_n=steal_n)
        results[side] = (done, order, srv.stats(), sorted(srv.errors))
    assert results["port"] == results["jax"]
    done, order, stats, errors = results["port"]
    assert done == 20 and errors == ["join", "t7"]
    assert stats["completed"] == 19


def _sample(api, tag):
    """An instance of message `tag` with every field set off its default."""
    fields = {
        "Create": dict(task="a", deps=["x", "y"], meta={"n": 2}, hold=True),
        "Steal": dict(worker="w", n=3),
        "Complete": dict(worker="w", task="a", ok=False),
        "CompleteSteal": dict(worker="w", done=[["a", True], ["b", False]],
                              n=2),
        "Transfer": dict(worker="w", task="a", new_deps=["b"]),
        "Exit": dict(worker="w"),
        "TaskMsg": dict(tasks=[["a", {"n": 1}], ["b", {}]]),
        "NotFound": {}, "ExitResp": {}, "Stats": {},
        "Release": dict(task="a"), "Cancel": dict(task="a"),
        "Hello": dict(worker="w", pid=7, host="h", data_addr="tcp://h:1"),
        "HelloResp": dict(worker="w", steal_n=4, resident=True,
                          pass_worker=True, heartbeat_s=0.25, execute="x",
                          inline_bytes=9, spill_bytes=10),
        "Heartbeat": dict(worker="w"), "Fetch": dict(task="a"),
        "ValueMsg": dict(task="a", payload="p"),
        "LocMsg": dict(task="a", addr="tcp://h:2", worker="w", nbytes=5),
        "Spill": dict(worker="w", task="a", payload="p"),
    }[tag]
    return api._TAGS[tag](**fields)


def test_wire_tags_match():
    assert sorted(port_api._TAGS) == sorted(jax_api._TAGS)
    for tag, cls in jax_api._TAGS.items():
        assert port_api._TAGS[tag].__name__ == cls.__name__ == tag


@pytest.mark.parametrize("tag", sorted(jax_api._TAGS))
def test_wire_round_trip_both_ways(tag):
    jm, pm = _sample(jax_api, tag), _sample(port_api, tag)
    assert jax_api.encode(jm) == port_api.encode(pm)
    assert as_plain(port_api.decode(jax_api.encode(jm))) == as_plain(jm)
    assert as_plain(jax_api.decode(port_api.encode(pm))) == as_plain(pm)
    assert type(port_api.decode(jax_api.encode(jm))) is port_api._TAGS[tag]


def _load_without_msgpack(monkeypatch, path, name):
    """A fresh copy of an api module as it loads where msgpack is missing
    (the card's machine): its JSON branch."""
    monkeypatch.setitem(sys.modules, "msgpack", None)
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    monkeypatch.setitem(sys.modules, name, mod)    # dataclasses look it up
    spec.loader.exec_module(mod)
    return mod


def test_wire_json_branch_matches(monkeypatch):
    jj = _load_without_msgpack(monkeypatch, jax_api.__file__, "_jax_api_json")
    pj = _load_without_msgpack(monkeypatch, port_api.__file__,
                               "_port_api_json")
    for tag in jax_api._TAGS:
        jm, pm = _sample(jj, tag), _sample(pj, tag)
        assert pj.encode(pm) == jj.encode(jm)
        assert pj.encode(pm).startswith(b"[")          # JSON, not msgpack
        assert as_plain(pj.decode(jj.encode(jm))) == as_plain(jm)
        assert as_plain(jj.decode(pj.encode(pm))) == as_plain(pm)
    stats = {"tasks": 3, "errors": 0}
    assert pj.decode(jj.encode_stats(stats)) == stats
    assert port_api.decode(jax_api.encode_stats(stats)) == stats


def _populated(side):
    """A server mid-run: completed, failed, leased, dep-waiting and ready
    tasks, with metadata."""
    api, server_cls = SIDES[side]
    srv = server_cls()
    for name, deps in [("a", []), ("b", ["a"]), ("c", ["b"]), ("f", []),
                       ("g", ["f"]), ("r", []), ("s", [])]:
        srv.handle(api.Create(task=name, deps=deps, meta={"name": name}))
    for t in ("a", "f", "r"):
        srv.handle(api.Steal(worker="w0"))
    srv.handle(api.Complete(worker="w0", task="a"))
    srv.handle(api.Complete(worker="w0", task="f", ok=False))
    return srv                                          # "r" still leased


def _drain_log(api, srv):
    log = []
    while True:
        r = srv.handle(api.Steal(worker="w1"))
        log.append(as_plain(r))
        if not isinstance(r, api.TaskMsg):
            return log
        for t, _ in r.tasks:
            srv.handle(api.Complete(worker="w1", task=t))


@pytest.mark.parametrize("saver,loader", [("jax", "port"), ("port", "jax")])
def test_persistence_crosses_sides(saver, loader, tmp_path):
    path = tmp_path / "dhub.json"
    _populated(saver).save(str(path))
    same = SIDES[saver][1].load(str(path))
    other = SIDES[loader][1].load(str(path))
    assert other.stats() == same.stats()
    assert (other.joins, other.meta, other.completed, other.errors,
            list(other.ready)) == (same.joins, same.meta, same.completed,
                                   same.errors, list(same.ready))
    assert _drain_log(SIDES[loader][0], other) == \
        _drain_log(SIDES[saver][0], same)
    assert other.stats() == same.stats()
    # and the file the other side writes back is the same file
    other.save(str(tmp_path / "other.json"))
    same.save(str(tmp_path / "same.json"))
    assert (tmp_path / "other.json").read_text() == \
        (tmp_path / "same.json").read_text()


@contextlib.contextmanager
def _tcp_hub(client_mod, server):
    tcp = client_mod.TCPServer(("127.0.0.1", 0), server)
    th = tcp.serve_background()
    try:
        yield tcp.server_address
    finally:
        tcp.shutdown()
        tcp.server_close()
        th.join(timeout=10)
        assert not th.is_alive()


@pytest.mark.parametrize("hub,worker", [("port", "jax"), ("jax", "port")])
def test_tcp_client_drains_the_other_sides_hub(hub, worker):
    """A client of one side over its TCPTransport drains 200 tasks from the
    other side's TCPServer to Exit."""
    hub_mod = port_client if hub == "port" else jax_client
    cl_mod = jax_client if worker == "jax" else port_client
    srv = SIDES[hub][1]()
    with _tcp_hub(hub_mod, srv) as (host, port):
        cl = cl_mod.Client(cl_mod.TCPTransport(host, port), "w0")
        try:
            for i in range(200):
                cl.create(f"t{i}", meta={"i": i})
            seen = []
            done = cl.run_loop(lambda n, m: seen.append((n, m["i"])) or True,
                               steal_n=4)
            assert isinstance(cl.steal(), SIDES[worker][0].ExitResp)
            stats = cl.stats()
        finally:
            cl.t.close()
    assert done == 200 and seen == [(f"t{i}", i) for i in range(200)]
    assert stats["completed"] == stats["created"] == 200
    assert stats == srv.stats() and stats["errors"] == 0


DQUERY_SCRIPT = [["create", "a"], ["create", "b", "-d", "a"],
                 ["steal", "-n", "2"], ["complete", "a"], ["steal"],
                 ["transfer", "b", "-d", "c"], ["steal"],
                 ["complete", "c", "--fail"], ["steal"], ["exit-worker"],
                 ["stats"]]


def _run_dquery(main, host, port):
    out, codes = [], []
    for cmd in DQUERY_SCRIPT:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            codes.append(main(["--host", host, "--port", str(port), *cmd]))
        out.append(buf.getvalue())
    return out, codes


def test_dquery_cli_matches():
    """The port's dquery against a JAX hub prints what the JAX dquery prints
    against a port hub, command by command."""
    runs = []
    for hub_mod, srv_cls, main in (
            (jax_client, jax_dwork.TaskServer, port_dquery.main),
            (port_client, port_dwork.TaskServer, jax_dquery.main)):
        with _tcp_hub(hub_mod, srv_cls()) as (host, port):
            runs.append(_run_dquery(main, host, port))
    assert runs[0] == runs[1]
    out, codes = runs[0]
    assert out[2] == "a\n" and codes[8] == 4          # "EXIT" once all done
    assert json.loads(out[-1])["errors"] == 2         # c and its successor b


def test_exports():
    assert {"TaskServer", "Client", "InProcTransport", "TCPTransport",
            "Create", "Steal", "Complete", "CompleteSteal", "Transfer",
            "Exit", "TaskMsg", "NotFound", "ExitResp", "run_pool"} <= \
        set(port_dwork.__all__)
    assert "Forwarder" not in port_dwork.__all__
