"""Port parity for the comm subsystem and the proc transport: every test of
tests/test_comm.py, run through the JAX package and the port.

Each program takes a side (the names it needs from one package) and
returns what it observed: values, counts, exception type names and the
words an error names.  Every outcome compared here is deterministic (the
values, the exactly-once counts, the deaths a drill causes), so both sides
run and must observe the same, and each program asserts the reference's
expectations on its own side.  The port's side spawns the port's worker
module, `repro_torch.core.engine.comm.worker`, and the JAX side the
JAX package's (tests/test_torch_isolation.py holds the port's).

Every task callable is a lambda: cloudpickle ships lambdas by value, so a
worker never imports this module."""
import os
import signal
import subprocess
import sys
import threading
import time
from types import SimpleNamespace

import pytest

import repro.client as jax_client
import repro.core.dwork as jax_dwork
import repro.core.engine as jax_engine
import repro.core.engine.comm as jax_comm
import repro.core.engine.model as jax_model
import repro.core.obs as jax_obs
from repro.core.dwork.api import Create as JaxCreate
from repro.core.obs.top import render as jax_render
import repro_torch.client as port_client
import repro_torch.core.dwork as port_dwork
import repro_torch.core.engine as port_engine
import repro_torch.core.engine.comm as port_comm
import repro_torch.core.engine.model as port_model
import repro_torch.core.obs as port_obs
from repro_torch.core.dwork.api import Create as PortCreate
from repro_torch.core.obs.top import render as port_render

HB = 0.1          # fast heartbeat so liveness tests stay quick
SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")


# The JAX package's batch proc run declares a stall when a sharded hub's
# workers make no progress for max_idle_rounds polls (500 by default, about
# 0.5 s), as when they start slowly under load: its check reads "ready" and
# "assigned" where only each shard reports them (ROADMAP.md Queue 3).  Its
# side of a sharded batch run is given room to start; the port's runs with
# the default, which the port's engine reads per shard.
JAX_SHARDED_IDLE_ROUNDS = 60_000


def side(pkg, client, dwork, engine, comm, model, obs, create, render,
         sharded_idle_rounds=None):
    return SimpleNamespace(
        pkg=pkg, worker_module=f"{pkg}.core.engine.comm.worker",
        sharded_idle_rounds=sharded_idle_rounds,
        Client=client.Client, TaskFailed=client.TaskFailed, Create=create,
        run_pool=dwork.run_pool, TaskServer=dwork.TaskServer,
        Engine=engine.Engine, TraceRecorder=engine.TraceRecorder,
        Ref=comm.Ref, SerializationError=comm.SerializationError,
        connect=comm.connect, dumps_call=comm.dumps_call,
        listen=comm.listen, loads_call=comm.loads_call,
        transport_names=comm.transport_names, REQUEUED=model.REQUEUED,
        WORKER_DEAD=model.WORKER_DEAD, WorkerCrash=model.WorkerCrash,
        RUN_START=model.RUN_START, RUN_END=model.RUN_END,
        STOLEN=model.STOLEN, StatsServer=obs.StatsServer,
        instrument=obs.instrument, render=render)


SIDES = {"jax": side("repro", jax_client, jax_dwork, jax_engine, jax_comm,
                     jax_model, jax_obs, JaxCreate, jax_render,
                     JAX_SHARDED_IDLE_ROUNDS),
         "port": side("repro_torch", port_client, port_dwork, port_engine,
                      port_comm, port_model, port_obs, PortCreate,
                      port_render)}


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


def _wait_gone(pids, timeout=10.0) -> bool:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if not any(_pid_alive(p) for p in pids):
            return True
        time.sleep(0.05)
    return False


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [SRC] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    return env


# ------------------------------------------------------------- registry


def registry_names(ns):
    names = ns.transport_names()
    assert set(names) >= {"inproc", "thread", "tree", "proc"}
    with pytest.raises(ValueError, match="unknown transport"):
        ns.Engine(transport="carrier-pigeon")
    return sorted(names)


def test_transport_registry_names():
    assert both(registry_names) == ["inproc", "proc", "thread", "tree"]


def connect_listen_roundtrip(ns):
    class Echo:
        def handle(self, msg):
            return msg

    seen = []
    for addr in ("tcp://127.0.0.1:0", f"inproc://test-echo-{ns.pkg}"):
        lst = ns.listen(addr, Echo())
        try:
            comm = ns.connect(lst.address)
            out = comm.request(ns.Create(task="ping"))
            assert isinstance(out, ns.Create) and out.task == "ping"
            seen.append(out.task)
            comm.close()
        finally:
            lst.stop()
    with pytest.raises(ValueError, match="no scheme"):
        ns.connect("localhost:1234")
    return seen


def test_connect_listen_roundtrip_tcp_and_inproc():
    assert both(connect_listen_roundtrip) == ["ping", "ping"]


def serialize_call_roundtrip(ns):
    payload = ns.dumps_call((lambda x, y=1: x + y), (4,), {"y": 2},
                            task="t")
    fn, args, kwargs = ns.loads_call(payload)
    lock = threading.Lock()
    with pytest.raises(ns.SerializationError) as ei:
        ns.dumps_call((lambda: lock.acquire()), task="locked-up")
    assert "locked-up" in str(ei.value)
    assert ns.Ref("a").name == "a" and "a" in repr(ns.Ref("a"))
    return fn(*args, **kwargs), type(ei.value).__name__


def test_serialize_call_roundtrip_and_error_naming():
    assert both(serialize_call_roundtrip) == (6, "SerializationError")


# ---------------------------------------------------------- proc: basics


def batch_roundtrip(ns):
    eng = ns.Engine(transport="proc", workers=2, heartbeat_s=HB)
    for i in range(20):
        eng.submit(f"t{i}", (lambda i=i: i * i))
    rep = eng.run()
    assert not rep.stalled
    return sorted(r.value for r in rep.results.values()), rep.workers


def test_proc_batch_roundtrip_values():
    vals, workers = both(batch_roundtrip)
    assert vals == [i * i for i in range(20)]
    assert workers == 2       # real parallelism, unlike inline


def dependencies_and_poisoning(ns):
    eng = ns.Engine(transport="proc", workers=2, heartbeat_s=HB)
    eng.submit("ok", (lambda: 3))
    eng.submit("boom", (lambda: 1 / 0))
    eng.submit("doomed", (lambda: 99), deps=("boom",))
    rep = eng.run()
    r = rep.results["boom"]
    assert "doomed" in rep.errors or "boom" in rep.errors
    return (rep.results["ok"].value, r.ok, "ZeroDivisionError" in r.error,
            "doomed" in rep.results)


def test_proc_dependencies_and_failure_poisoning():
    # poisoned, never ran
    assert both(dependencies_and_poisoning) == (3, False, True, False)


def submit_time_serialization_error(ns):
    eng = ns.Engine(transport="proc", workers=1, heartbeat_s=HB)
    lock = threading.Lock()
    try:
        with pytest.raises(ns.SerializationError) as ei:
            eng.submit("unpicklable-task", (lambda: lock.acquire()))
        return "unpicklable-task" in str(ei.value)
    finally:
        eng.backend.close()


def test_proc_submit_time_serialization_error_names_task():
    assert both(submit_time_serialization_error) is True


def shards_compose(ns):
    eng = ns.Engine(transport="proc", workers=3, shards=2, heartbeat_s=HB,
                    max_idle_rounds=ns.sharded_idle_rounds)
    assert eng.shards == 2
    for i in range(30):
        eng.submit(f"t{i}", (lambda i=i: i))
    rep = eng.run()
    return sorted(r.value for r in rep.results.values())


def test_proc_shards_compose():
    assert both(shards_compose) == list(range(30))


def run_pool_shim(ns):
    srv = ns.TaskServer()
    for i in range(10):
        srv.handle(ns.Create(task=f"job{i}"))
    rep = ns.run_pool(srv, (lambda name, meta: (True, name)), workers=2,
                      transport="proc", heartbeat_s=HB)
    assert all(r.value == r.task for r in rep.results.values())
    return sorted(rep.results)


def test_proc_run_pool_shim():
    assert both(run_pool_shim) == sorted(f"job{i}" for i in range(10))


# ----------------------------------------------------- crash + liveness


def sigkill_mid_task(ns):
    eng = ns.Engine(transport="proc", workers=2, resident=True,
                    heartbeat_s=HB)
    eng.start()
    assert eng.wait_workers(2, timeout=20)
    for i in range(8):
        eng.submit(f"s{i}", (lambda i=i: (time.sleep(0.2), i)[1]))
    time.sleep(0.3)                       # mid-flight
    victim = next(iter(eng.worker_pids().values()))
    os.kill(victim, signal.SIGKILL)
    assert eng.drain(timeout=60)
    rep = eng.shutdown()
    dead = rep.trace.of(ns.WORKER_DEAD)
    assert len(dead) == 1 and dead[0].extra.get("reason") in ("crash",
                                                              "stale")
    return (rep.stalled, eng.worker_deaths,
            sorted(r.value for r in rep.results.values() if r.ok))


def test_proc_sigkill_mid_task_requeues_exactly_once():
    """A SIGKILLed worker process surfaces as a crash; its in-flight
    tasks requeue and the run finishes with zero loss and no duplicate
    terminal accounting."""
    assert both(sigkill_mid_task) == (False, 1, list(range(8)))


def worker_crash_exception(ns):
    eng = ns.Engine(transport="proc", workers=2, heartbeat_s=HB)
    eng.submit("die", (lambda E=ns.WorkerCrash: (_ for _ in ()).throw(
        E("x"))))
    rep = eng.run()
    return rep.stalled, eng.worker_deaths, "die" in rep.results


def test_proc_worker_crash_exception_kills_real_process():
    """WorkerCrash raised in a task body hard-exits the worker process;
    with every worker dead the batch run reports a stall, not a hang."""
    assert both(worker_crash_exception) == (True, 2, False)


def lease_expiry(ns):
    eng = ns.Engine(transport="proc", workers=2, heartbeat_s=HB,
                    lease_timeout=0.3)
    eng.submit("long", (lambda: (time.sleep(0.9), "v")[1]))
    for i in range(3):
        eng.submit(f"pad{i}", (lambda: None))
    rep = eng.run()
    rq = [e for e in rep.trace.of(ns.REQUEUED)
          if e.extra.get("via") == "lease"]
    assert rq and sum(e.extra.get("n", 0) for e in rq) >= 1
    # exactly-once: one terminal record despite the duplicate execution
    return (rep.results["long"].ok, rep.results["long"].value,
            len([n for n in rep.results if n == "long"]))


def test_proc_lease_expiry_requeues_via_wire():
    """With an explicit lease_timeout shorter than a task, an idle
    worker's steal reaps the expired lease: the task re-runs and the
    wire-observed requeue is traced via='lease' — but the engine still
    counts the task exactly once."""
    assert both(lease_expiry) == (True, "v", 1)


def futures_chain_across_kill(ns):
    # steal_n=1: the worker reports a's completion BEFORE stealing hold,
    # so a.result() returns while the worker is wedged inside hold and
    # b is still pending when the kill lands
    with ns.Client(workers=1, transport="proc", steal_n=1,
                   heartbeat_s=HB) as c:
        a = c.submit(lambda: (time.sleep(0.3), 7)[1])
        # wedge the single worker so b cannot run before the kill lands
        hold = c.submit(lambda: (time.sleep(2.0), "held")[1])
        b = c.submit((lambda x: x + 1), a)   # a pending -> Ref in payload
        got_a = a.result(timeout=30)         # worker is now inside `hold`
        eng = c.engine
        assert eng.wait_workers(1, timeout=20)
        victim = next(iter(eng.worker_pids().values()))
        os.kill(victim, signal.SIGKILL)
        eng.add_worker()
        # b lands on the fresh worker, whose empty cache forces a Fetch
        # of a's value from the front door
        got = (got_a, b.result(timeout=60), hold.result(timeout=60))
        assert eng.worker_deaths >= 1
        return got


def test_proc_futures_chain_across_kill():
    """A pending-future argument crosses as a Ref; after the producer's
    worker is killed, the dependent lands on a fresh worker and fetches
    the value from the front door."""
    assert both(futures_chain_across_kill) == (7, 8, "held")


def announced_exit(ns):
    eng = ns.Engine(transport="proc", workers=2, resident=True,
                    heartbeat_s=HB)
    eng.start()
    assert eng.wait_workers(2, timeout=20)
    eng.lose_worker("w0")
    for i in range(6):
        eng.submit(f"t{i}", (lambda i=i: i))
    assert eng.drain(timeout=30)
    rep = eng.shutdown()
    return (sorted(r.value for r in rep.results.values()),
            all(r.worker != "w0" for r in rep.results.values()
                if r.t_start > 0),
            any(e.extra.get("reason") == "lose"
                for e in rep.trace.of(ns.WORKER_DEAD)))


def test_proc_announced_exit_lose_worker():
    assert both(announced_exit) == (list(range(6)), True, True)


# -------------------------------------------------------------- client


def client_futures(ns):
    with ns.Client(workers=2, transport="proc", heartbeat_s=HB) as c:
        fs = c.map((lambda x: x + 1), range(12))
        vals = c.gather(fs)
        a = c.submit(lambda: 10)
        b = c.submit(lambda: 32)
        s = c.submit((lambda x, y: x + y), a, b)
        return vals, s.result(timeout=30)


def test_proc_client_futures_map_gather():
    assert both(client_futures) == (list(range(1, 13)), 42)


def client_failure(ns):
    with ns.Client(workers=2, transport="proc", heartbeat_s=HB) as c:
        f = c.submit(lambda: [].pop())
        with pytest.raises(ns.TaskFailed, match="IndexError"):
            f.result(timeout=30)
        lock = threading.Lock()
        with pytest.raises(ns.SerializationError) as ei:
            c.submit((lambda: lock.acquire()), key="cant-pickle")
        # the failed submit must not leak a permanently-pending future
        ok = c.submit(lambda: "fine")
        return "cant-pickle" in str(ei.value), ok.result(timeout=30)


def test_proc_client_failure_and_submit_time_error():
    assert both(client_failure) == (True, "fine")


# ----------------------------------------------------- pool lifecycle


def orphans_on_shutdown(ns):
    eng = ns.Engine(transport="proc", workers=2, resident=True,
                    heartbeat_s=HB)
    eng.start()
    assert eng.wait_workers(2, timeout=20)
    pids = list(eng.worker_pids().values())
    alive = all(_pid_alive(p) for p in pids)
    eng.submit("t", (lambda: 1))
    assert eng.drain(timeout=30)
    eng.shutdown()
    return len(pids), alive, _wait_gone(pids)


def test_proc_orphans_reaped_on_shutdown():
    assert both(orphans_on_shutdown) == (2, True, True)


def orphans_on_interpreter_exit(ns):
    code = (
        "import sys, time\n"
        f"from {ns.pkg}.core.engine import Engine\n"
        "eng = Engine(transport='proc', workers=2, resident=True,\n"
        "             heartbeat_s=0.1)\n"
        "eng.start()\n"
        "assert eng.wait_workers(2, timeout=20)\n"
        "print(' '.join(str(p) for p in eng.worker_pids().values()))\n"
        "sys.stdout.flush()\n"
        # exit with the pool still running: no shutdown(), no close()
    )
    out = subprocess.run([sys.executable, "-c", code], env=_env(),
                         capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stderr
    pids = [int(p) for p in out.stdout.split()]
    return len(pids), _wait_gone(pids)


def test_proc_orphans_reaped_on_interpreter_exit():
    """A session that never reaches shutdown() must not leave worker
    processes behind: the atexit net (and the workers' own
    connection-loss self-reaping) clean up on interpreter exit."""
    assert both(orphans_on_interpreter_exit) == (2, True)


# ----------------------------------------------------------- multi-host


def multi_host_join(ns):
    eng = ns.Engine(transport="proc", workers=0, resident=True,
                    heartbeat_s=HB)
    eng.start()
    deadline = time.monotonic() + 10
    while eng.comm_address is None and time.monotonic() < deadline:
        time.sleep(0.01)
    addr = eng.comm_address
    assert addr and addr.startswith("tcp://")
    for i in range(5):
        eng.submit(f"m{i}", (lambda i=i: i * 10))
    proc = subprocess.Popen(
        [sys.executable, "-m", ns.worker_module, "--connect", addr],
        env=_env(), stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    try:
        assert eng.drain(timeout=60)
        rep = eng.shutdown()
        proc.wait(timeout=15)
        # engine-assigned id for an anonymous join; a clean goodbye
        return (sorted(r.value for r in rep.results.values()),
                all(r.worker.startswith("r") for r in rep.results.values()),
                proc.returncode)
    finally:
        if proc.poll() is None:
            proc.kill()


def test_proc_multi_host_join_via_cli_worker():
    """An engine with zero local workers; a worker launched by hand (the
    multi-host path) dials the front door, joins on Hello, and drains
    the universe."""
    assert both(multi_host_join) == ([0, 10, 20, 30, 40], True, 0)


# ------------------------------------------------------------------ obs


def rss_gauge_and_pids(ns):
    eng = ns.Engine(transport="proc", workers=2, resident=True,
                    heartbeat_s=HB)
    eng.start()
    assert eng.wait_workers(2, timeout=20)
    for i in range(4):
        eng.submit(f"t{i}", (lambda i=i: i))
    assert eng.drain(timeout=30)
    reg = ns.instrument(engine=eng)
    srv = ns.StatsServer(reg, engine=eng).start()
    try:
        stats = srv.stats()
        rows = stats["workers"]
        assert all(row.get("pid") and row.get("rss_bytes", 0) > 1 << 20
                   for row in rows.values())
        rss = {k: v for k, v in stats["metrics"]["gauges"].items()
               if k.startswith("repro_worker_rss_bytes")}
        assert all(v > 1 << 20 for v in rss.values())
        view = ns.render(stats)
        return (len(rows), len(rss), "PID" in view and "RSS_MB" in view,
                sorted(stats))
    finally:
        srv.stop()
        eng.shutdown()


def test_proc_rss_gauge_and_stats_pids():
    rows, gauges, columns, _keys = both(rss_gauge_and_pids)
    assert (rows, gauges, columns) == (2, 2, True)


def tracer_spans(ns):
    tracer = ns.TraceRecorder()
    eng = ns.Engine(transport="proc", workers=2, tracer=tracer,
                    heartbeat_s=HB)
    for i in range(6):
        eng.submit(f"t{i}", (lambda: time.sleep(0.02)))
    rep = eng.run()
    starts = {e.task: e.t for e in rep.trace.of(ns.RUN_START)}
    ends = {e.task: e.t for e in rep.trace.of(ns.RUN_END)}
    stolen = {e.task: e.t for e in rep.trace.of(ns.STOLEN)}
    for t in starts:
        assert stolen[t] <= starts[t] <= ends[t]
        assert ends[t] - starts[t] >= 0.015       # worker-measured dur
    return sorted(starts), rep.overhead().n_tasks


def test_proc_tracer_spans_reconstructed():
    """Worker-side durations reconstruct RUN_START/RUN_END spans that
    the overhead report can pair (no negative dispatch)."""
    assert both(tracer_spans) == ([f"t{i}" for i in range(6)], 6)



def busy_sharded_run(ns):
    """A sharded batch run whose workers take longer to start and to run a
    task than max_idle_rounds polls: busy, not deadlocked."""
    eng = ns.Engine(transport="proc", workers=2, shards=2, heartbeat_s=HB,
                    max_idle_rounds=5)
    for i in range(6):
        eng.submit(f"b{i}", (lambda i=i: (time.sleep(0.1), i)[1]))
    rep = eng.run()
    return rep.stalled, sorted(r.value for r in rep.results.values())


def test_a_busy_sharded_proc_run_is_not_a_stall():
    """The fault in the JAX package's `Engine._run_proc` (ROADMAP.md Queue
    3) behind the intermittent `test_proc_shards_compose`, repaired in the
    port: its stall check reads a sharded hub's ready and assigned counts
    from each shard."""
    assert busy_sharded_run(SIDES["port"]) == (False, list(range(6)))
    stalled, _ = busy_sharded_run(SIDES["jax"])
    assert stalled is True
